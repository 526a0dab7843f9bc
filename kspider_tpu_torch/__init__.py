"""kSpider's dense pairwise -> cluster path in PyTorch, with a CUDA kernel
written by hand for Hopper (sm_90a).

The JAX package ``kspider_tpu`` stays the reference.  This package shares
its jax-free host layers (index, artifacts, sigs, native ctypes bridge,
export) and re-homes the numpy helpers that live in jax-importing modules.
It never imports jax.  Every public function that allocates takes an
explicit ``device``; nothing picks a device on its own.
"""

__version__ = "0.1.0"
