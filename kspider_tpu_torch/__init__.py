"""kSpider's dense pairwise -> cluster path in PyTorch, with a CUDA kernel
written by hand for Hopper (sm_90a).

The JAX package ``kspider_tpu`` stays the reference.  This package keeps its
own copies of the host layers (index, artifacts, sigs, the ctypes bridge to
the repository's ``native/`` library, sketch, export) and of the numpy
helpers, and imports neither jax nor ``kspider_tpu``.  Every public function that allocates takes an
explicit ``device``; nothing picks a device on its own.
"""

__version__ = "0.1.0"
