"""The fused step: packed colors -> shared-k-mer matrix -> max-containment
-> threshold adjacency -> connected-components labels, on one device or on
a device list.

Counterpart of ``kspider_tpu/parallel/step.py`` (``single_device_step``,
``sharded_step``, ``_combine_and_cluster`` and ``make_example_blocks``).
The step keeps JAX's non-transposed input layout, ``bits u8[NB, block,
n_pad/8]`` and ``w_limbs i8[NB, block, L]``.  The Gram product is
``parallel/sharded_pairwise.sharded_cooccurrence``: each device transposes
its slice of the blocks to the Gram kernel's colors-last layout, pads it
with zero colors to a multiple of the kernel's chunk and runs the upper
tiles; the partials are summed on the first device and mirrored, and the
rest of the step runs there.  On the CPU the same calls take the kernel's
plain version.

Integer exactness: the limbs are combined in int32 on the device, as JAX
does (exact while every shared count is below 2**31).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from kspider_tpu_torch.device import resolve_device
from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cc as cc_ops
from kspider_tpu_torch.ops import pairwise as pw
from kspider_tpu_torch.parallel.mesh import make_mesh
from kspider_tpu_torch.parallel.sharded_pairwise import sharded_cooccurrence


def _combine_and_cluster(acc, kmer_counts, cutoff, n_limbs,
                         stats: Optional[dict] = None):
    """acc i32[L, n_pad, n_pad] (every tile filled) -> (shared i32 [n, n],
    labels i32 [n])."""
    n = kmer_counts.shape[0]
    scale = torch.tensor([128**l for l in range(n_limbs)], dtype=torch.int32,
                         device=acc.device).reshape(n_limbs, 1, 1)
    shared = (acc[:, :n, :n] * scale).sum(0, dtype=torch.int32)
    shared.fill_diagonal_(0)
    counts = kmer_counts.to(torch.float32)
    # max containment = shared / min(k_i, k_j), the reference's default
    # clustering distance; compared in float32, as in JAX
    denom = torch.minimum(counts[:, None], counts[None, :])
    cont = shared.to(torch.float32) / torch.clamp(denom, min=1.0)
    cut = torch.tensor(cutoff, dtype=torch.float32, device=acc.device)
    adj = (cont >= cut) & (shared > 0)
    del cont, denom
    labels = cc_ops.connected_components_dense(adj, stats)
    return shared, labels


def single_device_step(bits, w_limbs, kmer_counts, cutoff, block: int,
                       n_pad: int, n_limbs: int, *, device,
                       stats: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused step on ``device``: returns ``(shared i32 [n, n], labels
    i32 [n])`` as tensors on ``device``, with ``n = len(kmer_counts)``.

    ``bits u8[NB, block, n_pad/8]``, ``w_limbs i8[NB, block, L]`` and
    ``kmer_counts`` (numpy arrays or tensors) as in kspider_tpu.  ``stats``,
    if given, receives the CC ``rounds``."""
    return sharded_step([resolve_device(device)], bits, w_limbs, kmer_counts,
                        cutoff, block, n_pad, n_limbs, stats=stats)


def sharded_step(devices, bits, w_limbs, kmer_counts, cutoff, block: int,
                 n_pad: int, n_limbs: int, *, stats: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused step over ``devices`` (a list or comma-separated names,
    see ``parallel/mesh.make_mesh``): the color blocks split over the
    devices, NB a multiple of their count, the partial Gram matrices summed
    on ``devices[0]``, where the limbs are combined and clustered.  Returns
    ``(shared i32 [n, n], labels i32 [n])`` on ``devices[0]``."""
    devices = make_mesh(devices)
    acc = sharded_cooccurrence(bits, w_limbs, block, n_pad, n_limbs, devices)
    counts = torch.as_tensor(kmer_counts, device=devices[0])
    return _combine_and_cluster(acc, counts, cutoff, n_limbs, stats)


def make_example_blocks(
    n_samples: int = 256,
    n_colors: int = 2048,
    block: int = 256,
    seed: int = 0,
    max_weight: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Deterministic synthetic packed inputs, equal to kspider_tpu's.

    Returns (bits, w_limbs, kmer_counts, block, n_pad, n_limbs)."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(2, 6, size=n_colors)
    offsets = np.zeros(n_colors + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    members = rng.integers(0, n_samples, size=int(offsets[-1])).astype(np.int64)
    weights = rng.integers(1, max_weight, size=n_colors).astype(np.int64)
    w_limbs = pw.weight_limbs(weights)
    n_limbs = w_limbs.shape[1]
    bits = bm.pack_bitmask_blocks(offsets, members, n_samples, block)
    nb = bits.shape[0]
    n_pad = bits.shape[2] * 8
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[:n_colors] = w_limbs
    wl = wl.reshape(nb, block, n_limbs)
    kmer_counts = rng.integers(5_000, 50_000, size=n_samples).astype(np.int32)
    return bits, wl, kmer_counts, block, n_pad, n_limbs
