"""The fused single-device step: packed colors -> shared-k-mer matrix ->
max-containment -> threshold adjacency -> connected-components labels, all
on one device.

Counterpart of ``kspider_tpu/parallel/step.py`` (``single_device_step``,
``_combine_and_cluster`` and ``make_example_blocks``; ``sharded_step``
waits for the multi-GPU port).  The step keeps JAX's non-transposed input
layout, ``bits u8[NB, block, n_pad/8]`` and ``w_limbs i8[NB, block, L]``.
On the device the inputs are transposed to the Gram kernel's colors-last
layout and padded with zero colors to a multiple of its chunk; the kernel
computes the upper tiles, which are mirrored.  On the CPU the same calls
take the kernel's plain version.

Integer exactness: the limbs are combined in int32 on the device, as JAX
does (exact while every shared count is below 2**31).
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kspider_tpu_torch.device import resolve_device
from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cc as cc_ops
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as pw


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
    device = resolve_device(device)
    bits = torch.as_tensor(bits, device=device)
    w_limbs = torch.as_tensor(w_limbs, device=device)
    counts = torch.as_tensor(kmer_counts, device=device)
    nb = bits.shape[0]
    if tuple(bits.shape) != (nb, block, n_pad // 8) or n_pad % cp.TILE:
        raise ValueError(f"bits {tuple(bits.shape)} != ({nb}, {block}, "
                         f"{n_pad // 8}) with n_pad a multiple of {cp.TILE}")
    if tuple(w_limbs.shape) != (nb, block, n_limbs):
        raise ValueError(f"w_limbs {tuple(w_limbs.shape)} != ({nb}, {block}, "
                         f"{n_limbs})")
    if nb * block > pw._MAX_COLORS_PER_CALL:
        raise ValueError(f"{nb * block} colors: the int32 limb accumulators "
                         f"are exact only up to {pw._MAX_COLORS_PER_CALL}")
    pad = -block % cp.CHUNK
    bits_t = F.pad(bits.transpose(1, 2), (0, pad)).contiguous()
    wl_t = F.pad(w_limbs.transpose(1, 2), (0, pad)).contiguous()
    del bits, w_limbs
    acc = torch.zeros((n_limbs, n_pad, n_pad), dtype=torch.int32, device=device)
    cp.cooccurrence_tiles(bits_t, bits_t, wl_t,
                          *cp.upper_triangle_tiles(n_pad // cp.TILE),
                          tile=cp.TILE, out=acc)
    del bits_t, wl_t
    acc = cp.mirror_upper_tiles(acc, cp.TILE)
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
