"""Multi-device pairwise: color blocks split over a device list, the partial
Gram matrices summed on the first device.

Counterpart of ``kspider_tpu/parallel/sharded_pairwise.py``.  JAX shards
the color blocks over its mesh with ``shard_map`` and merges the per-device
partials with one ``psum``.  Here each device of the list takes a
contiguous, equal slice of the blocks, in list order, and runs the
hand-written Gram kernel over the upper tiles of its slice (on the CPU the
kernel's plain version); every launch is issued before any partial is
copied, so distinct cards overlap, and then the int32 partials are summed
on ``devices[0]`` and mirrored.

Exactness, and a repair: JAX's ``shared_kmer_matrix_sharded`` sums all
non-singleton colors in one call, so its int32 psum wraps once the colors
of all devices together pass ``2**31 / 127`` (about 16.9 M).  The port cuts
the colors into super-blocks under that bound, as the dense engine does,
and adds each super-block's limbs into an int64 total.  Its output equals
JAX's wherever JAX's is exact, and is exact everywhere else.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as pw
from kspider_tpu_torch.parallel.mesh import make_mesh


def _check_blocks(bits, w_limbs, block: int, n_pad: int, n_limbs: int) -> None:
    """Raise unless ``bits u8[NB, block, n_pad/8]`` and ``w_limbs i8[NB,
    block, L]`` fit together and hold few enough colors for int32."""
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


def _device_body(bits: torch.Tensor, w_limbs: torch.Tensor, block: int,
                 n_pad: int, n_limbs: int) -> torch.Tensor:
    """One device's accumulators i32[L, n_pad, n_pad], upper tiles filled
    and lower tiles zero, for its blocks ``bits u8[nb, block, n_pad/8]`` and
    ``w_limbs i8[nb, block, L]`` (tensors on that device).

    The blocks are transposed to the kernel's colors-last layout and padded
    with zero colors to a multiple of its chunk."""
    pad = -block % cp.CHUNK
    bits_t = F.pad(bits.transpose(1, 2), (0, pad)).contiguous()
    wl_t = F.pad(w_limbs.transpose(1, 2), (0, pad)).contiguous()
    del bits, w_limbs
    acc = torch.zeros((n_limbs, n_pad, n_pad), dtype=torch.int32,
                      device=bits_t.device)
    return cp.cooccurrence_tiles(bits_t, bits_t, wl_t,
                                 *cp.upper_triangle_tiles(n_pad // cp.TILE),
                                 tile=cp.TILE, out=acc)


def sharded_cooccurrence(bits, w_limbs, block: int, n_pad: int, n_limbs: int,
                         devices) -> torch.Tensor:
    """``bits u8[NB, block, n_pad/8]`` and ``w_limbs i8[NB, block, L]``
    (numpy arrays or tensors), NB a multiple of ``len(devices)``; returns
    the summed i32[L, n_pad, n_pad] on ``devices[0]``, every tile filled:
    the value of JAX's psum."""
    devices = make_mesh(devices)
    _check_blocks(bits, w_limbs, block, n_pad, n_limbs)
    nb, n_dev = bits.shape[0], len(devices)
    if nb % n_dev:
        raise ValueError(f"{nb} color blocks do not split evenly over "
                         f"{n_dev} devices")
    per = nb // n_dev
    bits = torch.as_tensor(bits)
    w_limbs = torch.as_tensor(w_limbs)
    accs = [
        _device_body(bits[k * per:(k + 1) * per].to(dev),
                     w_limbs[k * per:(k + 1) * per].to(dev),
                     block, n_pad, n_limbs)
        for k, dev in enumerate(devices)
    ]
    acc = accs[0]
    for other in accs[1:]:
        acc += other.to(devices[0])
    return cp.mirror_upper_tiles(acc, cp.TILE)


def _compact_multi_colors(offsets, members, weights
                          ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The CSR of the colors with two or more members, or None if none."""
    degrees = np.diff(offsets)
    keep = np.flatnonzero(degrees >= 2)
    if len(keep) == 0:
        return None
    kept_deg = degrees[keep]
    new_offsets = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_offsets[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_offsets[:-1], kept_deg)
    )
    return new_offsets, members[gather], weights[keep]


def shared_kmer_matrix_sharded(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    devices,
    block: int = 1024,
) -> np.ndarray:
    """Multi-device version of :func:`kspider_tpu_torch.ops.pairwise.shared_kmer_matrix`:
    the exact int64 NxN matrix with a zero diagonal.

    Colors are compacted to the non-singleton ones and cut into
    super-blocks whose block count is a multiple of the device count and
    whose colors keep the summed int32 limbs exact; each super-block's
    limbs are recombined into an int64 total on ``devices[0]``."""
    devices = make_mesh(devices)
    n_dev = len(devices)
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    compacted = _compact_multi_colors(offsets, members, weights)
    if compacted is None or n == 0:
        return np.zeros((n, n), dtype=np.int64)
    new_offsets, new_members, new_weights = compacted

    n_pad = max(cp.TILE, pw._round_up(n, cp.TILE))
    w_limbs = pw.weight_limbs(new_weights)
    n_limbs = w_limbs.shape[1]
    blocks_per_call = pw._MAX_COLORS_PER_CALL // block // n_dev * n_dev
    if blocks_per_call == 0:
        raise ValueError(f"{n_dev} blocks of {block} colors exceed the "
                         f"{pw._MAX_COLORS_PER_CALL} colors an int32 "
                         "accumulator holds exactly")
    super_size = blocks_per_call * block
    num_colors = len(new_weights)
    total = torch.zeros((n_pad, n_pad), dtype=torch.int64, device=devices[0])
    for start in range(0, num_colors, super_size):
        stop = min(start + super_size, num_colors)
        sl_off = new_offsets[start : stop + 1] - new_offsets[start]
        sl_mem = new_members[new_offsets[start] : new_offsets[stop]]
        bits = bm.pack_bitmask_blocks(sl_off, sl_mem, n, block)
        nb = bits.shape[0]
        nb_pad = pw._round_up(nb, n_dev)  # empty blocks fill the last devices
        padded_bits = np.zeros((nb_pad,) + bits.shape[1:], dtype=np.uint8)
        padded_bits[:nb] = bits
        wl = np.zeros((nb_pad * block, n_limbs), dtype=np.int8)
        wl[: stop - start] = w_limbs[start:stop]
        del bits
        acc = sharded_cooccurrence(padded_bits, wl.reshape(nb_pad, block, n_limbs),
                                   block, n_pad, n_limbs, devices)
        for l in range(n_limbs):
            total.add_(acc[l], alpha=128**l)
        del acc
    s = total[:n, :n]
    s.fill_diagonal_(0)
    return s.cpu().numpy()
