"""Exact shared-k-mer matrix S = A^T diag(w) A.

Counterpart of ``kspider_tpu/ops/pairwise.py``.  ``A`` is the
(colors x samples) 0/1 membership matrix and ``w_c`` the number of k-mers of
color ``c``.  The product runs as int8 tensor-core products with int32
accumulation: weights are split into base-128 limbs so every scaled entry
fits int8, and limb sums are recombined in int64.

Exactness: one limb term adds at most 127 per color, so fewer than
``2**31 / 127`` colors per accumulation keep int32 exact; callers split
larger inputs into super-blocks.

Three engines: the dense engine on the hand-written Gram kernel
(``ops/cuda_pairwise.py``; JAX's "bitmask" and "pallas" engines), the
sharded engine, which splits the color blocks of the dense engine over a
device list (``parallel/sharded_pairwise.py``), and the scatter engine
(postings scattered into a dense int8 block, then one product per limb).
JAX leaves the scatter engine's product to XLA outside any Pallas kernel,
so here it is a library GEMM: ``torch._int_mm`` (int8 -> int32) on the
card, float64 (exact) on the CPU.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from kspider_tpu_torch.device import resolve_device
from kspider_tpu_torch.parallel.mesh import make_mesh

# int32 accumulator safety bound: 127 * MAX_COLORS_PER_CALL < 2**31
_MAX_COLORS_PER_CALL = (2**31 - 1) // 127


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


#: engines of :func:`shared_kmer_matrix`; bitmask and pallas are both the
#: dense engine on the Gram kernel
ENGINES = ("auto", "bitmask", "pallas", "scatter", "sharded")
#: the engines that run on exactly one device
ONE_DEVICE_ENGINES = ("bitmask", "pallas", "scatter")
#: default color block per engine (kspider_tpu's: 1024 for its bitmask and
#: Pallas engines, the pairwise stage's 512 for the scatter engine)
DENSE_BLOCK = 1024
SCATTER_BLOCK = 512


def weight_limbs(weights: np.ndarray) -> np.ndarray:
    """Decompose int64 weights into base-128 int8 limbs, shape (C, L)."""
    w = np.asarray(weights, dtype=np.int64)
    if w.size == 0:
        return np.zeros((0, 1), dtype=np.int8)
    max_w = int(w.max(initial=0))
    n_limbs = 1
    while max_w >= 128**n_limbs:
        n_limbs += 1
    limbs = np.empty((len(w), n_limbs), dtype=np.int8)
    rem = w.copy()
    for l in range(n_limbs):
        limbs[:, l] = (rem % 128).astype(np.int8)
        rem //= 128
    return limbs


def _cooccurrence_blocks(rows, cols, w_limbs, block: int, n_pad: int,
                         n_limbs: int, *, device) -> torch.Tensor:
    """Per-limb int32 accumulators ``[n_limbs, n_pad, n_pad]`` on ``device``.

    ``rows i32[NB, P]`` in ``[0, block]`` (``block`` is the padding sink),
    ``cols i32[NB, P]`` in ``[0, n_pad)``, ``w_limbs i8[NB, block, L]``
    (:func:`_pack_blocks`); ``device`` is a ``torch.device``.  Per block the
    postings are scattered into a dense ``int8[block + 1, n_pad]``, row
    ``block`` is cut off, and each limb adds ``(w_l * A)^T A``."""
    cuda = device.type == "cuda"
    acc = torch.zeros((n_limbs, n_pad, n_pad), dtype=torch.int32, device=device)
    rows = torch.as_tensor(rows, device=device).long()
    cols = torch.as_tensor(cols, device=device).long()
    w_limbs = torch.as_tensor(w_limbs, device=device)
    one = torch.ones((), dtype=torch.int8, device=device)
    for b in range(rows.shape[0]):
        a = torch.zeros((block + 1, n_pad), dtype=torch.int8, device=device)
        a.index_put_((rows[b], cols[b]), one)
        a = a[:block]
        for l in range(n_limbs):
            wa_t = (a * w_limbs[b, :, l, None]).T  # int8: at most 127
            if cuda:
                acc[l] += torch._int_mm(wa_t.contiguous(), a)
            else:
                acc[l] += (wa_t.double() @ a.double()).to(torch.int32)
    return acc


def _pack_blocks(
    offsets: np.ndarray,
    members: np.ndarray,
    w_limbs: np.ndarray,
    block: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack CSR colors into fixed-shape per-block posting arrays
    ``(rows i32[NB, P], cols i32[NB, P], w_limbs i8[NB, block, L])``;
    padding postings sit in row ``block``, column 0."""
    num_colors = len(offsets) - 1
    num_blocks = max(1, _cdiv(num_colors, block))
    degrees = np.diff(offsets)
    color_idx = np.repeat(np.arange(num_colors, dtype=np.int64), degrees)
    block_of_posting = color_idx // block
    row_of_posting = (color_idx % block).astype(np.int32)

    per_block = np.bincount(block_of_posting, minlength=num_blocks)
    p_max = int(per_block.max(initial=1))
    # position of each posting within its block
    block_starts = np.zeros(num_blocks + 1, dtype=np.int64)
    np.cumsum(per_block, out=block_starts[1:])
    pos_in_block = np.arange(len(members)) - block_starts[block_of_posting]

    rows = np.full((num_blocks, p_max), block, dtype=np.int32)  # sentinel
    cols = np.zeros((num_blocks, p_max), dtype=np.int32)
    rows[block_of_posting, pos_in_block] = row_of_posting
    cols[block_of_posting, pos_in_block] = members

    n_limbs = w_limbs.shape[1]
    wl = np.zeros((num_blocks * block, n_limbs), dtype=np.int8)
    wl[:num_colors] = w_limbs
    wl = wl.reshape(num_blocks, block, n_limbs)
    return rows, cols, wl


def _drop_singletons(offsets, members, weights, drop_singletons: bool):
    """The CSR of the kept colors (degree >= 2 when dropping singletons)."""
    degrees = np.diff(offsets)
    keep = (
        np.flatnonzero(degrees >= 2) if drop_singletons else np.arange(len(degrees))
    )
    kept_deg = degrees[keep]
    new_offsets = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_offsets[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_offsets[:-1], kept_deg)
    )
    return new_offsets, members[gather], weights[keep]


def shared_kmer_matrix_scatter(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    device,
    block: int = SCATTER_BLOCK,
    drop_singletons: bool = True,
) -> np.ndarray:
    """The scatter engine: exact shared-k-mer matrix (int64, NxN) through
    :func:`_cooccurrence_blocks` on ``device``, super-block by super-block
    so that int32 stays exact."""
    device = resolve_device(device)
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    new_offsets, new_members, new_weights = _drop_singletons(
        offsets, members, weights, drop_singletons)
    if len(new_weights) == 0 or n == 0:
        return np.zeros((n, n), dtype=np.int64)
    if device.type == "cuda" and block % 8:
        raise ValueError(f"block {block}: torch._int_mm needs a multiple of 8")

    n_pad = max(128, _round_up(n, 128))
    w_limbs = weight_limbs(new_weights)
    n_limbs = w_limbs.shape[1]
    total = torch.zeros((n_pad, n_pad), dtype=torch.int64, device=device)
    num_colors = len(new_weights)
    super_size = _MAX_COLORS_PER_CALL - (_MAX_COLORS_PER_CALL % block)
    for start in range(0, num_colors, super_size):
        stop = min(start + super_size, num_colors)
        sl_off = new_offsets[start : stop + 1] - new_offsets[start]
        sl_mem = new_members[new_offsets[start] : new_offsets[stop]]
        rows, cols, wl = _pack_blocks(sl_off, sl_mem, w_limbs[start:stop], block)
        acc = _cooccurrence_blocks(rows, cols, wl, block, n_pad, n_limbs,
                                   device=device)
        for l in range(n_limbs):
            total.add_(acc[l], alpha=128**l)
        del acc
    s = total[:n, :n]
    s.fill_diagonal_(0)
    return s.cpu().numpy()


def check_engine_devices(engine: str, n_devices: int) -> None:
    """Raise when ``engine`` cannot run on ``n_devices`` devices: an engine
    of ``ONE_DEVICE_ENGINES`` never quietly takes the first of several."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if n_devices > 1 and engine in ONE_DEVICE_ENGINES:
        raise ValueError(
            f"engine {engine!r} runs on one device, got {n_devices}; use "
            "engine 'auto' or 'sharded' for a device list"
        )


def shared_kmer_matrix(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    device,
    block: Optional[int] = None,
    drop_singletons: bool = True,
    engine: str = "auto",
    device_pack: Optional[str] = None,
) -> np.ndarray:
    """Exact shared-k-mer matrix S (int64, NxN, symmetric, zero diagonal).

    Input is the color-class CSR of :class:`kspider_tpu_torch.core.index.ColorIndex`:
    ``members[offsets[c]:offsets[c+1]]`` lists the 0-based sample ids of
    color ``c`` and ``weights[c]`` its k-mer count.  ``device`` is one
    device or a device list (``parallel/mesh.make_mesh``).  ``engine`` (one
    of ``ENGINES``): "auto" runs the sharded engine on a list of more than
    one device, as kspider_tpu does on more than one chip, and otherwise
    the dense engine; "bitmask" and "pallas" run the dense engine on
    ``device`` (the hand-written kernel on a CUDA device, its plain torch
    version on the CPU) with ``DENSE_BLOCK``-color blocks; "sharded" splits
    those blocks over the devices; "scatter" runs the scatter engine with
    ``SCATTER_BLOCK``.  ``block`` overrides the engine's default.  The
    sharded engine always drops singletons, as kspider_tpu's does.
    ``device_pack`` (auto/force/off; None reads ``KSPIDER_DEVICE_PACK``)
    reaches the dense engine under "pallas" and "auto", the names that run
    kspider_tpu's Pallas engine; "bitmask" packs on the host ("off"), as
    kspider_tpu's bitmask engine does, and the sharded and scatter engines
    take no policy."""
    devices = make_mesh(device)
    check_engine_devices(engine, len(devices))
    if engine == "sharded" or (engine == "auto" and len(devices) > 1):
        from kspider_tpu_torch.parallel.sharded_pairwise import (
            shared_kmer_matrix_sharded,
        )

        return shared_kmer_matrix_sharded(
            offsets, members, weights, n, devices=devices,
            block=block or DENSE_BLOCK,
        )
    if engine == "scatter":
        return shared_kmer_matrix_scatter(
            offsets, members, weights, n, device=devices[0],
            block=block or SCATTER_BLOCK, drop_singletons=drop_singletons,
        )
    from kspider_tpu_torch.ops.cuda_pairwise import shared_kmer_matrix_cuda

    return shared_kmer_matrix_cuda(
        offsets, members, weights, n, device=devices[0],
        block=block or DENSE_BLOCK, drop_singletons=drop_singletons,
        device_pack="off" if engine == "bitmask" else device_pack,
    )


def shared_kmer_matrix_numpy(
    offsets: np.ndarray, members: np.ndarray, weights: np.ndarray, n: int
) -> np.ndarray:
    """Pure-numpy reference implementation (exact, for tests and ``--cpu``)."""
    s = np.zeros((n, n), dtype=np.int64)
    offsets = np.asarray(offsets)
    for c in range(len(offsets) - 1):
        ms = members[offsets[c] : offsets[c + 1]]
        if len(ms) < 2:
            continue
        w = int(weights[c])
        s[np.ix_(ms, ms)] += w
    np.fill_diagonal(s, 0)
    return s
