"""Dense pairwise engine on the hand-written Hopper Gram kernel.

Counterpart of ``kspider_tpu/ops/pallas_pairwise.py``.  The four Pallas
kernels there (full square, rectangle, upper-triangle tile list, symmetric
strips) compute the same per-tile sum

    acc_l[i, j] = sum_c bit[c, i] * w_l[c] * bit[c, j]

and become one CUDA kernel (``csrc/gram_int8.cu``) driven by a list of
output tile pairs: "all tiles" of a rectangle covers the square and
rectangle kernels, "upper tiles" of one panel covers the triangle kernel
and, after ``mirror_upper_tiles``, the symmetric one.

Inputs keep the JAX package's transposed layout, colors contiguous:
``bits_t u8[NB, n_pad/8, block]`` (MSB-first) and ``wl_t i8[NB, L, block]``.
The TPU's VMEM budgets (``best_strip``, ``sym_fits``, ``auto_tile``) have
no counterpart: the engine always computes upper tiles and mirrors them.
"""

import functools

import numpy as np
import torch

from kspider_tpu_torch.device import resolve_device
from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import pairwise as pw

#: output tile edge of the CUDA kernel (``kTile`` in csrc/gram_int8.cu)
TILE = 128
#: colors per color block; the kernel needs a multiple of its 128-color chunk
BLOCK = 1024
#: color blocks packed and shipped to the device per kernel launch
CHUNK_BLOCKS = 64

#: number of CUDA kernel launches made by :func:`cooccurrence_tiles`
LAUNCHES = 0
#: the same launches by tile list: "upper" (upper tiles of one side, the
#: TPU's tri/sym kernels), "all" (every tile of a grid, square or rect) or
#: "list" (any other list)
LAUNCHES_BY_MODE = {"upper": 0, "all": 0, "list": 0}


def pack_inputs(
    offsets: np.ndarray,
    members: np.ndarray,
    w_limbs: np.ndarray,
    n_pad: int,
    block: int,
):
    """CSR colors -> host arrays ``(bits_t u8[NB, n_pad/8, block],
    wl_t i8[NB, L, block])``; pad colors carry zero bits and zero weights."""
    nb = max(1, -(-(len(offsets) - 1) // block))
    n_limbs = w_limbs.shape[1]
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[: len(w_limbs)] = w_limbs
    wl_t = np.ascontiguousarray(
        wl.reshape(nb, block, n_limbs).transpose(0, 2, 1)
    )
    bits = bm.pack_bitmask_blocks(offsets, members, n_pad, block)
    bits_t = np.ascontiguousarray(bits.transpose(0, 2, 1))
    return bits_t, wl_t


def _read_only(*arrays):
    for a in arrays:
        a.flags.writeable = False
    return arrays


@functools.lru_cache(maxsize=None)
def upper_triangle_tiles(nt: int):
    """(tile_i, tile_j) int32 arrays enumerating the i <= j tile pairs,
    row-major.  Cached and read-only."""
    ti, tj = np.triu_indices(nt)
    return _read_only(ti.astype(np.int32), tj.astype(np.int32))


@functools.lru_cache(maxsize=None)
def all_tiles(nti: int, ntj: int):
    """(tile_i, tile_j) int32 arrays enumerating every tile of an
    nti x ntj grid, row-major.  Cached and read-only."""
    ti, tj = np.meshgrid(np.arange(nti), np.arange(ntj), indexing="ij")
    return _read_only(ti.ravel().astype(np.int32), tj.ravel().astype(np.int32))


def _tile_mode(same_side: bool, ti, tj, nti: int, ntj: int):
    """The launch mode of a tile list: ("upper", nt) for the upper tiles of
    one side, ("all", nti, ntj) for every tile of the grid, else None."""
    if same_side and nti == ntj and len(ti) == nti * (nti + 1) // 2:
        ui, uj = upper_triangle_tiles(nti)
        if np.array_equal(ti, ui) and np.array_equal(tj, uj):
            return ("upper", nti)
    if len(ti) == nti * ntj:
        ai, aj = all_tiles(nti, ntj)
        if np.array_equal(ti, ai) and np.array_equal(tj, aj):
            return ("all", nti, ntj)
    return None


@functools.lru_cache(maxsize=64)
def _device_tiles(mode, device):
    """Device copies of a standard tile list, made once per shape, so a
    launch does not copy its list from pageable host memory every time."""
    ti, tj = upper_triangle_tiles(*mode[1:]) if mode[0] == "upper" \
        else all_tiles(*mode[1:])
    return torch.tensor(ti, device=device), torch.tensor(tj, device=device)


def mirror_upper_tiles(s: torch.Tensor, tile: int) -> torch.Tensor:
    """Fill the strictly-lower tiles of ``s [..., n, n]`` with the
    transposed upper tiles; diagonal tiles are complete and kept."""
    r = torch.arange(s.shape[-1], device=s.device) // tile
    lower = r[:, None] > r[None, :]
    return torch.where(lower, s.transpose(-1, -2), s)


def _unpack_t(bits_t: torch.Tensor) -> torch.Tensor:
    """u8[NB, n_pad/8, block] -> float64 0/1 [n_pad, NB*block]."""
    a = bm.unpack_bits_to_int8(bits_t.transpose(1, 2))  # [NB, block, n_pad]
    return a.permute(2, 0, 1).reshape(a.shape[2], -1).to(torch.float64)


def cooccurrence_tiles_plain(
    bits_i_t, bits_j_t, wl_t, tile_i, tile_j, *, tile: int, out
):
    """Plain torch version of :func:`cooccurrence_tiles`.

    Unpacks with shifts, scales the j side by the limb and multiplies in
    float64.  Every partial sum is an integer below 2**31 < 2**53, so the
    result is exact in any summation order, on the CPU and on the card."""
    n_limbs = wl_t.shape[1]
    a_i = _unpack_t(bits_i_t)
    a_j = a_i if bits_j_t is bits_i_t else _unpack_t(bits_j_t)
    w = wl_t.transpose(0, 1).reshape(n_limbs, -1).to(torch.float64)
    pairs = list(zip(np.asarray(tile_i).tolist(), np.asarray(tile_j).tolist()))
    for l in range(n_limbs):
        wa_j = a_j * w[l]
        for i, j in pairs:
            rows = slice(i * tile, (i + 1) * tile)
            cols = slice(j * tile, (j + 1) * tile)
            out[l, rows, cols] += (a_i[rows] @ wa_j[cols].T).to(torch.int32)
    return out


def _check_kernel_args(bits_i_t, bits_j_t, wl_t, ti, tj, tile, out):
    from kspider_tpu_torch.ops import _build

    lib = _build.library()
    if tile != lib.ks_gram_tile():
        raise ValueError(f"the CUDA kernel computes {lib.ks_gram_tile()}-wide "
                         f"tiles, not {tile}")
    dev = bits_i_t.device
    for name, t, dtype in (
        ("bits_i_t", bits_i_t, torch.uint8), ("bits_j_t", bits_j_t, torch.uint8),
        ("wl_t", wl_t, torch.int8), ("out", out, torch.int32),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
    nb, n8_i, block = bits_i_t.shape
    n_limbs = wl_t.shape[1]
    npad_i, npad_j = 8 * n8_i, 8 * bits_j_t.shape[1]
    if (bits_j_t.shape[0], bits_j_t.shape[2]) != (nb, block):
        raise ValueError(f"bits_j_t {tuple(bits_j_t.shape)} does not match "
                         f"bits_i_t {tuple(bits_i_t.shape)}")
    if tuple(wl_t.shape) != (nb, n_limbs, block):
        raise ValueError(f"wl_t {tuple(wl_t.shape)} != ({nb}, L, {block})")
    if tuple(out.shape) != (n_limbs, npad_i, npad_j):
        raise ValueError(f"out {tuple(out.shape)} != "
                         f"({n_limbs}, {npad_i}, {npad_j})")
    # the kernel has no edge masking: samples and colors come in whole
    # tiles and chunks, padded with zero bits and zero weights
    if npad_i % tile or npad_j % tile:
        raise ValueError(f"sample padding {npad_i}x{npad_j} is not a "
                         f"multiple of the {tile}-wide tile")
    if block % lib.ks_gram_chunk():
        raise ValueError(f"block {block} is not a multiple of the kernel's "
                         f"{lib.ks_gram_chunk()}-color chunk")
    if len(ti) != len(tj):
        raise ValueError("tile_i and tile_j differ in length")
    if len(ti) and (ti.min() < 0 or tj.min() < 0 or ti.max() >= npad_i // tile
                    or tj.max() >= npad_j // tile):
        raise ValueError("tile index out of range")
    return lib


def cooccurrence_tiles(
    bits_i_t, bits_j_t, wl_t, tile_i, tile_j, *, tile: int, out
):
    """``out[l, tile i, tile j] += sum_c bit_i[c] * w_l[c] * bit_j[c]`` for
    every pair ``(tile_i[p], tile_j[p])``; returns ``out``.

    ``bits_i_t u8[NB, npad_i/8, block]``, ``bits_j_t u8[NB, npad_j/8,
    block]``, ``wl_t i8[NB, L, block]``, ``out i32[L, npad_i, npad_j]``;
    ``tile_i``/``tile_j`` are host int arrays.  A CUDA tensor launches the
    hand-written kernel (or raises); a CPU tensor takes
    :func:`cooccurrence_tiles_plain`."""
    global LAUNCHES
    if bits_i_t.device.type == "cpu":
        return cooccurrence_tiles_plain(
            bits_i_t, bits_j_t, wl_t, tile_i, tile_j, tile=tile, out=out
        )
    if bits_i_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {bits_i_t.device}")
    ti = np.ascontiguousarray(tile_i, dtype=np.int32)
    tj = np.ascontiguousarray(tile_j, dtype=np.int32)
    lib = _check_kernel_args(bits_i_t, bits_j_t, wl_t, ti, tj, tile, out)
    if len(ti) == 0 or wl_t.shape[1] == 0:
        return out
    dev = bits_i_t.device
    nb, n8_i, block = bits_i_t.shape
    mode = _tile_mode(bits_j_t is bits_i_t, ti, tj, 8 * n8_i // tile,
                      8 * bits_j_t.shape[1] // tile)
    if mode is None:
        ti_d = torch.tensor(ti, device=dev)
        tj_d = torch.tensor(tj, device=dev)
    else:
        ti_d, tj_d = _device_tiles(mode, dev)
    with torch.cuda.device(dev):
        rc = lib.ks_gram_int8_tiles(
            bits_i_t.data_ptr(), bits_j_t.data_ptr(), wl_t.data_ptr(),
            ti_d.data_ptr(), tj_d.data_ptr(), out.data_ptr(),
            len(ti), nb, block, wl_t.shape[1], 8 * n8_i,
            8 * bits_j_t.shape[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram_int8 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_MODE["list" if mode is None else mode[0]] += 1
    return out


def shared_kmer_matrix_cuda(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    device,
    block: int = BLOCK,
    drop_singletons: bool = True,
) -> np.ndarray:
    """Exact shared-k-mer matrix (int64, NxN) through :func:`cooccurrence_tiles`.

    Singleton colors are dropped, weights split into limbs, colors cut into
    int32-exact super-blocks; each super-block streams ``CHUNK_BLOCKS``-block
    chunks into one device-resident ``int32[L, n_pad, n_pad]`` over the
    upper tiles, which is recombined into int64 on the device, mirrored,
    cut to ``[:n, :n]`` and given a zero diagonal."""
    device = resolve_device(device)
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    degrees = np.diff(offsets)
    keep = (
        np.flatnonzero(degrees >= 2) if drop_singletons else np.arange(len(degrees))
    )
    if len(keep) == 0 or n == 0:
        return np.zeros((n, n), dtype=np.int64)

    kept_deg = degrees[keep]
    new_offsets = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_offsets[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_offsets[:-1], kept_deg)
    )
    new_members = members[gather]
    new_weights = weights[keep]

    w_limbs = pw.weight_limbs(new_weights)
    n_limbs = w_limbs.shape[1]
    num_colors = len(new_weights)
    n_pad = max(TILE, pw._round_up(n, TILE))
    ti, tj = upper_triangle_tiles(n_pad // TILE)

    total = torch.zeros((n_pad, n_pad), dtype=torch.int64, device=device)
    acc = torch.empty((n_limbs, n_pad, n_pad), dtype=torch.int32, device=device)
    super_size = pw._MAX_COLORS_PER_CALL - (pw._MAX_COLORS_PER_CALL % block)
    chunk_colors = CHUNK_BLOCKS * block
    for start in range(0, num_colors, super_size):
        stop = min(start + super_size, num_colors)
        acc.zero_()
        for cs in range(start, stop, chunk_colors):
            ce = min(cs + chunk_colors, stop)
            sl_off = new_offsets[cs : ce + 1] - new_offsets[cs]
            sl_mem = new_members[new_offsets[cs] : new_offsets[ce]]
            bits_t, wl_t = pack_inputs(sl_off, sl_mem, w_limbs[cs:ce], n_pad, block)
            bits = torch.from_numpy(bits_t).to(device)
            cooccurrence_tiles(
                bits, bits, torch.from_numpy(wl_t).to(device), ti, tj,
                tile=TILE, out=acc,
            )
        for l in range(n_limbs):
            total.add_(acc[l], alpha=128**l)
    s = mirror_upper_tiles(total, TILE)[:n, :n]
    s.fill_diagonal_(0)
    return s.cpu().numpy()
