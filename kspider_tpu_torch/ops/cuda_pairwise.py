"""Dense pairwise engine on the hand-written Hopper Gram kernel.

Counterpart of ``kspider_tpu/ops/pallas_pairwise.py``.  The four Pallas
kernels there (full square, rectangle, upper-triangle tile list, symmetric
strips) compute the same per-tile sum

    acc_l[i, j] = sum_c bit[c, i] * w_l[c] * bit[c, j]

and become one CUDA kernel per ``compute_dtype`` form, driven by a list
of output tile pairs: "all tiles" of a rectangle covers the square and
rectangle kernels, "upper tiles" of one panel covers the triangle kernel
and, after ``mirror_upper_tiles``, the symmetric one.

Both forms of the Pallas kernels are ported: ``torch.int8`` (the default,
every CLI path: ``csrc/gram_int8.cu``, wgmma s8 products into int32) and
``torch.bfloat16`` (``csrc/gram_bf16.cu``, wgmma bf16 products into float32
sums, added into int32 at least every ``BF16_SEGMENT_CHUNKS`` chunks).
Both are exact; no CLI path sets bf16, as in kspider_tpu.

Inputs keep the JAX package's transposed layout, colors contiguous:
``bits_t u8[NB, n_pad/8, block]`` (MSB-first) and ``wl_t i8[NB, L, block]``.
The TPU's VMEM budgets (``best_strip``, ``sym_fits``, ``auto_tile``) have
no counterpart: the engine always computes upper tiles and mirrors them.

The dense engine streams ``CHUNK_BLOCKS``-block chunks of colors, as
``shared_kmer_matrix_pallas`` does.  Per chunk it ships either sorted
posting keys, packed into the bitmask on the device
(``bitmask.scatter_pack_device``), or the bitmask packed on the host,
by kspider_tpu's rule (``bitmask.device_pack_policy``, ``KSPIDER_DEVICE_PACK``
and ``KSPIDER_DEVICE_PACK_RATIO``); ``DENSE_CHUNKS`` counts the two forms.
On a CUDA device every chunk input crosses from pinned memory with
``non_blocking=True`` on the current stream, so packing chunk k + 1 on the
host overlaps the kernel on chunk k and no copy drains the stream.  The
host bitmask is packed straight into a pinned buffer in the transposed
layout.  Pinned buffers are fresh ones from torch's caching host
allocator, which records the copy's event on each and reuses its memory
only after that event has completed; nothing rewrites a buffer in
flight.  On the CPU the same code runs without pinning.
"""

import functools

import numpy as np
import torch
from torch.profiler import record_function

from kspider_tpu_torch.device import resolve_device
from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import pairwise as pw
from kspider_tpu_torch.utils.timing import timed

#: output tile edge of the CUDA kernels (``kTile`` in csrc/gram_int8.cu)
TILE = 128
#: colors per chunk of the int8 kernel (``kChunk`` in csrc/gram_int8.cu)
CHUNK = 128
#: colors per color block; the kernel needs a multiple of its chunk
BLOCK = 1024
#: color blocks packed and shipped to the device per kernel launch
CHUNK_BLOCKS = 64

#: number of CUDA kernel launches made by :func:`cooccurrence_tiles`
LAUNCHES = 0
#: the same launches by tile list: "upper" (upper tiles of one side, the
#: TPU's tri/sym kernels), "all" (every tile of a grid, square or rect) or
#: "list" (any other list)
LAUNCHES_BY_MODE = {"upper": 0, "all": 0, "list": 0}
#: the same launches by compute dtype
LAUNCHES_BY_DTYPE = {"int8": 0, "bfloat16": 0}
#: chunks of the dense engine by the form they reach the device in:
#: "keys" (posting keys packed on the device) or "host" (host bitmask)
DENSE_CHUNKS = {"keys": 0, "host": 0}
#: bytes of chunk inputs (keys or bitmask, and weight limbs) the dense
#: engine handed to its device: an H2D copy's payload on a card
DENSE_H2D_BYTES = 0

#: per compute dtype: its name in LAUNCHES_BY_DTYPE, the library's launch
#: entry point and the entry point giving its color chunk
_FORMS = {
    torch.int8: ("int8", "ks_gram_int8_tiles", "ks_gram_chunk"),
    torch.bfloat16: ("bfloat16", "ks_gram_bf16_tiles", "ks_gram_chunk_bf16"),
}
#: largest color block of the bf16 form: its float32 partial sums, at most
#: 127 per color, stay exact below 2**24
MAX_BF16_BLOCK = 2**24 // 127
#: colors per chunk of the bf16 kernel (``kChunk`` in csrc/gram_bf16.cu)
BF16_CHUNK = 64
#: chunks between two flushes of the bf16 kernel's float32 sums into int32
#: (2,064): a partial sum is at most 127 * 64 * 2,064 = 16,776,192 < 2**24,
#: an exact float32 integer
BF16_SEGMENT_CHUNKS = MAX_BF16_BLOCK // BF16_CHUNK


def pack_inputs(
    offsets: np.ndarray,
    members: np.ndarray,
    w_limbs: np.ndarray,
    n_pad: int,
    block: int,
    device_pack: bool = False,
    *,
    empty=None,
):
    """CSR colors -> host arrays ``(bits_t u8[NB, n_pad/8, block],
    wl_t i8[NB, L, block])``; pad colors carry zero bits and zero weights.

    With ``device_pack``, ``bits_t`` is instead kspider_tpu's marker
    ``("keys", keys, NB)`` when ``bitmask.build_scatter_keys`` qualifies
    the chunk: sorted posting keys to pack on the device.
    ``empty(shape, numpy dtype)`` makes the two arrays (default
    ``np.empty``); the engine passes pinned torch tensors, which are filled
    through their numpy views and returned as they are."""
    empty = empty or np.empty
    nb = max(1, -(-(len(offsets) - 1) // block))
    n_limbs = w_limbs.shape[1]
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[: len(w_limbs)] = w_limbs
    wl_t = empty((nb, n_limbs, block), np.int8)
    _numpy(wl_t)[...] = wl.reshape(nb, block, n_limbs).transpose(0, 2, 1)
    if device_pack:
        keys = bm.build_scatter_keys(offsets, members, n_pad, nb, block)
        if keys is not None:
            return ("keys", keys, nb), wl_t
    bits_t = empty((nb, n_pad // 8, block), np.uint8)
    bm.pack_bitmask_blocks_t(offsets, members, n_pad, block, out=_numpy(bits_t))
    return bits_t, wl_t


def _numpy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else a


def _pinned_empty(shape, dtype) -> torch.Tensor:
    """A pinned host tensor from torch's caching host allocator."""
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True)


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
    """Device copies of a standard tile list, made once per shape on the
    current stream: ``((tile_i, tile_j) on the device, their pinned host
    sources)``.  The copies start from pinned memory with
    ``non_blocking=True``, so the first launch of a shape drains no stream;
    the cache keeps the sources alive."""
    lists = upper_triangle_tiles(*mode[1:]) if mode[0] == "upper" \
        else all_tiles(*mode[1:])
    host = tuple(torch.from_numpy(t.copy()).pin_memory() for t in lists)
    return tuple(h.to(device, non_blocking=True) for h in host), host


def mirror_upper_tiles(s: torch.Tensor, tile: int) -> torch.Tensor:
    """Fill the strictly-lower tiles of ``s [..., n, n]`` with the
    transposed upper tiles; diagonal tiles are complete and kept."""
    r = torch.arange(s.shape[-1], device=s.device) // tile
    lower = r[:, None] > r[None, :]
    return torch.where(lower, s.transpose(-1, -2), s)


def _unpack_t(bits_t: torch.Tensor) -> torch.Tensor:
    """u8[NB, n_pad/8, block] -> int8 0/1 [NB, n_pad, block]."""
    return bm.unpack_bits_to_int8(bits_t.transpose(1, 2)).transpose(1, 2)


def _colors_flat_f64(a: torch.Tensor) -> torch.Tensor:
    """int8 [NB, n_pad, block] -> float64 [n_pad, NB*block]."""
    return a.permute(1, 0, 2).reshape(a.shape[1], -1).to(torch.float64)


def _check_dtype(compute_dtype, block: int) -> str:
    """The compute dtype's name; raises on a dtype or block it cannot take."""
    if compute_dtype not in _FORMS:
        raise ValueError(f"compute_dtype {compute_dtype} is neither torch.int8 "
                         "nor torch.bfloat16")
    if compute_dtype == torch.bfloat16 and block > MAX_BF16_BLOCK:
        raise ValueError(f"block {block} > {MAX_BF16_BLOCK}: the bf16 form's "
                         "float32 block sums would not be exact")
    return _FORMS[compute_dtype][0]


def _through_bf16(x: torch.Tensor) -> torch.Tensor:
    """Cast to bf16 and back to float32: the bf16 operand, multiplied in
    float32 (a matmul of two bf16 tensors would round its bf16 result)."""
    return x.to(torch.bfloat16).to(torch.float32)


def cooccurrence_tiles_plain(
    bits_i_t, bits_j_t, wl_t, tile_i, tile_j, *, tile: int, out,
    compute_dtype=torch.int8,
):
    """Plain torch version of :func:`cooccurrence_tiles`.

    Unpacks with shifts and scales the j side by the limb.  The int8 form
    multiplies in float64 over all colors at once: every partial sum is an
    integer below 2**31 < 2**53, so the result is exact in any summation
    order.  The bf16 form follows the Pallas kernel's dataflow: operands
    cast through bf16, one float32 product per color block (integers below
    2**24, exact), each added into int32; the bf16 kernel flushes per
    segment of chunks instead, to the same sums.  Exact on the CPU and on
    the card, also under TF32, which keeps integers up to 127."""
    _check_dtype(compute_dtype, bits_i_t.shape[2])
    n_limbs = wl_t.shape[1]
    a_i = _unpack_t(bits_i_t)
    a_j = a_i if bits_j_t is bits_i_t else _unpack_t(bits_j_t)
    pairs = list(zip(np.asarray(tile_i).tolist(), np.asarray(tile_j).tolist()))
    if compute_dtype == torch.bfloat16:
        a_i_f = _through_bf16(a_i)
        for l in range(n_limbs):
            # int8 stays exact: a bit times a limb is at most 127
            wa_j = _through_bf16(a_j * wl_t[:, l, None, :])
            for i, j in pairs:
                rows = slice(i * tile, (i + 1) * tile)
                cols = slice(j * tile, (j + 1) * tile)
                per_block = torch.bmm(a_i_f[:, rows], wa_j[:, cols].transpose(1, 2))
                out[l, rows, cols] += per_block.to(torch.int32).sum(
                    0, dtype=torch.int32)
        return out
    a_i_f = _colors_flat_f64(a_i)
    a_j_f = a_i_f if a_j is a_i else _colors_flat_f64(a_j)
    w = wl_t.transpose(0, 1).reshape(n_limbs, -1).to(torch.float64)
    for l in range(n_limbs):
        wa_j = a_j_f * w[l]
        for i, j in pairs:
            rows = slice(i * tile, (i + 1) * tile)
            cols = slice(j * tile, (j + 1) * tile)
            out[l, rows, cols] += (a_i_f[rows] @ wa_j[cols].T).to(torch.int32)
    return out


def _check_kernel_args(bits_i_t, bits_j_t, wl_t, ti, tj, tile, out,
                       compute_dtype):
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
    chunk = getattr(lib, _FORMS[compute_dtype][2])()
    if compute_dtype == torch.bfloat16 and chunk != BF16_CHUNK:
        raise RuntimeError(f"the bf16 kernel's chunk is {chunk} colors, not "
                           f"{BF16_CHUNK}: BF16_SEGMENT_CHUNKS is not exact")
    if block % chunk:
        raise ValueError(f"block {block} is not a multiple of the kernel's "
                         f"{chunk}-color chunk ({compute_dtype} form)")
    if len(ti) != len(tj):
        raise ValueError("tile_i and tile_j differ in length")
    if len(ti) and (ti.min() < 0 or tj.min() < 0 or ti.max() >= npad_i // tile
                    or tj.max() >= npad_j // tile):
        raise ValueError("tile index out of range")
    return lib


def cooccurrence_tiles(
    bits_i_t, bits_j_t, wl_t, tile_i, tile_j, *, tile: int, out,
    compute_dtype=torch.int8,
):
    """``out[l, tile i, tile j] += sum_c bit_i[c] * w_l[c] * bit_j[c]`` for
    every pair ``(tile_i[p], tile_j[p])``; returns ``out``.

    ``bits_i_t u8[NB, npad_i/8, block]``, ``bits_j_t u8[NB, npad_j/8,
    block]``, ``wl_t i8[NB, L, block]``, ``out i32[L, npad_i, npad_j]``;
    ``tile_i``/``tile_j`` are host int arrays.  ``compute_dtype`` picks the
    kernel's form, ``torch.int8`` or ``torch.bfloat16`` (``block`` at most
    ``MAX_BF16_BLOCK``).  A CUDA tensor launches the hand-written kernel (or
    raises); a CPU tensor takes :func:`cooccurrence_tiles_plain`."""
    global LAUNCHES
    dtype_name = _check_dtype(compute_dtype, bits_i_t.shape[2])
    if bits_i_t.device.type == "cpu":
        return cooccurrence_tiles_plain(
            bits_i_t, bits_j_t, wl_t, tile_i, tile_j, tile=tile, out=out,
            compute_dtype=compute_dtype,
        )
    if bits_i_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {bits_i_t.device}")
    ti = np.ascontiguousarray(tile_i, dtype=np.int32)
    tj = np.ascontiguousarray(tile_j, dtype=np.int32)
    lib = _check_kernel_args(bits_i_t, bits_j_t, wl_t, ti, tj, tile, out,
                             compute_dtype)
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
        ti_d, tj_d = _device_tiles(mode, dev)[0]
    # the bf16 kernel also takes its flush segment
    segment = (BF16_SEGMENT_CHUNKS,) if compute_dtype == torch.bfloat16 else ()
    with torch.cuda.device(dev):
        rc = getattr(lib, _FORMS[compute_dtype][1])(
            bits_i_t.data_ptr(), bits_j_t.data_ptr(), wl_t.data_ptr(),
            ti_d.data_ptr(), tj_d.data_ptr(), out.data_ptr(),
            len(ti), nb, block, wl_t.shape[1], 8 * n8_i,
            8 * bits_j_t.shape[1], *segment,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel launch ({dtype_name} form) failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_MODE["list" if mode is None else mode[0]] += 1
    LAUNCHES_BY_DTYPE[dtype_name] += 1
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
    compute_dtype=torch.int8,
    device_pack=None,
) -> np.ndarray:
    """Exact shared-k-mer matrix (int64, NxN) through :func:`cooccurrence_tiles`
    in the ``compute_dtype`` form (as ``shared_kmer_matrix_pallas``'s).

    Singleton colors are dropped, weights split into limbs, colors cut into
    int32-exact super-blocks; each super-block streams ``CHUNK_BLOCKS``-block
    chunks into one device-resident ``int32[L, n_pad, n_pad]`` over the
    upper tiles, which is recombined into int64 on the device, mirrored,
    cut to ``[:n, :n]`` and given a zero diagonal.  ``device_pack``
    (auto/force/off; None reads ``KSPIDER_DEVICE_PACK``) picks each chunk's
    form by kspider_tpu's rule (``bitmask.prefer_keys``): posting keys,
    or the host bitmask when the rule says so or the keys do not
    qualify.  The steps are the ``kspider.prepare`` (singleton drop, weight
    limbs), ``kspider.pack`` (host pack, H2D and device pack),
    ``kspider.gram`` (the launch) and ``kspider.recombine`` (limbs, mirror,
    D2H) ranges of a ``torch.profiler`` trace."""
    global DENSE_H2D_BYTES
    device = resolve_device(device)
    with timed("kspider.prepare"):
        new_offsets, new_members, new_weights = pw._drop_singletons(
            np.asarray(offsets, dtype=np.int64), np.asarray(members, dtype=np.int32),
            np.asarray(weights, dtype=np.int64), drop_singletons)
        if len(new_weights) == 0 or n == 0:
            return np.zeros((n, n), dtype=np.int64)
        w_limbs = pw.weight_limbs(new_weights)

    dp_policy, dp_ratio = bm.device_pack_policy(device_pack)
    empty = _pinned_empty if device.type == "cuda" else None
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
            with record_function("kspider.pack"):
                sl_off = new_offsets[cs : ce + 1] - new_offsets[cs]
                sl_mem = new_members[new_offsets[cs] : new_offsets[ce]]
                nb_chunk = max(1, -(-(ce - cs) // block))
                devpack = bm.prefer_keys(dp_policy, dp_ratio, len(sl_mem),
                                         nb_chunk * block * n_pad // 8)
                bits_h, wl_h = pack_inputs(sl_off, sl_mem, w_limbs[cs:ce],
                                           n_pad, block, device_pack=devpack,
                                           empty=empty)
                wl = torch.as_tensor(wl_h).to(device, non_blocking=True)
                if isinstance(bits_h, tuple):
                    _, keys, nb = bits_h
                    keys = keys[: len(sl_mem)]  # the pad drops on the device
                    bits = bm.scatter_pack_device(keys, nb, block, n_pad,
                                                  device=device)
                    form, nbytes = "keys", keys.nbytes
                else:
                    bits = torch.as_tensor(bits_h).to(device, non_blocking=True)
                    form, nbytes = "host", bits_h.nbytes
                DENSE_CHUNKS[form] += 1
                DENSE_H2D_BYTES += nbytes + wl_h.nbytes
            with record_function("kspider.gram"):
                cooccurrence_tiles(bits, bits, wl, ti, tj, tile=TILE, out=acc,
                                   compute_dtype=compute_dtype)
        with record_function("kspider.recombine"):
            for l in range(n_limbs):
                total.add_(acc[l], alpha=128**l)
    with record_function("kspider.recombine"):
        s = mirror_upper_tiles(total, TILE)[:n, :n]
        s.fill_diagonal_(0)
        return s.cpu().numpy()
