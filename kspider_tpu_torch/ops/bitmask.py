"""Packed-bit membership layout: host packing, posting-key codecs and the
torch device pack.

Counterpart of ``kspider_tpu/ops/bitmask.py``.  Each color's membership is
a packed bitmask of ``n_pad/8`` bytes, most significant bit first
(``np.packbits`` order).

Both engines can ship sparse colors as sorted posting keys (``seg *
panel_pad + member``) instead of their packed bitmask, and rebuild the
bitmask on the device: the dense engine per chunk of colors
(:func:`build_scatter_keys`), the panel-streamed one per panel side.  The key codecs (raw i32, i16 deltas,
u8 deltas with an i32 escape channel) are numpy and byte-identical to the
JAX module's.  The device pack is plain torch: JAX computes it in XLA,
outside any Pallas kernel.
"""

import os
import warnings
from typing import Tuple

import numpy as np
import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_bitmask_blocks(
    offsets: np.ndarray, members: np.ndarray, n: int, block: int
) -> np.ndarray:
    """CSR colors -> packed membership bitmasks [NB, block, n_pad/8] u8."""
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int64)
    num_colors = len(offsets) - 1
    num_blocks = max(1, _cdiv(num_colors, block))
    n_pad = max(128, _cdiv(n, 128) * 128)
    n8 = n_pad // 8
    bits = np.zeros((num_blocks * block, n8), dtype=np.uint8)
    degrees = np.diff(offsets)
    color_idx = np.repeat(np.arange(num_colors, dtype=np.int64), degrees)
    np.bitwise_or.at(
        bits,
        (color_idx, members // 8),
        (np.uint8(0x80) >> (members % 8).astype(np.uint8)),
    )
    return bits.reshape(num_blocks, block, n8)


def pack_bitmask_blocks_t(
    offsets: np.ndarray, members: np.ndarray, n: int, block: int,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """CSR colors -> the kernel's transposed layout u8[NB, n_pad/8, block],
    equal to ``pack_bitmask_blocks(...).transpose(0, 2, 1)`` but written in
    place, with no transposed copy; into ``out`` (contiguous, zeroed here)
    when given."""
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int64)
    num_colors = len(offsets) - 1
    num_blocks = max(1, _cdiv(num_colors, block))
    n8 = max(128, _cdiv(n, 128) * 128) // 8
    if out is None:
        out = np.zeros((num_blocks, n8, block), dtype=np.uint8)
    else:
        out.fill(0)
    color_idx = np.repeat(np.arange(num_colors, dtype=np.int64),
                          np.diff(offsets))
    byte = ((color_idx // block) * n8 + members // 8) * block + color_idx % block
    np.bitwise_or.at(out.reshape(-1), byte,
                     np.uint8(0x80) >> (members % 8).astype(np.uint8))
    return out


def unpack_bits_to_int8(bits: torch.Tensor) -> torch.Tensor:
    """u8[..., n8] -> i8[..., n8*8] 0/1 (MSB-first, matching np.packbits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    expanded = (bits[..., None] >> shifts) & 1
    return expanded.reshape(*bits.shape[:-1], bits.shape[-1] * 8).to(torch.int8)


def cooccurrence_bitmask_blocks(
    bits: torch.Tensor, w_limbs: torch.Tensor, n_limbs: int
) -> torch.Tensor:
    """bits u8[NB, block, n_pad/8], w_limbs i8[NB, block, n_limbs]
    -> i32[n_limbs, n_pad, n_pad] per-limb Gram accumulators.

    Products run in float64: every partial sum is an integer below 2**31
    (callers bound the colors per call), far inside float64's exact range,
    so the result is exact in any summation order."""
    a = unpack_bits_to_int8(bits).reshape(-1, bits.shape[-1] * 8)
    a = a.to(torch.float64)
    w = w_limbs.reshape(-1, n_limbs).to(torch.float64)
    return torch.stack(
        [((a * w[:, l, None]).T @ a).to(torch.int32) for l in range(n_limbs)]
    )


# ---- posting-key codecs (host, numpy) ------------------------------------


def device_pack_policy(policy=None) -> Tuple[str, float]:
    """(policy, ratio) for shipping color chunks or panel sides as posting
    keys.

    ``policy`` is auto, force or off; None reads ``KSPIDER_DEVICE_PACK``
    (default auto).  Under auto, keys ship when their payload is at least
    ``ratio`` times smaller than the packed bitmask; the ratio comes from
    ``KSPIDER_DEVICE_PACK_RATIO`` (default 1.25).  A bad environment value
    warns and takes the default; a bad ``policy`` argument raises."""
    if policy is None:
        policy = os.environ.get("KSPIDER_DEVICE_PACK", "auto").lower()
        if policy not in ("auto", "force", "off"):
            warnings.warn(
                f"KSPIDER_DEVICE_PACK={policy!r} not in auto/force/off; "
                "using 'auto'",
                RuntimeWarning,
            )
            policy = "auto"
    elif policy not in ("auto", "force", "off"):
        raise ValueError(f"device_pack {policy!r} not in auto/force/off")
    raw_ratio = os.environ.get("KSPIDER_DEVICE_PACK_RATIO", "1.25")
    try:
        ratio = float(raw_ratio)
    except ValueError:
        warnings.warn(
            f"KSPIDER_DEVICE_PACK_RATIO={raw_ratio!r} is not a number; "
            "using 1.25",
            RuntimeWarning,
        )
        ratio = 1.25
    return policy, ratio


def key_bucket(m: int) -> int:
    """Padded key-array length for ``m`` postings: quarter-octave buckets
    (4 sizes per power of two), at least 512."""
    if m <= 512:
        return 512
    p = 1 << ((m - 1).bit_length() - 1)  # largest power of two < 2m
    step = max(1, p // 4)
    return -(-m // step) * step


def prefer_keys(policy: str, ratio: float, postings: int,
                bitmask_bytes: int) -> bool:
    """kspider_tpu's choice for a chunk or panel side of ``postings``
    postings whose packed bitmask takes ``bitmask_bytes``: posting keys
    under "force"; under "auto" when their bucketed payload (4 bytes a
    posting) times ``ratio`` is at most the bitmask's bytes; never under
    "off"."""
    return policy == "force" or (
        policy == "auto" and 4 * key_bucket(postings) * ratio <= bitmask_bytes)


def build_scatter_keys(
    offsets: np.ndarray, members: np.ndarray, n_pad: int, n_blocks: int,
    block: int,
) -> "np.ndarray | None":
    """CSR colors -> sorted scatter keys for :func:`scatter_pack_device`.

    Key = color * n_pad + member, padded to ``key_bucket`` with ascending
    out-of-range bit positions (dropped on the device).  Returns None when
    the bit space would overflow int32 or members are not strictly
    ascending within each color (the keys must be sorted and unique): the
    caller then packs on the host."""
    offsets = np.asarray(offsets, dtype=np.int64)
    cnt = np.diff(offsets)
    m = int(cnt.sum())
    total_bits = n_blocks * block * n_pad
    bucket = key_bucket(m)
    if total_bits + bucket >= 2**31:
        return None
    cidx = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    keys = cidx * n_pad + np.asarray(members, dtype=np.int64)
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        return None
    out = np.empty(bucket, dtype=np.int32)
    out[:m] = keys
    out[m:] = total_bits + np.arange(bucket - m, dtype=np.int32)
    return out


def delta_encode_keys(keys: np.ndarray, count: int):
    """Bucket-padded i32 scatter keys -> (first, i16 deltas) or None.

    ``decoded[i] = first + cumsum(d)[i]`` with ``d[0] = 0``; positions past
    ``count`` are don't-care.  None when a delta exceeds int16: the caller
    ships raw i32 keys."""
    if count <= 0:
        return None
    real = keys[:count].astype(np.int64)
    d = np.diff(real)
    if len(d) and d.max() > 32767:
        return None
    out = np.ones(len(keys), dtype=np.int16)
    out[0] = 0
    out[1:count] = d.astype(np.int16)
    return int(real[0]), out


def delta_encode_keys_u8(keys: np.ndarray, count: int):
    """Bucket-padded i32 scatter keys -> (first, u8 deltas, i32 exceptions)
    or None.

    Literal deltas 1..255 take one byte; 0 escapes to the next entry of the
    exception array (deltas are >= 1, so 0 is free as a marker).  Position
    0 carries a dummy; the exception array is padded to a power of two of
    at least 8."""
    if count <= 0:
        return None
    real = keys[:count].astype(np.int64)
    d = np.diff(real)
    esc = d > 255
    n_exc = int(esc.sum())
    bucket = len(keys)
    d8 = np.ones(bucket, dtype=np.uint8)
    if count > 1:
        d8[1:count] = np.where(esc, 0, np.minimum(d, 255)).astype(np.uint8)
    exc_bucket = max(8, 1 << (max(n_exc, 1) - 1).bit_length())
    exc = np.zeros(exc_bucket, np.int32)
    exc[:n_exc] = d[esc].astype(np.int32)
    return int(real[0]), d8, exc


def encode_keys_best(keys: np.ndarray, count: int):
    """Smallest wire form for a padded key array:
    ("d8", first, u8 deltas, i32 exceptions), ("d16", first, i16 deltas),
    or None (ship raw i32 keys)."""
    if count <= 0:
        return None
    bucket = len(keys)
    e8 = delta_encode_keys_u8(keys, count)
    bytes_d8 = bucket + 4 * len(e8[2]) if e8 else None
    e16 = delta_encode_keys(keys, count)
    bytes_d16 = 2 * bucket if e16 else None
    best = min(
        [(b, t) for b, t in ((bytes_d8, "d8"), (bytes_d16, "d16"))
         if b is not None and b < 4 * bucket],
        default=None,
    )
    if best is None:
        return None
    if best[1] == "d8":
        return ("d8",) + e8
    return ("d16",) + e16


# ---- device pack (torch) --------------------------------------------------


def _pack_keys(k: torch.Tensor, n_blocks: int, block: int, panel_pad: int):
    """int64 keys on the device -> u8[n_blocks, panel_pad/8, block].

    Key ``seg * panel_pad + member`` sets bit ``0x80 >> (member & 7)`` of
    byte ``member >> 3`` of color ``seg``, written straight into the
    kernel's transposed layout.  Keys are unique, so adding the bits into
    int32 bytes is their OR.  Keys at or past the bit space (pad
    sentinels) land in one spill slot that is cut off."""
    n8 = panel_pad // 8
    size = n_blocks * n8 * block
    seg = k // panel_pad
    member = k % panel_pad
    byte = ((seg // block) * n8 + (member >> 3)) * block + seg % block
    byte = torch.where(k < n_blocks * block * panel_pad, byte, size)
    bit = torch.bitwise_right_shift(
        torch.full_like(member, 0x80), member & 7
    ).to(torch.int32)
    flat = torch.zeros(size + 1, dtype=torch.int32, device=k.device)
    flat.index_add_(0, byte, bit)
    return flat[:size].to(torch.uint8).view(n_blocks, n8, block)


def _sentinel_tail(k: torch.Tensor, count: int, total: int) -> torch.Tensor:
    """Positions at or past ``count`` -> ascending out-of-range keys."""
    iota = torch.arange(k.shape[0], dtype=torch.int64, device=k.device)
    return torch.where(iota < count, k, total + (iota - count))


def _on_device(x, device) -> torch.Tensor:
    """A device tensor of ``x``, as int64: a tensor is used where it lies; a
    numpy array is moved to ``device`` (CUDA: through pinned memory with
    ``non_blocking=True``, on the current stream, which drains nothing)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True).to(torch.int64)


def scatter_pack_device(
    keys, n_blocks: int, block: int, panel_pad: int, *, device=None
) -> torch.Tensor:
    """Packed bitmask blocks built on the device from sorted posting keys.

    ``keys`` i32: ``seg * panel_pad + member`` per posting, strictly
    increasing; values at or past ``n_blocks * block * panel_pad`` are
    padding and dropped.  A tensor is packed on its own device; a numpy
    array is moved to ``device`` first (:func:`_on_device`).  Returns
    u8[n_blocks, panel_pad/8, block], the kernel's layout, equal bit for
    bit to the transposed ``pack_bitmask_blocks``."""
    return _pack_keys(_on_device(keys, device), n_blocks, block, panel_pad)


def scatter_pack_device_delta(
    first: int, deltas, count: int, n_blocks: int, block: int,
    panel_pad: int, *, device=None,
) -> torch.Tensor:
    """:func:`scatter_pack_device` over ``delta_encode_keys`` output:
    ``first + cumsum(i16 deltas)`` decoded on the device."""
    d = _on_device(deltas, device)
    k = int(first) + torch.cumsum(d, 0)
    k = _sentinel_tail(k, int(count), n_blocks * block * panel_pad)
    return _pack_keys(k, n_blocks, block, panel_pad)


def scatter_pack_device_delta8(
    first: int, d8, exceptions, count: int,
    n_blocks: int, block: int, panel_pad: int, *, device=None,
) -> torch.Tensor:
    """:func:`scatter_pack_device` over ``delta_encode_keys_u8`` output.

    A 0 byte takes the next exception (a running count of escapes indexes
    the exception array), position 0 is forced to delta 0, then one cumsum
    rebuilds the keys."""
    di = _on_device(d8, device)
    exc = _on_device(exceptions, device)
    is_esc = di == 0
    eidx = torch.cumsum(is_esc.to(torch.int64), 0) - 1
    d = torch.where(is_esc, exc[eidx.clamp(0, exc.shape[0] - 1)], di)
    d[:1].zero_()  # a fill on the device: ``d[0] = 0`` would copy from the host
    k = int(first) + torch.cumsum(d, 0)
    k = _sentinel_tail(k, int(count), n_blocks * block * panel_pad)
    return _pack_keys(k, n_blocks, block, panel_pad)
