"""Packed-bit membership layout: host packing and plain torch unpacking.

Counterpart of ``kspider_tpu/ops/bitmask.py``.  Each color's membership is
a packed bitmask of ``n_pad/8`` bytes, most significant bit first
(``np.packbits`` order).  The device-pack codecs of the JAX module (posting
keys, delta encodings, on-device scatter pack) belong to the tiled engine
and are not ported yet.
"""

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
