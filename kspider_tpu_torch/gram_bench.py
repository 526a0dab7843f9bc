"""The Gram kernel on the card: exactness, time, bound and yardstick.

    python -m kspider_tpu_torch.gram_bench [--form int8|bf16|both] [--reps R]
                                           [--no-plain] [--seed S]

The one definition of the kernel's check cases and of its measurement,
used by this quick check, by ``chip_smoke.py`` (phase 3) and by
``tests/test_torch_gpu.py``:

- ``RAGGED``: small ragged shapes, each run in every mode of ``MODES``
  (``ragged_inputs``, ``mode_tiles``), held bit-exact against the plain
  torch version (``max_err``);
- ``measure``: at one shape and form, ``max_abs_err`` and, with CUDA
  events after a warm-up, ``ms`` (one call into a freshly zeroed ``out``,
  as the paths call it), ``plain_ms`` (``cooccurrence_tiles_plain``, the
  same way), ``bound_ms``/``bound_by`` (the larger of the operations over
  the form's tensor peak and the bytes over the memory rate, ``bound``)
  and ``library_ms``: one library product of the unpacked operands
  (``int_mm_operands``), the weighted i side ``[L * n_i, C]`` times the
  0/1 j side ``[C, n_j]``, every tile of every limb in one call, named in
  ``library``: ``torch._int_mm`` of the int8 operands for the int8 form,
  ``torch.mm`` of the operands cast to bf16 into float32 for the bf16 form
  (``library_call``).  For an "upper" launch it computes the whole square,
  about twice the work.  The unpack and the cast are outside the timing;
  the operands are 8x (int8) or 16x (bf16) the packed bytes.

This module's main checks ``RAGGED`` and measures random inputs at
``SHAPES``, in the forms ``--form`` names (both by default);
``chip_smoke.py`` measures both forms on its collections' own inputs at the
path's shapes.  Needs a CUDA card.
"""

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cuda_pairwise as cp

#: H100 SXM published peaks at 700 W: dense int8 and bf16 tensor rates and
#: the HBM3 rate
INT8_OPS_PER_S = 1.979e15
BF16_OPS_PER_S = 0.989e15
BYTES_PER_S = 3.35e12

#: (label, mode of MODES, npad_i, npad_j, NB, L): the shapes the main path
#: gives the kernel (blocks of 1,024 colors): the dense engine's 64-block
#: chunk at N = 8,192; the same as a square; the tiled engine's diagonal and
#: off-diagonal panel pairs at N = 32,768; a 4,096 x 4,096 rectangle; one
#: of the two shards of the dense engine's colors at N = 8,192 (97 of its
#: 193 blocks); then the diagonal pair at the other limb counts (L = 3 once
#: a color holds 16,384 k-mers or more)
SHAPES = (
    ("dense upper, n_pad 8192, NB 64", "upper", 8192, 8192, 64, 2),
    ("square all, 8192^2, NB 64", "square", 8192, 8192, 64, 2),
    ("tiled diagonal, panel 4096, NB 102", "upper", 4096, 4096, 102, 2),
    ("tiled off-diagonal, 4096^2, NB 8", "rect", 4096, 4096, 8, 2),
    ("rect, 4096^2, NB 64", "rect", 4096, 4096, 64, 2),
    ("dense upper, one of two shards, NB 97", "upper", 8192, 8192, 97, 2),
    ("tiled diagonal, panel 4096, NB 102, L 1", "upper", 4096, 4096, 102, 1),
    ("tiled diagonal, panel 4096, NB 102, L 3", "upper", 4096, 4096, 102, 3),
    ("tiled diagonal, panel 4096, NB 102, L 4", "upper", 4096, 4096, 102, 4),
)
BLOCK = 1024

#: small ragged shapes, each checked in every mode of MODES:
#: (NB, npad_i, npad_j, block, L), L = 1-4, blocks of one to eight chunks
RAGGED = (
    (1, 128, 128, 128, 1),
    (1, 256, 384, 128, 2),
    (1, 384, 384, 1024, 3),
    (3, 640, 256, 256, 2),
    (5, 384, 640, 128, 3),
    (2, 1152, 896, 640, 1),
    (2, 640, 512, 384, 4),
)
#: the launch modes of a ragged shape: every tile of the i x j rectangle,
#: every tile of the i x i square, its upper tiles, and the rectangle's
#: tiles in a shuffled order (a "list" launch)
MODES = ("rect", "square", "upper", "list")


def gram_ops(n_tiles: int, colors: int, n_limbs: int, tile: int = cp.TILE) -> int:
    """Integer operations of one launch: a multiply and an add per color,
    per limb, per element of every listed tile."""
    return 2 * n_tiles * tile * tile * colors * n_limbs


def gram_bytes(bits_i, bits_j, wl, out_shape) -> int:
    """Bytes the function must move: each input read once (one side when
    both are the same tensor), the int32 ``out`` read and written once."""
    sides = bits_i.numel() + (0 if bits_j is bits_i else bits_j.numel())
    return sides + wl.numel() + 2 * 4 * math.prod(out_shape)


def bound(ops: int, nbytes: int, ops_per_s: float = INT8_OPS_PER_S):
    """(bound ms, "operations" or "bytes") on an H100 SXM at 700 W, for
    operations at ``ops_per_s`` (the int8 tensor peak by default)."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_mm_operands(bits_i, bits_j, wl):
    """The unpacked operands of the int8 library yardstick:
    ``int8[L * n_i, C]`` (row ``l * n_i + i`` is bit_i times limb l) and
    ``int8[C, n_j]``."""
    a_i = bm.unpack_bits_to_int8(bits_i.transpose(1, 2))  # [NB, block, n_i]
    a_j = bm.unpack_bits_to_int8(bits_j.transpose(1, 2))
    w = wl.transpose(1, 2)  # [NB, block, L]
    n_i, n_limbs = a_i.shape[2], wl.shape[1]
    colors = a_i.shape[0] * a_i.shape[1]
    lhs = torch.empty((n_limbs, n_i, colors), dtype=torch.int8, device=bits_i.device)
    flat_i = a_i.reshape(colors, n_i)
    for l in range(n_limbs):
        lhs[l] = (flat_i * w[..., l].reshape(colors, 1)).T
    return lhs.reshape(n_limbs * n_i, colors), a_j.reshape(colors, -1).contiguous()


def random_inputs(rng, npad_i, npad_j, nb, n_limbs, block, device, same=False):
    """Random packed bits and limbs (limbs in [0, 127]) on ``device``: the
    i side, the j side (unless ``same``), then the limbs, in that order."""
    def side(n):
        return torch.from_numpy(rng.integers(0, 256, (nb, n // 8, block),
                                             dtype=np.uint8)).to(device)
    bits_i = side(npad_i)
    bits_j = bits_i if same else side(npad_j)
    wl = torch.from_numpy(rng.integers(0, 128, (nb, n_limbs, block),
                                       dtype=np.int8)).to(device)
    return bits_i, bits_j, wl


def ragged_inputs(shape, rng, device):
    """(bits_i, bits_j, wl) of one ``RAGGED`` shape, drawn from ``rng``."""
    nb, npad_i, npad_j, block, n_limbs = shape
    return random_inputs(rng, npad_i, npad_j, nb, n_limbs, block, device)


def mode_tiles(mode, bits_i, bits_j, rng):
    """(bits_i, bits_j, tile_i, tile_j) of one ``MODES`` launch on the i and
    j sides' packed bits; "list" draws its order from ``rng``."""
    nti, ntj = 8 * bits_i.shape[1] // cp.TILE, 8 * bits_j.shape[1] // cp.TILE
    if mode == "square":
        return (bits_i, bits_i, *cp.all_tiles(nti, nti))
    if mode == "upper":
        return (bits_i, bits_i, *cp.upper_triangle_tiles(nti))
    ti, tj = cp.all_tiles(nti, ntj)
    if mode == "list":
        order = rng.permutation(len(ti))
        ti, tj = ti[order], tj[order]
    return bits_i, bits_j, ti, tj


def max_err(bits_i, bits_j, wl, ti, tj, compute_dtype=torch.int8):
    """max |kernel - plain| over ``out``, both from the same random start
    (the kernel accumulates in place); one kernel launch."""
    shape = (wl.shape[1], 8 * bits_i.shape[1], 8 * bits_j.shape[1])
    start = torch.randint(-1000, 1000, shape, dtype=torch.int32,
                          device=bits_i.device)
    got = cp.cooccurrence_tiles(bits_i, bits_j, wl, ti, tj, tile=cp.TILE,
                                out=start.clone(), compute_dtype=compute_dtype)
    want = cp.cooccurrence_tiles_plain(bits_i, bits_j, wl, ti, tj, tile=cp.TILE,
                                       out=start, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    err = int(diff.max()) if diff.numel() else 0
    if err:
        bad = torch.nonzero(diff)
        print(f"    {len(bad)} of {diff.numel()} entries differ; first "
              f"(l, i, j): {bad[:6].tolist()}; rows mod 128 hit: "
              f"{sorted(set((bad[:, 1] % 128).tolist()))[:20]}; cols mod 128 "
              f"hit: {sorted(set((bad[:, 2] % 128).tolist()))[:20]}", flush=True)
    return err


def library_call(lhs, rhs, compute_dtype):
    """(name, call) of the library product that computes the form's
    function on ``int_mm_operands``: ``torch._int_mm`` for int8, a
    ``torch.mm`` of the operands cast to bf16 into float32 for bf16."""
    if compute_dtype == torch.int8:
        return "torch._int_mm", lambda: torch._int_mm(lhs, rhs)
    lhs, rhs = lhs.to(torch.bfloat16), rhs.to(torch.bfloat16)
    return ("torch.mm bf16 -> float32",
            lambda: torch.mm(lhs, rhs, out_dtype=torch.float32))


def measure(bits_i, bits_j, wl, ti, tj, reps, *, compute_dtype=torch.int8,
            plain_reps=1):
    """Kernel against plain at one shape and form: a dict of max_abs_err,
    ms, plain_ms (None when ``plain_reps`` is 0), bound_ms, bound_by,
    library_ms and library (the name of the timed call)."""
    shape = (wl.shape[1], 8 * bits_i.shape[1], 8 * bits_j.shape[1])
    err = max_err(bits_i, bits_j, wl, ti, tj, compute_dtype)

    def run(fn):
        out = torch.zeros(shape, dtype=torch.int32, device=bits_i.device)
        fn(bits_i, bits_j, wl, ti, tj, tile=cp.TILE, out=out,
           compute_dtype=compute_dtype)

    ms = cuda_ms(lambda: run(cp.cooccurrence_tiles), reps)
    plain_ms = cuda_ms(lambda: run(cp.cooccurrence_tiles_plain), plain_reps) \
        if plain_reps else None
    bound_ms, bound_by = bound(
        gram_ops(len(ti), bits_i.shape[0] * bits_i.shape[2], shape[0]),
        gram_bytes(bits_i, bits_j, wl, shape),
        INT8_OPS_PER_S if compute_dtype == torch.int8 else BF16_OPS_PER_S)
    library, call = library_call(*int_mm_operands(bits_i, bits_j, wl),
                                 compute_dtype)
    library_ms = cuda_ms(call, reps)
    del call
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, library=library)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


FORMS = {"int8": (torch.int8,), "bf16": (torch.bfloat16,),
         "both": (torch.int8, torch.bfloat16)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=sorted(FORMS), default="both",
                    help="the kernel forms to check and time")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-plain", action="store_true",
                    help="skip the plain version's times (slow at full size)")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    errs, rows = [], []
    for dtype in FORMS[args.form]:
        form = str(dtype)[6:]
        rng = np.random.default_rng(args.seed)
        for shape in RAGGED:
            bi, bj, wl = ragged_inputs(shape, rng, dev)
            for mode in MODES:
                mi, mj, ti, tj = mode_tiles(mode, bi, bj, rng)
                errs.append(max_err(mi, mj, wl, ti, tj, dtype))
                print(f"  [{form}] ragged {mode} NB={shape[0]} "
                      f"npad={shape[1]}x{shape[2]} block={shape[3]} "
                      f"L={shape[4]}: max_abs_err={errs[-1]}", flush=True)
        for label, mode, npad_i, npad_j, nb, n_limbs in SHAPES:
            bi, bj, wl = random_inputs(rng, npad_i, npad_j, nb, n_limbs, BLOCK,
                                       dev, same=mode in ("upper", "square"))
            bi, bj, ti, tj = mode_tiles(mode, bi, bj, rng)
            r = measure(bi, bj, wl, ti, tj, args.reps, compute_dtype=dtype,
                        plain_reps=0 if args.no_plain else 1)
            row = dict(form=form, shape=label, mode=mode, tiles=len(ti), **r,
                       share=r["bound_ms"] / r["ms"])
            rows.append(row)
            print(f"  {label}: {json.dumps(row)}", flush=True)
            del bi, bj, wl
            torch.cuda.empty_cache()
    ok = not any(errs) and all(r["max_abs_err"] == 0 for r in rows)
    print(json.dumps({"ok": ok, "shapes": rows}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
