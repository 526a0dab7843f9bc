"""The control of the comparison that decides ``correct``.

    python3 gpubench/control.py --workload NAME --seed N [--seed N ...]

The plain reference is put in the program's place and computed one step
below each precision that the configuration states:

- ``int4``: the Gram product's operands, int8 in the configuration (each
  color's count split into base-128 limbs), held in int4 at the same
  number of limbs, so each limb saturates at 7;
- ``bf16``: the containment, float32 in the configuration, in bfloat16
  (its inputs rounded to bfloat16, each result rounded to bfloat16).

The control is both steps together; each step alone is read beside it.
For each seed it draws the cell's collection,
writes the files that the cell's commands would write, and judges them with
``check.py`` as a run judges the program's: one JSON line per seed with
each reading beside its limit.  The control has to come out not correct.
It needs no card; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import check, datagen, roofline  # noqa: E402
from gpubench import reference as ref  # noqa: E402
from gpubench import run  # noqa: E402


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32)


def int4_weights(counts: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Each color's count as the Gram product sees it with its base-128
    limbs held in int4 (saturating at 7), at the limb count of the colors
    of two or more genomes."""
    multi = np.diff(offsets) >= 2
    n_limbs = roofline.limbs(counts[multi])
    rest, out = counts.astype(np.int64), np.zeros(len(counts), np.int64)
    for limb in range(n_limbs):
        out += np.minimum(rest % 128, 7) * 128 ** limb
        rest //= 128
    return out


def containment_bf16(shared, k_i, k_j):
    s, ki, kj = to_bf16(shared), to_bf16(k_i), to_bf16(k_j)
    c_ij, c_ji = to_bf16(s / kj), to_bf16(s / ki)
    return (np.minimum(c_ij, c_ji), to_bf16((c_ij + c_ji) / np.float32(2)),
            np.maximum(c_ij, c_ji))


#: the control's steps, and each step alone
STEPS = {"control": ("int4", "bf16"), "int4": ("int4",), "bf16": ("bf16",)}


def write_control(exp: check.Expected, stages, prefix: str,
                  steps=STEPS["control"]) -> None:
    """The files of ``stages`` as the control computes them."""
    col, k = exp.col, exp.col.kmer_counts
    p = exp.pairs
    if "int4" in steps:
        p = ref.pairs(col.offsets, col.members,
                      int4_weights(col.counts, col.offsets), col.n)
    divide = containment_bf16 if "bf16" in steps else ref.containment
    cont = dict(zip(ref.DISTANCES, divide(p.shared, k[p.i], k[p.j])))
    pairwise_options = None
    for stage in stages:
        command, options = stage["command"], stage.get("options", {})
        if command == "pairwise":
            pairwise_options = options
            with open(check.seq_path(prefix), "w") as f:
                f.write("\n".join(exp.seq_lines()) + "\n")
            sel = p.shared >= check.min_shared_of(options)
            rows = np.column_stack([p.i[sel] + 1, p.j[sel] + 1, p.shared[sel]]
                                   + [cont[d][sel] for d in ref.DISTANCES])
            with open(check.pairwise_path(prefix), "w") as f:
                f.write(check.PAIRWISE_HEADER + "\n")
                np.savetxt(f, rows, fmt="%d\t%d\t%d\t%.6g\t%.6g\t%.6g")
        elif command == "cluster":
            from_index = bool(options.get("--from-index", False))
            source = options if from_index else pairwise_options
            dist = options.get("--dist-type", check.DEFAULT_DIST)
            cutoff = float(options.get("--cutoff", check.DEFAULT_CUTOFF))
            sel = p.shared >= check.min_shared_of(source)
            d = cont[dist][sel]
            keep = (d.astype(np.float64) * 100.0 >= cutoff * 100.0 if from_index
                    else ref.above_cutoff_printed(d, cutoff))
            labels = ref.components(col.n, p.i[sel][keep], p.j[sel][keep])
            with open(check.clusters_path(prefix, cutoff), "w") as f:
                for comp in sorted(ref.partition(labels), key=min):
                    f.write(",".join(col.names[g] for g in sorted(comp)) + "\n")
        else:
            raise ValueError(f"no control for the command {command!r}")


def readings(workload: str, seed: int, root: str = ROOT,
             steps=STEPS["control"]) -> dict:
    _, config, mix = run.cell(run.load_benchmark(root), workload, root)
    exp = check.Expected(datagen.generate(config, run.seed_rng_key(seed)))
    with tempfile.TemporaryDirectory(prefix="gpubench.control.") as work:
        prefix = os.path.join(work, "derep")
        write_control(exp, mix["stages"], prefix, steps)
        found = check.judge(prefix, exp, mix["stages"])
    return {"workload": workload, "seed": seed, "steps": list(steps),
            "correct": all(r.ok for r in found),
            "checks": {r.name: {"value": r.value, "limit": r.limit}
                       for r in found}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        for steps in STEPS.values():
            print(json.dumps(readings(args.workload, seed, steps=steps)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
