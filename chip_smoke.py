"""Smoke run of kspider_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed S] [--families F] [--workdir DIR]

Phases, each printed on its own line; any failure exits non-zero:

1. device: card name, card count, ``nvidia-smi`` name and power limit;
2. build: compiles the Gram kernel from ``kspider_tpu_torch/csrc`` with nvcc;
3. kernel vs plain: every launch mode of the kernel (all tiles of a
   square, all tiles of a rectangle with distinct sides, upper tiles) at
   the main path's shapes and at small ragged ones, bit-exact int32 against
   the plain float64 torch version, each timed with CUDA events;
4. main path: a synthetic genus-scale index (F families of 8 samples,
   sourmash scaled=1000 sketch sizes) through the port's CLI ``pairwise``
   and ``cluster -c 0.2`` in-process.  The pairwise TSV must equal,
   byte for byte, the TSV of the OpenMP host engine on the same CSR; the
   clusters must equal scipy's and recover the families; the kernel must
   have launched; jax must never have been imported.

The line before the last is a JSON object describing the kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits 1 and prints no result.
"""

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "kspider_tpu/ops/pallas_pairwise.py:354"
ALSO_REPLACES = [
    "kspider_tpu/ops/pallas_pairwise.py:79",
    "kspider_tpu/ops/pallas_pairwise.py:137",
    "kspider_tpu/ops/pallas_pairwise.py:235",
]
MEMBERS_PER_FAMILY = 8
CUTOFF = 0.2


def phase(name, ok, detail=""):
    print(f"[phase] {name}: {'PASS' if ok else 'FAIL'} {detail}".rstrip(), flush=True)
    if not ok:
        sys.exit(1)


def make_hash_sets(rng, n_families):
    """Synthetic sketches: families of 8 samples around a private core.

    Each family draws a core of 4,500-6,500 hashes; each member keeps
    60-95% of it and adds 800-1,800 hashes of its own, so a sample holds
    3,500-8,000 hashes (a sourmash scaled=1000 sketch of a 3.5-8 Mbp
    genome).  2,000 cross-family hashes each sit in 16-64 random samples.
    Within a family the max-containment is about 0.4 or more; across families it is
    a few hashes in thousands, so families separate at 0.2."""
    n = n_families * MEMBERS_PER_FAMILY
    core_sizes = rng.integers(4500, 6501, n_families)
    own_sizes = rng.integers(800, 1801, n)
    n_cross = 2000
    need = int(core_sizes.sum() + own_sizes.sum()) + n_cross
    universe = np.unique(rng.integers(1, 2**63, size=need + need // 50,
                                      dtype=np.int64).astype(np.uint64))
    rng.shuffle(universe)
    cross = universe[:n_cross]
    cross_deg = rng.integers(16, 65, n_cross)
    cross_samples = np.concatenate(
        [rng.choice(n, size=d, replace=False) for d in cross_deg])
    cross_hashes = np.repeat(cross, cross_deg)
    order = np.argsort(cross_samples, kind="stable")
    cross_samples, cross_hashes = cross_samples[order], cross_hashes[order]
    cross_bounds = np.searchsorted(cross_samples, np.arange(n + 1))

    cursor = n_cross
    names, arrays = [], []
    for f in range(n_families):
        core = universe[cursor : cursor + core_sizes[f]]
        cursor += core_sizes[f]
        for i in range(MEMBERS_PER_FAMILY):
            g = f * MEMBERS_PER_FAMILY + i
            kept = core[rng.random(len(core)) < rng.uniform(0.6, 0.95)]
            own = universe[cursor : cursor + own_sizes[g]]
            cursor += own_sizes[g]
            mine = cross_hashes[cross_bounds[g] : cross_bounds[g + 1]]
            names.append(f"f{f:04d}_s{i}")
            arrays.append(np.sort(np.concatenate([kept, own, mine])))
    return names, arrays


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_mode(cp, label, bits_i, bits_j, wl, ti, tj, npad_i, npad_j, reps):
    """Kernel vs plain on one launch mode; returns (max_abs_err, ms, plain_ms)."""
    n_limbs = wl.shape[1]
    dev = bits_i.device

    def run(fn):
        out = torch.zeros((n_limbs, npad_i, npad_j), dtype=torch.int32, device=dev)
        fn(bits_i, bits_j, wl, ti, tj, tile=cp.TILE, out=out)
        return out

    out_k = run(cp.cooccurrence_tiles)
    out_p = run(cp.cooccurrence_tiles_plain)
    torch.cuda.synchronize()
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    del out_k, out_p
    ms = cuda_ms(lambda: run(cp.cooccurrence_tiles), reps)
    plain_ms = cuda_ms(lambda: run(cp.cooccurrence_tiles_plain), max(1, reps // 5))
    print(f"  {label}: NB={bits_i.shape[0]} npad={npad_i}x{npad_j} "
          f"block={bits_i.shape[2]} L={n_limbs} pairs={len(ti)} "
          f"max_abs_err={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
          flush=True)
    return err, ms, plain_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--families", type=int, default=1024,
                    help="families of 8 samples (N = 8 x families)")
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".smoke"))
    args = ap.parse_args()

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from kspider_tpu_torch.ops import _build
    from kspider_tpu_torch.ops import cuda_pairwise as cp

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", True, f"{kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    phase("build", True, f"{time.perf_counter() - t0:.3f} s "
          f"({os.path.basename(_build.library_path())})")

    # ---- set-up: synthetic index ----------------------------------------
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import artifacts, native
    from kspider_tpu_torch.core import cluster as core_cluster
    from kspider_tpu_torch.core import pairwise as core_pairwise
    from kspider_tpu_torch.ops import pairwise as pw

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    names, arrays = make_hash_sets(rng, args.families)
    index = build_index_from_hash_sets(names, arrays, ksize=21,
                                       params="kSize:21")
    del arrays
    prefix = os.path.join(args.workdir, "smoke")
    artifacts.write_index_artifacts(prefix, index)
    n = index.num_groups
    deg = index.color_degrees()
    multi = deg >= 2
    w_multi = index.color_counts[multi]
    n_limbs = pw.weight_limbs(w_multi).shape[1]
    print(f"[setup] N={n} colors={index.num_colors} non-singleton={int(multi.sum())} "
          f"postings={len(index.color_members)} limbs={n_limbs} "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 3. kernel vs plain ---------------------------------------------
    # the main path's first chunk: CHUNK_BLOCKS blocks of non-singleton colors
    keep = np.flatnonzero(multi)[: cp.CHUNK_BLOCKS * cp.BLOCK]
    offs = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(deg[keep], out=offs[1:])
    mem = np.concatenate([index.color_members[index.color_offsets[c]:
                                               index.color_offsets[c + 1]]
                          for c in keep])
    n_pad = pw._round_up(n, cp.TILE)
    t0 = time.perf_counter()
    bits_np, wl_np = cp.pack_inputs(
        offs, mem, pw.weight_limbs(w_multi)[: len(keep)], n_pad, cp.BLOCK)
    print(f"[setup] host pack of one {len(keep)}-color chunk: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    bits = torch.from_numpy(bits_np).to(dev)
    wl = torch.from_numpy(wl_np).to(dev)
    half = n_pad // 16  # rect: samples [0, n_pad/2) against [n_pad/2, n_pad)
    bits_a = bits[:, :half].contiguous()
    bits_b = bits[:, half:].contiguous()
    nt = n_pad // cp.TILE
    results = []
    modes = [
        ("upper tiles (main path)", bits, bits, wl, *cp.upper_triangle_tiles(nt), n_pad, n_pad, 5),
        ("all tiles, square", bits, bits, wl, *cp.all_tiles(nt, nt), n_pad, n_pad, 5),
        ("all tiles, rect", bits_a, bits_b, wl, *cp.all_tiles(nt // 2, nt - nt // 2),
         8 * half, n_pad - 8 * half, 5),
    ]
    for nb, npad_i, npad_j, block, L in [(1, 128, 128, 128, 1), (1, 256, 384, 128, 2),
                                         (1, 384, 384, 1024, 3), (3, 640, 256, 256, 2)]:
        bi = torch.from_numpy(rng.integers(0, 256, (nb, npad_i // 8, block), dtype=np.uint8)).to(dev)
        bj = torch.from_numpy(rng.integers(0, 256, (nb, npad_j // 8, block), dtype=np.uint8)).to(dev)
        w = torch.from_numpy(rng.integers(0, 128, (nb, L, block), dtype=np.int8)).to(dev)
        ti_, tj_ = npad_i // 128, npad_j // 128
        modes.append((f"all tiles, rect, small", bi, bj, w, *cp.all_tiles(ti_, tj_), npad_i, npad_j, 20))
        modes.append((f"all tiles, square, small", bi, bi, w, *cp.all_tiles(ti_, ti_), npad_i, npad_i, 20))
        modes.append((f"upper tiles, small", bi, bi, w, *cp.upper_triangle_tiles(ti_), npad_i, npad_i, 20))
    for label, *rest in modes:
        results.append(compare_mode(cp, label, *rest))
    max_err = max(r[0] for r in results)
    main_ms, main_plain_ms = results[0][1], results[0][2]
    del bits, wl, bits_a, bits_b
    torch.cuda.empty_cache()
    phase("kernel vs plain", max_err == 0,
          f"{len(results)} cases, max_abs_err={max_err} (exact int32 required)")

    # ---- 4. main path ---------------------------------------------------
    from kspider_tpu_torch.cli.main import cli

    cp.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["pairwise", "-i", prefix, "--device", "cuda"], standalone_mode=False)
    torch.cuda.synchronize()
    pairwise_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["cluster", "-i", prefix, "-c", str(CUTOFF), "--device", "cuda"],
             standalone_mode=False)
    cluster_s = time.perf_counter() - t0
    launches = cp.LAUNCHES
    print(f"[main] pairwise stage {pairwise_s:.3f} s, cluster stage "
          f"{cluster_s:.3f} s, kernel launches {launches}", flush=True)
    phase("kernel launched on the main path", launches > 0, f"LAUNCHES={launches}")

    # kernel time of the pairwise stage's Gram product, from a profiled rerun
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pw.shared_kmer_matrix(index.color_offsets, index.color_members,
                              index.color_counts, n, device=dev)
        torch.cuda.synchronize()
    kernel_ms = sum(
        getattr(e, "device_time_total", 0) for e in prof.key_averages()
        if "gram_int8" in e.key) / 1000.0
    print(f"[main] Gram kernel time in one pairwise product: "
          f"{f'{kernel_ms:.3f} ms' if kernel_ms > 0 else 'not measured'}",
          flush=True)

    ref_prefix = os.path.join(args.workdir, "ref")
    t0 = time.perf_counter()
    if native.available():
        ref_engine = "native OpenMP host engine"
        ref = native.shared_kmer_matrix(index.color_offsets, index.color_members,
                                        index.color_counts, n)
    else:
        ref_engine = "numpy host reference (native library unavailable)"
        ref = pw.shared_kmer_matrix_numpy(index.color_offsets, index.color_members,
                                          index.color_counts, n)
    core_pairwise.write_pairwise_tsv(ref_prefix, index, ref)
    del ref
    rows = sum(1 for _ in open(prefix + "_kSpider_pairwise.tsv")) - 1
    same = filecmp.cmp(prefix + "_kSpider_pairwise.tsv",
                       ref_prefix + "_kSpider_pairwise.tsv", shallow=False)
    phase("pairwise TSV == host engine", same,
          f"{rows} rows, reference: {ref_engine} ({time.perf_counter() - t0:.3f} s)")

    shutil.copy(prefix + ".namesMap", ref_prefix + ".namesMap")
    out = prefix + f"_kSpider_clusters_{CUTOFF * 100.0}%.tsv"
    ref_out = core_cluster.cluster_index(ref_prefix, CUTOFF, device=None)
    phase("clusters == scipy", filecmp.cmp(out, ref_out, shallow=False))
    with open(out) as f:
        clusters = [line.strip().split(",") for line in f if line.strip()]
    families_ok = len(clusters) == args.families and all(
        len(c) == MEMBERS_PER_FAMILY and len({s.split("_")[0] for s in c}) == 1
        for c in clusters)
    phase("clusters recover the families", families_ok,
          f"{len(clusters)} clusters for {args.families} families")
    phase("no jax", "jax" not in sys.modules)
    shutil.rmtree(args.workdir, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "gram_int8_tiles",
        "route": "cuda",
        "source": "kspider_tpu_torch/csrc/gram_int8.cu",
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
