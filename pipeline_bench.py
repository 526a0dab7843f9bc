"""The pairwise engines' pipelines on one CUDA card, for comparing two trees.

    python3 pipeline_bench.py make --families F --data DIR [--seed S]
    python3 pipeline_bench.py run --data DIR [--tree T] [--min-shared M]
                                  [--panel P] [--tsv PATH] [--no-stage]
    python3 pipeline_bench.py dense --data DIR [--tree T]

``make`` generates ``chip_smoke.make_hash_sets(F)`` (N = 8 F samples),
builds its index on the host and saves the color CSR and k-mer counts to
``DIR/csr.npz``, once for every tree measured.  ``run`` imports
``kspider_tpu_torch`` from ``--tree`` (default: this checkout, so a
parent commit unpacked into a directory can be run in turn with this one)
and measures, at panel P (default 4,096) after one warm-up pass:

1. the engine without the TSV (``iter_panel_pairs``, as the CLI runs it
   on one card) under ``torch.profiler``: its wall, the
   device's busy time (the union of kernels, copies and sets), the Gram
   kernel's device ms, and per pair the host waits
   (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
   ``cudaEventSynchronize``) inside ``kspider.dispatch`` and
   ``kspider.extract``, read with this checkout's
   ``utils.timing.host_waits``, the host ms in each range and the six CUDA
   runtime calls that took most of it; then the H2D bytes from pinned and from
   pageable memory and the H2D time under a Gram kernel;
2. the same engine pass unprofiled: its wall and its pack (overlapped),
   dispatch and extract seconds;
3. unless ``--no-stage``, the stage ``stream_pairwise_tsv`` (``--tsv``
   keeps its TSV): wall and the engine's stage breakdown.

``dense`` measures the dense engine (``shared_kmer_matrix_cuda``, as
``pairwise`` runs it up to 16,384 samples, with the tree's default device
pack policy) after one warm-up call: once under ``torch.profiler`` (the
construction's wall, the trace's window, busy and kernel ms, per chunk the
host waits and the host ms inside ``kspider.pack`` and ``kspider.gram``
with their top runtime calls, the H2D bytes from pinned and from pageable
memory and the H2D ms under a Gram kernel) and once unprofiled (its wall,
and the chunks by form and their H2D bytes where the tree counts them).

Prints one JSON line, ``{"tree": ..., "device": ..., ...}``.  Exits 1
without a CUDA card.  Every number is the card's, measured in this run.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RANGES = ("kspider.dispatch", "kspider.extract")
DENSE_RANGES = ("kspider.pack", "kspider.gram")


def _this_timing():
    """This checkout's ``utils/timing.py``, loaded by path, so the trace is
    read the same way whichever tree runs."""
    spec = importlib.util.spec_from_file_location(
        "_bench_timing", os.path.join(HERE, "kspider_tpu_torch", "utils",
                                      "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(args):
    sys.path.insert(0, HERE)
    import chip_smoke
    from kspider_tpu_torch.core.index import build_index_from_hash_sets

    t0 = time.perf_counter()
    names, arrays = chip_smoke.make_hash_sets(np.random.default_rng(args.seed),
                                              args.families)
    index = build_index_from_hash_sets(names, arrays, ksize=21,
                                       params="kSize:21", consume=True)
    os.makedirs(args.data, exist_ok=True)
    np.savez(os.path.join(args.data, "csr.npz"), offsets=index.color_offsets,
             members=index.color_members, weights=index.color_counts,
             kmer_counts=index.group_kmer_count, n=index.num_groups)
    print(json.dumps({"make": {"n": int(index.num_groups),
                               "colors": int(index.num_colors),
                               "postings": int(len(index.color_members)),
                               "s": time.perf_counter() - t0}}), flush=True)


class _Index:
    def __init__(self, data):
        self.color_offsets = data["offsets"]
        self.color_members = data["members"]
        self.color_counts = data["weights"]
        self.group_kmer_count = data["kmer_counts"]
        self.num_groups = int(data["n"])


def _trace_numbers(events, timing, ranges=RANGES):
    out = timing.pipeline_numbers(events, "gram_int8", ranges)
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime"]
    for name, per in out.pop("waits").items():
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == name]
        calls = {}
        for span in spans:
            lo, hi = span["ts"], span["ts"] + span["dur"]
            for c in runtime:
                if c.get("tid") == span.get("tid") and lo <= c["ts"] <= hi:
                    calls[c["name"]] = calls.get(c["name"], 0.0) + c["dur"] / 1000.0
        top = sorted(calls.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"ranges": len(per),
                     "host_ms": sum(e["dur"] for e in spans) / 1000.0,
                     "runtime_ms": {k: round(v, 3) for k, v in top}}
        for call in timing.HOST_WAITS:
            counts = [w[call] for w in per]
            out[name][call] = {"total": sum(counts),
                               "per_pair": [min(counts, default=0),
                                            max(counts, default=0)]}
    return out


def _setup(args):
    """Imports the port from ``--tree`` and loads the CSR: (torch, the
    card, nvidia-smi's name and power limit, the index)."""
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    import kspider_tpu_torch
    from kspider_tpu_torch.ops import _build

    if not os.path.abspath(kspider_tpu_torch.__file__).startswith(tree):
        sys.exit(f"kspider_tpu_torch imported from {kspider_tpu_torch.__file__}, "
                 f"not from {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    with np.load(os.path.join(args.data, "csr.npz")) as data:
        index = _Index({k: data[k] for k in data.files})
    return torch, torch.device("cuda", 0), smi, index


def _profiled(torch, fn, data_dir):
    """``fn()`` under torch.profiler: (its result, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    path = os.path.join(data_dir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return out, events


def dense(args):
    timing = _this_timing()
    torch, dev, smi, index = _setup(args)
    from kspider_tpu_torch.ops import cuda_pairwise as cp

    def construct():
        t0 = time.perf_counter()
        cp.shared_kmer_matrix_cuda(index.color_offsets, index.color_members,
                                   index.color_counts, index.num_groups,
                                   device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0

    construct()  # warm-up: tile lists, pinned memory, allocator
    profiled_ms, events = _profiled(torch, construct, args.data)
    spans = [e for e in events if e.get("ph") == "X"]
    numbers = _trace_numbers(events, timing, DENSE_RANGES)
    numbers.update(
        wall_ms=profiled_ms,
        window_ms=(max(e["ts"] + e["dur"] for e in spans)
                   - min(e["ts"] for e in spans)) / 1000.0)
    chunks = getattr(cp, "DENSE_CHUNKS", None)
    if chunks is not None:
        cp.DENSE_H2D_BYTES = 0
        for key in chunks:
            chunks[key] = 0
    result = {
        "tree": args.tree, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "torch": torch.__version__,
        "n": index.num_groups, "colors": len(index.color_counts),
        "chunk_blocks": cp.CHUNK_BLOCKS, "block": cp.BLOCK,
        "dense_profiled": numbers,
        "dense_wall_ms": construct(),
    }
    if chunks is not None:
        result["chunks"] = dict(chunks, h2d_bytes=cp.DENSE_H2D_BYTES)
    print(json.dumps(result), flush=True)


def run(args):
    timing = _this_timing()
    torch, dev, smi, index = _setup(args)
    from kspider_tpu_torch.ops import tiled_pairwise as ttp

    t0 = time.perf_counter()
    plan = ttp.build_panel_plan(index.color_offsets, index.color_members,
                                index.color_counts, index.num_groups, args.panel)
    plan_s = time.perf_counter() - t0

    def engine(stats=None):
        t0 = time.perf_counter()
        rows = 0
        for _, _, gi, _, _ in ttp.iter_panel_pairs(
                plan, device=dev, min_shared=args.min_shared, stats=stats):
            rows += len(gi)
        torch.cuda.synchronize()
        return rows, (time.perf_counter() - t0) * 1000.0

    engine()  # warm-up: tile lists, pinned pages, allocator
    (rows, profiled_ms), events = _profiled(torch, engine, args.data)
    result = {
        "tree": args.tree, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "torch": torch.__version__,
        "n": index.num_groups, "panel": args.panel,
        "min_shared": args.min_shared, "pairs": int(len(plan.pair_keys)),
        "rows": rows, "plan_s": plan_s,
        "engine_profiled": dict(_trace_numbers(events, timing),
                                wall_ms=profiled_ms),
    }
    stats = {}
    result["engine_wall_ms"] = engine(stats)[1]
    result["engine_stages_s"] = {k: stats[k] for k in ("t_pack", "t_dispatch",
                                                      "t_extract")}
    if not args.no_stage:
        prefix = os.path.join(args.data, f"stage.{os.getpid()}")
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_rows = ttp.stream_pairwise_tsv(
            index, prefix, device=dev, panel=args.panel,
            min_shared=args.min_shared, stats=stats)
        torch.cuda.synchronize()
        result["stage"] = dict(
            wall_s=time.perf_counter() - t0, rows=n_rows,
            **{k: stats[k] for k in ("t_pack", "t_dispatch", "t_extract",
                                     "t_tsv", "bits_bytes", "keys_bytes")})
        tsv = prefix + "_kSpider_pairwise.tsv"
        if args.tsv:
            os.replace(tsv, args.tsv)
        else:
            os.remove(tsv)
    print(json.dumps(result), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("--families", type=int, default=4096)
    mk.add_argument("--seed", type=int, default=20261016)
    mk.add_argument("--data", required=True)
    rn = sub.add_parser("run")
    rn.add_argument("--data", required=True)
    rn.add_argument("--tree", default=HERE)
    rn.add_argument("--panel", type=int, default=4096)
    rn.add_argument("--min-shared", type=int, default=1)
    rn.add_argument("--tsv")
    rn.add_argument("--no-stage", action="store_true")
    dn = sub.add_parser("dense")
    dn.add_argument("--data", required=True)
    dn.add_argument("--tree", default=HERE)
    args = ap.parse_args()
    {"make": make, "run": run, "dense": dense}[args.cmd](args)


if __name__ == "__main__":
    main()
