"""Smoke run of kspider_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed S] [--families F] [--tiled-families T]
                          [--workdir DIR]

Phases, each printed on its own line; any failure exits non-zero:

1. device: card name, card count, ``nvidia-smi`` name and power limit;
2. build: compiles the Gram kernel from ``kspider_tpu_torch/csrc`` with nvcc;
3. kernel vs plain: every launch mode of the kernel (all tiles of a
   square, all tiles of a rectangle with distinct sides, upper tiles, and a
   shuffled list of tiles) at the dense path's shapes and at
   ``gram_bench.RAGGED``'s small ragged ones (L = 1-4, each in every mode
   of ``gram_bench.MODES``), in both forms (int8 ``csrc/gram_int8.cu``,
   bf16 ``csrc/gram_bf16.cu``), bit-exact int32 against the plain torch
   version of each form.  Each case prints ``gram_bench.measure``'s
   numbers: the kernel's ms and the plain version's (CUDA events), its
   bound ms (operations over the tensor peak of the form, or bytes over
   the memory rate, whichever is larger) and the ms of the form's library
   yardstick on the unpacked operands, timed here and never called by the
   port: one ``torch._int_mm`` for int8, one bf16 ``torch.mm`` into float32
   for bf16 (``gram_bench.library_call``).  The phase prints its own time,
   split into the path's shapes and the ragged ones per form;
4. dense path: a synthetic genus-scale index (F families of 8 samples,
   sourmash scaled=1000 sketch sizes) through the port's CLI ``pairwise``
   and ``cluster -c 0.2`` in-process.  The pairwise TSV must equal, byte
   for byte, the TSV of the OpenMP host engine on the same CSR; the
   clusters must equal scipy's and recover the families.  The dense
   engine's chunks by form (posting keys packed on the card, or host
   bitmasks; ``cuda_pairwise.DENSE_CHUNKS``) and their H2D bytes are
   printed, and at least one chunk must cross as posting keys (the
   default policy, auto, as kspider_tpu's);
4b. tiled path on the same index: ``pairwise --engine tiled --panel 2048
   --device-pack force`` (4 panels, 10 pairs); its TSV must equal the dense
   one and the kernel must have run in both modes (upper tiles for
   diagonal panel pairs, all tiles for off-diagonal ones);
4c. the bf16 form on the same index: ``shared_kmer_matrix_cuda(
   compute_dtype=torch.bfloat16)`` must launch the bf16 kernel and equal
   the int8 matrix;
4d. the fused single-device step over all non-singleton colors of the
   same index (blocks of 1,024 in kspider_tpu's layout): ``shared`` must
   equal the dense engine's matrix, ``labels`` scipy's CC of the same
   thresholded adjacency;
4e. ``pairwise --engine scatter`` (postings scatter + ``torch._int_mm``),
   ``--engine pallas`` and ``--engine bitmask``: each TSV must equal the
   dense one, and pallas and bitmask must launch the kernel; pallas must
   ship posting keys, and bitmask must pack every chunk on the host, as
   kspider_tpu's bitmask engine does;
4f. the same collection written as .bin files and indexed by the CLI with
   and without ``--device-build --device cuda``: all five artifacts must
   be byte-equal.  Then the device index build in-process
   (``build_index_device``) on the same hash sets, whose every ColorIndex
   field must equal the host build's (the ``[device build N=8192]`` line);
   the device build of the N = 32,768 hash sets is no longer run;
4g-4j. several devices and several processes on the same index, with DEVS
   the card list (``cuda:0,cuda:1,...``), or ``cuda:0,cuda:0`` (two shards
   on one card) on a one-card machine: 4g ``pairwise --device DEVS`` (the
   sharded dense engine), 4h ``sharded_step`` on the blocks of 4d, 4i
   ``pairwise --engine tiled --device DEVS`` with panels of 2,048 (pairs
   round-robin over the devices) and 8,192 (one pair, its color blocks
   split), 4j two coordinated worker processes merging over gloo, each on
   its own card or both on cuda:0: the CLI's color-slice and panel-row runs
   and ``distributed_pairwise_from_hash_sets`` on the hash sets saved to an
   .npz (every color-slice rank must ship posting keys).  Every TSV must equal the dense one, step outputs the fused
   step's, every shard and every rank must launch the kernel, and no part
   file may remain.  The per-shard kernel time is ``gram_bench``'s NB 97
   shape, not timed here;
4k. the profiled dense stage: ``pairwise --device cuda`` again, in a
   fresh process, with ``KSPIDER_PROFILE`` set.  Exactly one
   ``*.pt.trace.json`` must be written and parse, hold one
   ``gram_int8_wgmma_kernel`` event per launch counted and the dense
   engine's ``kspider.*`` ranges; the TSV must equal the unprofiled one.
   The child reports its chunk counters, and its trace is read by
   ``pipeline_report`` over ``kspider.pack`` and ``kspider.gram``: a
   ``cudaStreamSynchronize`` or ``cudaDeviceSynchronize`` inside either,
   or any pageable H2D copy, fails the phase.  Prints the stage wall and
   the construction beside phase 4's, the H2D bytes and ms, the host ms
   in each range, the trace's bytes and the kernel's device ms in the
   trace beside the ``torch.profiler`` ms of phase 4's matrix product;
5. tiled path at full width: a second index of T families (N = 8 T, above
   the dense engine's 16,384).  ``pairwise`` with no engine flag (the
   automatic switch to the panel-streamed engine), ``cluster -c 0.2`` and
   ``cluster --from-index -c 0.2``.  The kernel is first held against its
   plain version, in both forms, on the path's own first diagonal and
   off-diagonal chunks.  The TSV must equal the OpenMP host engine's, both
   cluster outputs must equal scipy's and recover the families, and the
   kernel must have run in both modes.  The engine is then rerun without
   the TSV under ``torch.profiler`` in a fresh process
   (``gram_time_by_mode``): kernel ms by
   mode, the device's busy time and idle share, and the pipeline
   (``pipeline_report``): per pair the host waits
   (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
   ``cudaEventSynchronize``) inside ``kspider.dispatch`` and
   ``kspider.extract``, the H2D bytes from pinned and from pageable memory
   and the H2D time under a Gram kernel; a stream or device drain in either
   range, or a pageable H2D copy, fails the phase.  5b: the same
   ``pairwise`` under ``KSPIDER_PROFILE`` (where kspider_tpu's nested
   traces raise), checked as in 4k with launches in both modes and the
   tiled engine's ranges, and its trace read by ``pipeline_report`` (a
   drain fails the phase); its kernel ms is printed beside the engine
   rerun's.

Every path-level kernel time is the device's own, from ``torch.profiler``:
CUDA events around a launch also bracket the host's launch path whenever
the device waits for the host.  Phases 4k, 5's rerun and 5b profile in a
fresh process each (``run_child``): in this long process a later
profiler session lost the records of the first part of its run.  Phase 3
times each case over many back-to-back launches with CUDA events
(``gram_bench.measure``).

Neither jax nor kspider_tpu may have been imported.  Launch counts are
reset to 0 right before each path and read right after it.  The line
before the last is a JSON object describing the kernel's two forms (time,
plain time, bound and library time at the path's shapes, launches per
path); its ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are those
of the tiled off-diagonal pair, and ``by_shape`` holds every path shape's.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
card the script exits 1 and prints no result.
"""

import argparse
import contextlib
import filecmp
import glob
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "kspider_tpu/ops/pallas_pairwise.py:137"
ALSO_REPLACES = [
    "kspider_tpu/ops/pallas_pairwise.py:79",
    "kspider_tpu/ops/pallas_pairwise.py:235",
    "kspider_tpu/ops/pallas_pairwise.py:354",
]
MEMBERS_PER_FAMILY = 8
CUTOFF = 0.2
CLUSTERS_SUFFIX = f"_kSpider_clusters_{CUTOFF * 100.0}%.tsv"
ARTIFACTS = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
             "_color_count.bin", ".namesMap", ".extra")
#: the ``kspider.*`` ranges each engine opens on the stage's own thread;
#: the tiled engine's ``kspider.pack`` is opened on its pack thread, and
#: is reported, not required
DENSE_RANGES = ("kspider.pack", "kspider.gram", "kspider.recombine")
TILED_RANGES = ("kspider.dispatch", "kspider.extract", "kspider.tsv")
#: each form's kernel name in torch.profiler, its source and its tensor peak
FORMS = {
    torch.int8: ("gram_int8_wgmma_kernel", "kspider_tpu_torch/csrc/gram_int8.cu"),
    torch.bfloat16: ("gram_bf16_wgmma_kernel", "kspider_tpu_torch/csrc/gram_bf16.cu"),
}


def phase(name, ok, detail=""):
    line = f"[phase] {name}: {'PASS' if ok else 'FAIL'} {detail}".rstrip()
    print(line, flush=True)
    if not ok:
        # also on standard error, whose end is what a caller of the
        # script may be shown when it fails
        print(line, file=sys.stderr, flush=True)
        sys.exit(1)


def make_hash_sets(rng, n_families):
    """Synthetic sketches: families of 8 samples around a private core.

    Each family draws a core of 4,500-6,500 hashes; each member keeps
    60-95% of it and adds 800-1,800 hashes of its own, so a sample holds
    3,500-8,000 hashes (a sourmash scaled=1000 sketch of a 3.5-8 Mbp
    genome).  2,000 cross-family hashes per 8,192 samples each sit in 16-64
    random samples (about 10 per sample at any N).  Within a family the
    max-containment is about 0.4 or more; across families it is a few
    hashes in thousands, so families separate at 0.2."""
    n = n_families * MEMBERS_PER_FAMILY
    core_sizes = rng.integers(4500, 6501, n_families)
    own_sizes = rng.integers(800, 1801, n)
    n_cross = 2000 * n // 8192
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


def make_index(rng, n_families, prefix):
    """Generate, index (host build) and write the artifacts of one synthetic
    collection; returns the index, the names, the hash sets and the host
    build's wall."""
    from kspider_tpu_torch.core.index import build_index_from_hash_sets
    from kspider_tpu_torch.io import artifacts

    t0 = time.perf_counter()
    names, arrays = make_hash_sets(rng, n_families)
    t1 = time.perf_counter()
    index = build_index_from_hash_sets(names, arrays, ksize=21,
                                       params="kSize:21")
    host_build_s = time.perf_counter() - t1
    artifacts.write_index_artifacts(prefix, index)
    deg = index.color_degrees()
    print(f"[setup] N={index.num_groups} colors={index.num_colors} "
          f"non-singleton={int((deg >= 2).sum())} "
          f"postings={len(index.color_members)} "
          f"{time.perf_counter() - t0:.3f} s (host index build "
          f"{host_build_s:.3f} s)", flush=True)
    return index, names, arrays, host_build_s


def compare_mode(label, bits_i, bits_j, wl, ti, tj, reps,
                 compute_dtype=torch.int8):
    """Kernel vs plain on one launch mode of one form (``gram_bench.measure``:
    plain timed over max(1, reps // 5) calls); prints and returns its dict
    of max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms and
    library."""
    from kspider_tpu_torch import gram_bench as gb

    r = gb.measure(bits_i, bits_j, wl, ti, tj, reps, compute_dtype=compute_dtype,
                   plain_reps=max(1, reps // 5))
    print(f"  {label} [{str(compute_dtype)[6:]}]: NB={bits_i.shape[0]} "
          f"npad={8 * bits_i.shape[1]}x{8 * bits_j.shape[1]} "
          f"block={bits_i.shape[2]} L={wl.shape[1]} pairs={len(ti)} "
          f"max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}, share {r['bound_ms'] / r['ms']:.3f}) "
          f"library_ms={r['library_ms']:.4f} ({r['library']})", flush=True)
    return r


def reset_counts(cp):
    cp.LAUNCHES = 0
    cp.DENSE_H2D_BYTES = 0
    for counts in (cp.LAUNCHES_BY_MODE, cp.LAUNCHES_BY_DTYPE, cp.DENSE_CHUNKS):
        for key in counts:
            counts[key] = 0


def read_chunks(cp):
    """The dense engine's chunks by form and their H2D bytes since the
    last :func:`reset_counts`."""
    return dict(cp.DENSE_CHUNKS, h2d_bytes=cp.DENSE_H2D_BYTES)


def read_counts(cp):
    """Launches by mode and in total, of the int8 form; the bf16 form's
    launches are read from ``LAUNCHES_BY_DTYPE`` on its own path."""
    if cp.LAUNCHES_BY_DTYPE["bfloat16"]:
        phase("int8 counts read on an int8 path", False, f"{cp.LAUNCHES_BY_DTYPE}")
    return dict(cp.LAUNCHES_BY_MODE, total=cp.LAUNCHES)


def kernel_ms(averages, compute_dtype):
    """Device ms of one form of the Gram kernel in torch.profiler averages."""
    return sum(getattr(e, "device_time_total", 0) for e in averages
               if FORMS[compute_dtype][0] in e.key) / 1000.0


def fmt_ms(ms):
    return f"{ms:.3f} ms" if ms > 0 else "not measured"


def run_cli(cli, *args):
    t0 = time.perf_counter()
    cli.main(list(args), standalone_mode=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_reference_tsv(index, ref_prefix, prefix, required):
    """The OpenMP host engine's pairwise TSV (and namesMap) for ``index``."""
    from kspider_tpu_torch.io import native
    from kspider_tpu_torch.core import pairwise as core_pairwise
    from kspider_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    if native.available():
        engine = "native OpenMP host engine"
        ref = native.shared_kmer_matrix(index.color_offsets, index.color_members,
                                        index.color_counts, index.num_groups)
    elif required:
        phase("host reference", False,
              f"native OpenMP engine unavailable: {native.load_error()!r}")
    else:
        engine = "numpy host reference (native library unavailable)"
        ref = pw.shared_kmer_matrix_numpy(index.color_offsets, index.color_members,
                                          index.color_counts, index.num_groups)
    core_pairwise.write_pairwise_tsv(ref_prefix, index, ref)
    del ref
    shutil.copy(prefix + ".namesMap", ref_prefix + ".namesMap")
    return engine, time.perf_counter() - t0


def check_clusters(out, ref_out, n_families, label):
    phase(f"{label} == scipy", filecmp.cmp(out, ref_out, shallow=False))
    with open(out) as f:
        clusters = [line.strip().split(",") for line in f if line.strip()]
    families_ok = len(clusters) == n_families and all(
        len(c) == MEMBERS_PER_FAMILY and len({s.split("_")[0] for s in c}) == 1
        for c in clusters)
    phase(f"{label} recover the families", families_ok,
          f"{len(clusters)} clusters for {n_families} families")


def tiled_chunk_inputs(plan, p, dev):
    """The first chunk of panel pair ``p`` as the tiled path packs it, with
    the default 1,024-color blocks."""
    from kspider_tpu_torch.ops import cuda_pairwise as cp
    from kspider_tpu_torch.ops import pairwise as pw
    from kspider_tpu_torch.ops import tiled_pairwise as ttp

    block = 1024
    pk = int(plan.pair_keys[p])
    pi, pj = pk // plan.n_panels, pk % plan.n_panels
    sup = pw._MAX_COLORS_PER_CALL - pw._MAX_COLORS_PER_CALL % block
    e0 = int(plan.pair_off[p])
    e1 = min(int(plan.pair_off[p + 1]), e0 + sup)
    sa, sb = plan.ent_sega[e0:e1], plan.ent_segb[e0:e1]
    nb = -(-(e1 - e0) // block)
    panel_pad = -(-plan.panel // cp.TILE) * cp.TILE
    bits_a = torch.from_numpy(ttp._pack_panel_side(
        plan, pi, sa, nb, block, panel_pad)).to(dev)
    bits_b = bits_a if pi == pj else torch.from_numpy(ttp._pack_panel_side(
        plan, pj, sb, nb, block, panel_pad)).to(dev)
    wl = torch.from_numpy(ttp._pad_limbs(
        plan.w_limbs[plan.seg_color[sa]], nb, block)).to(dev)
    return bits_a, bits_b, wl, panel_pad


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def trace_summary(events):
    """Events by category, the device events' names and the time spans of
    host and device events: the detail of a failed kernel-event count."""
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    host = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy")]
    names = sorted({e.get("name", "")[:40] for e in device})[:6]
    span = (lambda ts: f"{min(ts):.0f}-{max(ts):.0f}" if ts else "none")
    return (f"categories {cats}; device names {names}; runtime calls at "
            f"{span(host)} us, device events at "
            f"{span([e['ts'] for e in device])} us")


def pipeline_report(label, events, require_pinned, ranges=TILED_RANGES[:2],
                    unit="pair"):
    """An engine's pipeline in a trace (``timing.pipeline_numbers``): per
    ``unit`` (a tiled panel pair, or a dense chunk), the host waits and
    the host ms inside each of ``ranges`` (the tiled engine's
    ``kspider.dispatch`` and ``kspider.extract`` by default), the H2D
    bytes from pinned and from pageable memory, and the H2D time that
    overlaps a Gram kernel.  Fails the phase on a ``cudaStreamSynchronize``
    or ``cudaDeviceSynchronize`` in any of the ranges, and with
    ``require_pinned`` on any pageable H2D.  Returns the numbers, with the
    host ms of each range under ``range_ms``."""
    from kspider_tpu_torch.utils import timing

    report = timing.pipeline_numbers(events, FORMS[torch.int8][0], ranges)
    waits = report["waits"]
    report["range_ms"] = {name: sum(e["dur"] for e in events
                                    if e.get("cat") == "user_annotation"
                                    and e.get("name") == name) / 1000.0
                          for name in ranges}
    drains = {}
    for name, per in waits.items():
        counts = {call: [w[call] for w in per] for call in timing.HOST_WAITS}
        print(f"[{label}] {name}: {len(per)} ranges (one per {unit}), "
              f"{report['range_ms'][name]:.3f} ms on the host; "
              + ", ".join(f"{call} {sum(c)} (per {unit} {min(c, default=0)}-"
                          f"{max(c, default=0)})" for call, c in counts.items()),
              flush=True)
        drains.update({f"{name} {call}": sum(counts[call])
                       for call in timing.HOST_WAITS[:2] if sum(counts[call])})
    print(f"[{label}] H2D: {report['h2d_pinned_bytes']} B from pinned memory, "
          f"{report['h2d_pageable_bytes']} B from pageable memory; "
          f"{report['h2d_ms']:.3f} ms of copies, "
          f"{report['h2d_under_kernels_ms']:.3f} ms of it under a kernel",
          flush=True)
    short = " or ".join(name.split(".")[-1] for name in ranges)
    phase(f"{label}: no stream or device drain in {short}",
          not drains and all(waits.values()), f"{drains}" if drains else
          f"{len(waits[ranges[0]])} {unit}s")
    if require_pinned:
        phase(f"{label}: every H2D copy from pinned memory",
              report["h2d_pinned_bytes"] > 0
              and report["h2d_pageable_bytes"] == 0,
              f"{report['h2d_pageable_bytes']} B pageable")
    return report


def gram_time_by_mode(prefix, workdir):
    """One rerun of the tiled pairs of the index at ``prefix``, no TSV,
    under ``torch.profiler`` in a fresh process (:func:`run_child`): the
    Gram kernel's device time by launch mode (kernel events in launch
    order, by correlation id, beside the mode of each launch) and in total,
    the device's busy time, the rerun's wall and its
    :func:`pipeline_report`.  The kernel times are the device's own, not
    CUDA events around a launch, which also bracket the host's launch path
    whenever the device waits for the host."""
    path = os.path.join(workdir, "engine_rerun.json")
    result = run_child("tiled engine rerun", "rerun", prefix, path, workdir)
    modes, wall_ms = result["modes"], result["wall_ms"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and FORMS[torch.int8][0] in e.get("name", "")),
                     key=lambda e: (e.get("args", {}).get("correlation", 0), e["ts"]))
    ok = len(kernels) == len(modes)
    phase("tiled engine rerun: one kernel event per launch", ok,
          f"{len(kernels)} events, {len(modes)} launches"
          + ("" if ok else f"; {trace_summary(events)}"))
    by_mode = {mode: (modes.count(mode),
                      sum(e["dur"] for m, e in zip(modes, kernels) if m == mode)
                      / 1000.0)
               for mode in ("upper", "all")}
    report = pipeline_report("tiled engine rerun", events, True)
    return (by_mode, sum(t for _, t in by_mode.values()), report["busy_ms"],
            wall_ms, report)


def step_blocks(index):
    """Every non-singleton color of ``index`` in kspider_tpu's step layout:
    (bits, w_limbs, kmer counts, block, n_pad, n_limbs)."""
    from kspider_tpu_torch.ops import bitmask as bm
    from kspider_tpu_torch.ops import pairwise as pw

    block = 1024
    n = index.num_groups
    offs, mem, w = pw._drop_singletons(index.color_offsets, index.color_members,
                                       index.color_counts, True)
    t0 = time.perf_counter()
    bits = bm.pack_bitmask_blocks(offs, mem, n, block)
    nb, n_pad = bits.shape[0], bits.shape[2] * 8
    w_limbs = pw.weight_limbs(w)
    n_limbs = w_limbs.shape[1]
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[: len(w)] = w_limbs
    wl = wl.reshape(nb, block, n_limbs)
    counts = index.group_kmer_count.astype(np.int32)
    print(f"[step N={n}] host pack of {len(w)} colors: {nb} blocks of {block}, "
          f"{bits.nbytes} B of bits, {time.perf_counter() - t0:.3f} s", flush=True)
    return bits, wl, counts, block, n_pad, n_limbs


def fused_step_phase(blocks, dense_shared, dev, cp, launches):
    """Phase 4d: the fused step over ``step_blocks``; returns (wall s, CC
    rounds, shared, labels), the last two as numpy arrays."""
    from kspider_tpu_torch.ops import cc as cc_ops
    from kspider_tpu_torch.parallel import step

    bits, wl, counts, block, n_pad, n_limbs = blocks
    n = len(counts)
    stats = {}
    reset_counts(cp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shared, labels = step.single_device_step(
        bits, wl, counts, CUTOFF, block, n_pad, n_limbs, device=dev, stats=stats)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches["fused_step"] = read_counts(cp)
    print(f"[step N={n}] single_device_step {step_s:.3f} s (H2D included), "
          f"{stats['rounds']} CC rounds, accumulator "
          f"{4 * n_limbs * n_pad * n_pad} B, kernel launches "
          f"{launches['fused_step']}", flush=True)
    phase("fused step launched the kernel", launches["fused_step"]["upper"] > 0)
    shared = shared.cpu().numpy()
    labels = labels.cpu().numpy()
    phase("fused step shared == dense engine", np.array_equal(shared, dense_shared))
    denom = np.minimum(counts[:, None], counts[None, :]).astype(np.float32)
    cont = shared.astype(np.float32) / np.maximum(denom, np.float32(1.0))
    adj = (cont >= np.float32(CUTOFF)) & (shared > 0)
    del cont, denom
    want = cc_ops.connected_components_scipy(*np.nonzero(adj), n)
    phase("fused step labels == scipy", np.array_equal(labels, want),
          f"{len(np.unique(labels))} components")
    return step_s, stats["rounds"], shared, labels


def sharded_dense_phase(cli, cp, prefix, dense_tsv, devs, n_shards, launches):
    """Phase 4g: ``pairwise --device DEVS``, the dense engine's color blocks
    split over the shards; returns the wall s."""
    reset_counts(cp)
    wall = run_cli(cli, "pairwise", "-i", prefix, "--device", devs)
    launches["sharded"] = read_counts(cp)
    print(f"[sharded N=8192] pairwise --device {devs}: stage {wall:.3f} s, "
          f"kernel launches {launches['sharded']}", flush=True)
    phase("sharded dense TSV == dense TSV",
          filecmp.cmp(prefix + "_kSpider_pairwise.tsv", dense_tsv, shallow=False))
    phase("sharded dense launched every shard",
          launches["sharded"]["upper"] >= n_shards, f"{launches['sharded']}")
    return wall


def sharded_step_phase(blocks, step_shared, step_labels, devs, n_shards, cp,
                       launches):
    """Phase 4h: ``sharded_step`` over the blocks of phase 4d, padded with
    empty blocks to a multiple of the shard count; ``shared`` and
    ``labels`` must equal ``single_device_step``'s.  Returns the wall s."""
    from kspider_tpu_torch.parallel import step

    bits, wl, counts, block, n_pad, n_limbs = blocks
    pad = -bits.shape[0] % n_shards
    bits = np.concatenate([bits, np.zeros((pad,) + bits.shape[1:], np.uint8)])
    wl = np.concatenate([wl, np.zeros((pad,) + wl.shape[1:], np.int8)])
    reset_counts(cp)
    sync_all()
    t0 = time.perf_counter()
    shared, labels = step.sharded_step(devs, bits, wl, counts, CUTOFF, block,
                                       n_pad, n_limbs)
    sync_all()
    wall = time.perf_counter() - t0
    launches["sharded_step"] = read_counts(cp)
    print(f"[sharded step N={len(counts)}] sharded_step over {devs}: "
          f"{bits.shape[0]} blocks, {wall:.3f} s (H2D included), kernel "
          f"launches {launches['sharded_step']}", flush=True)
    phase("sharded step launched every shard",
          launches["sharded_step"]["upper"] == n_shards,
          f"{launches['sharded_step']}")
    phase("sharded step shared == single_device_step",
          np.array_equal(shared.cpu().numpy(), step_shared))
    phase("sharded step labels == single_device_step",
          np.array_equal(labels.cpu().numpy(), step_labels))
    return wall


def tiled_devices_phase(cli, cp, prefix, dense_tsv, devs, n_shards, launches):
    """Phase 4i: the tiled engine over DEVS, pair-parallel (panel 2,048:
    10 pairs) and with each pair's blocks split (panel 8,192: 1 pair);
    returns the walls."""
    walls = {}
    for path, panel, layout in (
            ("pair_parallel", "2048", "pair-parallel round-robin"),
            ("sharded_pair", "8192", "color blocks of each pair split")):
        reset_counts(cp)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            walls[path] = run_cli(cli, "pairwise", "-i", prefix, "--engine",
                                  "tiled", "--panel", panel, "--device", devs)
        sys.stdout.write(out.getvalue())
        launches[path] = read_counts(cp)
        print(f"[tiled over devices N=8192] --panel {panel} --device {devs}: "
              f"stage {walls[path]:.3f} s, kernel launches {launches[path]}",
              flush=True)
        phase(f"tiled {path} TSV == dense TSV",
              filecmp.cmp(prefix + "_kSpider_pairwise.tsv", dense_tsv,
                          shallow=False))
        phase(f"tiled --panel {panel} ran {layout}", layout in out.getvalue())
    phase("tiled over devices launched both modes in every shard",
          launches["pair_parallel"]["upper"] > 0
          and launches["pair_parallel"]["all"] > 0
          and launches["sharded_pair"]["upper"] >= n_shards,
          f"{launches['pair_parallel']} / {launches['sharded_pair']}")
    return walls


#: worker of phase 4j: one process of a two-process run, on ``device``
MP_WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.parallel import multiprocess as mp

mode, rank, nproc, port, prefix, npz, device = sys.argv[1:8]
coord = f"localhost:{{port}}"
if mode == "hashrange":
    with np.load(npz) as data:  # each key read once: a read unzips it
        names, bounds, hashes = (data[k] for k in ("names", "offsets", "hashes"))
    arrays = [hashes[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    mp.distributed_pairwise_from_hash_sets(
        names.tolist(), arrays, prefix, ksize=21, device=device,
        coordinator=coord, num_processes=int(nproc), process_id=int(rank))
    mp.shutdown()
else:
    from kspider_tpu_torch.cli.main import cli

    args = ["pairwise", "-i", prefix, "--device", device, "--coordinator",
            coord, "--num-processes", nproc, "--process-id", rank]
    if mode == "tiled":
        args += ["--engine", "tiled", "--panel", "2048"]
    cli.main(args, standalone_mode=False)
torch.cuda.synchronize(device)
assert "jax" not in sys.modules, "the port imported jax"
print("LAUNCHES " + json.dumps(dict(cp.LAUNCHES_BY_MODE, total=cp.LAUNCHES)))
print("CHUNKS " + json.dumps(dict(cp.DENSE_CHUNKS, h2d_bytes=cp.DENSE_H2D_BYTES)))
print("WORKER_OK", rank, flush=True)
"""
MP_TIMEOUT = 300


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multiprocess_phase(prefix, dense_tsv, names, arrays, workdir, devices,
                       launches):
    """Phase 4j: two coordinated worker processes on ``devices`` (one each),
    merging over gloo: the color-slice dense path and the
    panel-row tiled path through the CLI, and the hash-range path from the
    hash sets saved to an .npz.  Returns the walls and rank 0's merge line."""
    script = os.path.join(workdir, "mp_worker.py")
    with open(script, "w") as f:
        f.write(MP_WORKER.format(repo=os.path.dirname(os.path.abspath(__file__))))
    npz = os.path.join(workdir, "hash_sets.npz")
    t0 = time.perf_counter()
    bounds = np.zeros(len(arrays) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in arrays], out=bounds[1:])
    np.savez(npz, names=np.array(names), offsets=bounds,
             hashes=np.concatenate(arrays))
    print(f"[multiprocess] saved {len(arrays)} hash sets ({bounds[-1]} hashes) "
          f"to {os.path.basename(npz)}, {time.perf_counter() - t0:.3f} s",
          flush=True)
    walls, merge_line = {}, ""
    for path, mode, out_prefix in (
            ("multiprocess_dense", "dense", prefix),
            ("multiprocess_tiled", "tiled", prefix),
            ("hashrange", "hashrange", os.path.join(workdir, "hashrange"))):
        tsv = out_prefix + "_kSpider_pairwise.tsv"
        if os.path.exists(tsv):
            os.remove(tsv)
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, script, mode, str(r), "2", str(port), out_prefix,
             npz, devices[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_TIMEOUT)[0].decode())
        except subprocess.TimeoutExpired:
            phase(f"{path}: workers finished within {MP_TIMEOUT} s", False)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        walls[path] = time.perf_counter() - t0
        ranks, rank_chunks = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                print(f"  [{path} rank {r}] {line}", flush=True)
                if line.startswith("LAUNCHES "):
                    ranks.append(json.loads(line[len("LAUNCHES "):]))
                if line.startswith("CHUNKS "):
                    rank_chunks.append(json.loads(line[len("CHUNKS "):]))
                if r == 0 and line.startswith("merging "):
                    merge_line = line
            phase(f"{path}: worker {r} on {devices[r]} exited 0",
                  p.returncode == 0 and f"WORKER_OK {r}" in out,
                  f"rc={p.returncode}")
        launches[path] = {key: sum(c[key] for c in ranks) for key in ranks[0]}
        launches[path]["ranks"] = [c["total"] for c in ranks]
        print(f"[multiprocess] {path}: 2 processes, wall {walls[path]:.3f} s "
              f"(process start-up included), kernel launches {launches[path]}",
              flush=True)
        phase(f"{path}: every rank launched the kernel",
              len(ranks) == 2 and all(c["total"] > 0 for c in ranks))
        if mode == "dense":
            phase(f"{path}: every color slice shipped posting keys",
                  len(rank_chunks) == 2
                  and all(c["keys"] > 0 for c in rank_chunks),
                  f"{rank_chunks}")
        phase(f"{path} TSV == dense TSV",
              filecmp.cmp(tsv, dense_tsv, shallow=False))
        parts = glob.glob(os.path.join(workdir, "*.part"))
        phase(f"{path}: no part files remain", not parts, f"{parts[:3]}")
    os.remove(npz)
    return walls, merge_line


def bins_cli_phase(cli, names, arrays, workdir):
    """Phase 4f: ``index --bins`` with and without ``--device-build
    --device cuda`` on the collection written as .bin files; returns the
    two walls (host, device)."""
    from kspider_tpu_torch.io import phmap as phmap_io

    bins = os.path.join(workdir, "bins")
    os.makedirs(bins)
    t0 = time.perf_counter()
    for name, hashes in zip(names, arrays):
        phmap_io.write_hash_set(os.path.join(bins, f"{name}.bin"), hashes)
    print(f"[index CLI N={len(names)}] wrote {len(names)} .bin files, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    host, device = os.path.join(workdir, "bins_host"), os.path.join(workdir, "bins_dev")
    host_s = run_cli(cli, "index", "--bins", "--dir", bins, "-k", "21", "-o", host)
    device_s = run_cli(cli, "index", "--bins", "--dir", bins, "-k", "21", "-o",
                       device, "--device-build", "--device", "cuda")
    print(f"[index CLI N={len(names)}] index --bins {host_s:.3f} s, with "
          f"--device-build --device cuda {device_s:.3f} s", flush=True)
    same = all(filecmp.cmp(host + suffix, device + suffix, shallow=False)
               for suffix in ARTIFACTS)
    phase("index --device-build artifacts == host build", same,
          f"{len(ARTIFACTS)} artifacts")
    shutil.rmtree(bins, ignore_errors=True)
    return host_s, device_s


def device_build_phase(index, names, arrays, host_build_s, dev):
    """Phase 4f, in-process: ``build_index_device`` on the card against the
    host build of the same hash sets; returns the walls and the build's
    stats."""
    from kspider_tpu_torch.core.index import build_index_device

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = build_index_device(names, arrays, ksize=21, params="kSize:21",
                               device=dev, stats=stats)
    device_s = time.perf_counter() - t0
    print(f"[device build N={len(names)}] host build {host_build_s:.3f} s, "
          f"device build {device_s:.3f} s; sort {stats['sort_ms']:.3f} ms "
          f"(CUDA events), postings in {stats['postings_in']}, kept "
          f"{stats['postings_kept']}, H2D {stats['h2d_bytes']} B", flush=True)
    fields = ("names", "group_kmer_count", "color_ids", "color_offsets",
              "color_members", "color_counts", "ksize", "hash_mode",
              "slicing_mode", "params")
    differ = [f for f in fields
              if not np.array_equal(np.asarray(getattr(built, f)),
                                    np.asarray(getattr(index, f)))]
    phase("device index build == host build", not differ,
          f"fields differing: {differ}" if differ else f"{len(fields)} fields")
    return dict(stats, n=len(names), host_s=host_build_s, device_s=device_s)


#: one profiled run of phases 4k, 5 (the engine rerun) and 5b, in a fresh
#: process: ``stage`` runs the CLI's ``pairwise -i PREFIX --device cuda``
#: with ``KSPIDER_PROFILE=OUT``; ``rerun`` runs the tiled engine's panel
#: pairs of the index at PREFIX, no TSV, under torch.profiler and writes
#: the Chrome trace to OUT.  The library and the CUDA context are loaded
#: before the timed run; the profiler starts inside it, as for a user's
#: profiled run.  The last line is ``RESULT {json}``: the wall, the launch
#: counts and the dense engine's chunk counters of the fresh process, for
#: ``stage`` the CLI's matrix construction seconds, and for ``rerun`` the
#: mode of each launch in launch order.
PROFILE_CHILD = """
import contextlib, io, json, os, sys, time
sys.path.insert(0, {repo!r})
import torch
from kspider_tpu_torch.ops import _build
from kspider_tpu_torch.ops import cuda_pairwise as cp

mode, prefix, out = sys.argv[1:4]
# the kernels' library and the CUDA context, outside the timed run, as in
# the smoke's own process
_build.library()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
result = {{}}
if mode == "stage":
    from kspider_tpu_torch.cli.main import cli
    from kspider_tpu_torch.utils import timing

    os.environ[timing.PROFILE_ENV] = out
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main(["pairwise", "-i", prefix, "--device", "cuda"],
                 standalone_mode=False)
    torch.cuda.synchronize()
    result["wall_s"] = time.perf_counter() - t0
    sys.stdout.write(printed.getvalue())
    for line in printed.getvalue().splitlines():
        if line.startswith("pairwise matrix construction: "):
            result["construction_s"] = float(line.split()[3])
else:
    from torch.profiler import ProfilerActivity, profile
    from kspider_tpu_torch.io import artifacts
    from kspider_tpu_torch.ops import tiled_pairwise as ttp

    index = artifacts.load_index_artifacts(prefix)
    plan = ttp.build_panel_plan(index.color_offsets, index.color_members,
                                index.color_counts, index.num_groups, 4096)
    real, modes = cp.cooccurrence_tiles, []

    def recorded(bits_i, bits_j, *args, **kw):
        modes.append("upper" if bits_j is bits_i else "all")
        return real(bits_i, bits_j, *args, **kw)

    cp.cooccurrence_tiles = recorded
    dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in ttp.iter_panel_pairs(plan, device=dev):
            pass
        torch.cuda.synchronize()
        result["wall_ms"] = (time.perf_counter() - t0) * 1000.0
    cp.cooccurrence_tiles = real
    prof.export_chrome_trace(out)
    result["modes"] = modes
assert "jax" not in sys.modules, "the port imported jax"
result["launches"] = dict(cp.LAUNCHES_BY_MODE, total=cp.LAUNCHES)
result["by_dtype"] = dict(cp.LAUNCHES_BY_DTYPE)
result["chunks"] = dict(cp.DENSE_CHUNKS, h2d_bytes=cp.DENSE_H2D_BYTES)
print("RESULT " + json.dumps(result), flush=True)
"""
CHILD_TIMEOUT = 600


def run_child(label, mode, prefix, out, workdir):
    """Runs :data:`PROFILE_CHILD` in a fresh process, prints its output
    under ``label`` and returns its result; the phase fails unless it
    exits 0 with a result and launched only the int8 form.  A fresh
    process because, in this long process, a later ``torch.profiler``
    session lost the device and runtime records of the first part of its
    run (PERF.md, section 6), while a process's first sessions did not."""
    script = os.path.join(workdir, "profile_child.py")
    with open(script, "w") as f:
        f.write(PROFILE_CHILD.format(
            repo=os.path.dirname(os.path.abspath(__file__))))
    try:
        proc = subprocess.run([sys.executable, script, mode, prefix, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        phase(f"{label}: child process finished within {CHILD_TIMEOUT} s", False)
    result = None
    for line in proc.stdout.decode().splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        else:
            print(f"  [{label}] {line}", flush=True)
    os.remove(script)
    phase(f"{label}: child process exited 0 with a result",
          proc.returncode == 0 and result is not None, f"rc={proc.returncode}")
    phase(f"{label}: int8 form only", result["by_dtype"]["bfloat16"] == 0,
          f"{result['by_dtype']}")
    return result


def profiled_stage(label, prefix, prof_dir, want_tsv, ranges, modes, launches,
                   workdir):
    """Phases 4k and 5b: ``pairwise -i prefix --device cuda`` with
    ``KSPIDER_PROFILE=prof_dir``, in a fresh process (:func:`run_child`).
    Exactly one trace must be written and parse, hold one int8 Gram kernel
    event per counted launch (each of ``modes`` launched) and every one of
    ``ranges``; the TSV must equal ``want_tsv``.  Prints the device's busy
    time in the trace (kernels, copies, sets) over its window, and reads
    the trace with :func:`pipeline_report` (the tiled engine's ranges, or
    the dense engine's ``kspider.pack`` and ``kspider.gram``, where a
    pageable H2D also fails).  Returns (stage wall s, trace bytes, kernel
    events, their summed device ms, a dict of the child's chunk counters
    and construction seconds, the trace's window ms and the report)."""
    from kspider_tpu_torch.utils import timing

    result = run_child(label, "stage", prefix, prof_dir, workdir)
    wall = result["wall_s"]
    counts = launches[label] = result["launches"]
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    phase(f"{label}: one trace written", len(traces) == 1, f"{traces}")
    try:
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    except (ValueError, KeyError) as exc:
        phase(f"{label}: trace parses", False, repr(exc))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and FORMS[torch.int8][0] in e.get("name", "")]
    ok = len(kernels) == counts["total"] and all(counts[m] > 0 for m in modes)
    phase(f"{label}: one kernel event per launch", ok,
          f"{len(kernels)} events, launches {counts}"
          + ("" if ok else f"; {trace_summary(events)}"))
    names = {e.get("name") for e in events}
    missing = [r for r in ranges if r not in names]
    phase(f"{label}: kspider ranges in the trace", not missing,
          f"missing {missing}" if missing else ", ".join(ranges))
    phase(f"{label}: TSV == unprofiled TSV",
          filecmp.cmp(prefix + "_kSpider_pairwise.tsv", want_tsv, shallow=False))
    pack = "present" if "kspider.pack" in names else "absent"
    spans = [e for e in events if e.get("ph") == "X"]
    window_ms = (max(e["ts"] + e["dur"] for e in spans)
                 - min(e["ts"] for e in spans)) / 1000.0
    busy_ms = timing.union_ms([(e["ts"], e["dur"]) for e in spans if e.get("cat")
                               in ("kernel", "gpu_memcpy", "gpu_memset")])
    print(f"[{label}] trace {os.path.basename(traces[0])}: {len(events)} events, "
          f"kspider.pack {pack}; device busy {busy_ms:.3f} ms of the "
          f"trace's {window_ms:.3f} ms (idle share "
          f"{1 - busy_ms / window_ms:.4f})", flush=True)
    if ranges == TILED_RANGES:
        report = pipeline_report(label, events, False)
    else:
        report = pipeline_report(label, events, True, ranges[:2], "chunk")
    extra = dict(chunks=result["chunks"],
                 construction_s=result.get("construction_s", 0.0),
                 window_ms=window_ms, report=report)
    return (wall, os.path.getsize(traces[0]), len(kernels),
            sum(e["dur"] for e in kernels) / 1000.0, extra)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--families", type=int, default=1024,
                    help="families of 8 samples in the dense phase (N = 8 x families)")
    ap.add_argument("--tiled-families", type=int, default=4096,
                    help="families of 8 samples in the tiled phase; 8 x this "
                         "must exceed 16,384")
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".smoke"))
    args = ap.parse_args()
    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from kspider_tpu_torch import gram_bench as gb
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
    from kspider_tpu_torch.cli.main import cli
    from kspider_tpu_torch.core import cluster as core_cluster
    from kspider_tpu_torch.ops import pairwise as pw
    from kspider_tpu_torch.ops import tiled_pairwise as ttp

    if args.tiled_families * MEMBERS_PER_FAMILY <= 16384:
        phase("arguments", False, "the tiled phase needs N > 16,384")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    rng = np.random.default_rng(args.seed)
    prefix = os.path.join(args.workdir, "smoke")
    index, names, arrays, host_build_s = make_index(rng, args.families, prefix)
    n = index.num_groups
    deg = index.color_degrees()
    multi = deg >= 2
    w_multi = index.color_counts[multi]

    # ---- 3. kernel vs plain ---------------------------------------------
    # the dense path's first chunk: CHUNK_BLOCKS blocks of non-singleton colors
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
    path_modes = [
        ("upper tiles (dense path)", bits, bits, wl, *cp.upper_triangle_tiles(nt), 5),
        ("all tiles, square", bits, bits, wl, *cp.all_tiles(nt, nt), 5),
        ("all tiles, rect", bits_a, bits_b, wl, *cp.all_tiles(nt // 2, nt - nt // 2), 5),
    ]
    # gram_bench's ragged shapes (L = 1-4) in each of its modes.  The first
    # four shapes draw from the collections' stream, as they always have,
    # so the N = 32,768 collection stays what earlier runs measured; the
    # rest and the shuffled orders draw apart.
    extra = np.random.default_rng(args.seed + 1)
    ragged_modes = []
    for k, shape in enumerate(gb.RAGGED):
        bi, bj, w = gb.ragged_inputs(shape, rng if k < 4 else extra, dev)
        for mode in gb.MODES:
            mi, mj, ti_, tj_ = gb.mode_tiles(mode, bi, bj, extra)
            ragged_modes.append((f"{mode}, small, L={shape[4]}", mi, mj, w,
                                 ti_, tj_, 20))
    phase3_s = {}
    results = []
    for name, cases in (("path", path_modes), ("ragged", ragged_modes)):
        t0 = time.perf_counter()
        results += [compare_mode(label, *rest) for label, *rest in cases]
        phase3_s[f"int8 {name}"] = time.perf_counter() - t0
    max_err = max(r["max_abs_err"] for r in results)
    dense_row, square_row, rect_row = results[:3]
    phase("kernel vs plain", max_err == 0,
          f"{len(results)} cases, max_abs_err={max_err} (exact int32 required)")
    results_bf16 = []
    for name, cases in (("path", path_modes), ("ragged", ragged_modes)):
        t0 = time.perf_counter()
        results_bf16 += [compare_mode(label, *rest, compute_dtype=torch.bfloat16)
                         for label, *rest in cases]
        phase3_s[f"bf16 {name}"] = time.perf_counter() - t0
    max_err_bf16 = max(r["max_abs_err"] for r in results_bf16)
    del bits, wl, bits_a, bits_b, path_modes, ragged_modes
    torch.cuda.empty_cache()
    phase("bf16 kernel vs plain", max_err_bf16 == 0,
          f"{len(results_bf16)} cases, max_abs_err={max_err_bf16} "
          "(exact int32 required)")
    print(f"[phase 3] {sum(phase3_s.values()):.3f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase3_s.items()), flush=True)

    # ---- 4. dense path --------------------------------------------------
    launches, chunks = {}, {}
    reset_counts(cp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pairwise_s = run_cli(cli, "pairwise", "-i", prefix, "--device", "cuda")
    sys.stdout.write(out.getvalue())
    chunks["dense"] = read_chunks(cp)
    construction_s = [float(line.split()[3]) for line in out.getvalue().splitlines()
                      if line.startswith("pairwise matrix construction: ")][-1]
    cluster_s = run_cli(cli, "cluster", "-i", prefix, "-c", str(CUTOFF),
                        "--device", "cuda")
    launches["dense"] = read_counts(cp)
    print(f"[dense] pairwise stage {pairwise_s:.3f} s (matrix construction "
          f"{construction_s:.3f} s), cluster stage {cluster_s:.3f} s, kernel "
          f"launches {launches['dense']}", flush=True)
    print(f"[dense] chunks: {chunks['dense']['keys']} as posting keys packed "
          f"on the card, {chunks['dense']['host']} as host bitmasks; "
          f"{chunks['dense']['h2d_bytes']} B of chunk inputs to the card",
          flush=True)
    phase("kernel launched on the dense path", launches["dense"]["upper"] > 0,
          f"{launches['dense']}")
    phase("dense path shipped posting keys", chunks["dense"]["keys"] > 0,
          f"{chunks['dense']}")

    # kernel time of the pairwise stage's Gram product, from a profiled rerun
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dense_shared = pw.shared_kmer_matrix(
            index.color_offsets, index.color_members, index.color_counts, n,
            device=dev)
        torch.cuda.synchronize()
    dense_prof_ms = kernel_ms(prof.key_averages(), torch.int8)
    print(f"[dense] Gram kernel time in one pairwise product: "
          f"{fmt_ms(dense_prof_ms)}", flush=True)

    ref_prefix = os.path.join(args.workdir, "ref")
    ref_engine, ref_s = host_reference_tsv(index, ref_prefix, prefix, False)
    tsv, ref_tsv = prefix + "_kSpider_pairwise.tsv", ref_prefix + "_kSpider_pairwise.tsv"
    rows = sum(1 for _ in open(tsv)) - 1
    phase("pairwise TSV == host engine", filecmp.cmp(tsv, ref_tsv, shallow=False),
          f"{rows} rows, reference: {ref_engine} ({ref_s:.3f} s)")
    ref_out = core_cluster.cluster_index(ref_prefix, CUTOFF, device=None)
    check_clusters(prefix + CLUSTERS_SUFFIX, ref_out, args.families, "clusters")

    # ---- 4b. tiled path on the dense index -------------------------------
    dense_tsv = os.path.join(args.workdir, "dense_pairwise.tsv")
    shutil.copy(tsv, dense_tsv)
    reset_counts(cp)
    tiled_s = run_cli(cli, "pairwise", "-i", prefix, "--engine", "tiled",
                      "--panel", "2048", "--device", "cuda",
                      "--device-pack", "force")
    launches["tiled_dense_index"] = read_counts(cp)
    print(f"[tiled N={n}] pairwise stage {tiled_s:.3f} s, kernel launches "
          f"{launches['tiled_dense_index']}", flush=True)
    phase("tiled TSV == dense TSV", filecmp.cmp(tsv, dense_tsv, shallow=False))
    phase("tiled path launched both modes",
          launches["tiled_dense_index"]["upper"] > 0
          and launches["tiled_dense_index"]["all"] > 0,
          f"{launches['tiled_dense_index']}")

    # ---- 4c. the bf16 form on the dense index ----------------------------
    reset_counts(cp)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bf16_shared = cp.shared_kmer_matrix_cuda(
            index.color_offsets, index.color_members, index.color_counts, n,
            device=dev, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
    bf16_launches = cp.LAUNCHES_BY_DTYPE["bfloat16"]
    print(f"[bf16 N={n}] shared_kmer_matrix_cuda {bf16_s:.3f} s, bf16 kernel "
          f"launches {bf16_launches}, kernel time "
          f"{fmt_ms(kernel_ms(prof.key_averages(), torch.bfloat16))}", flush=True)
    phase("bf16 form launched on its path", bf16_launches > 0
          and cp.LAUNCHES_BY_DTYPE["int8"] == 0, f"{cp.LAUNCHES_BY_DTYPE}")
    phase("bf16 matrix == int8 matrix", np.array_equal(bf16_shared, dense_shared))
    del bf16_shared

    # ---- 4d. fused single-device step -----------------------------------
    blocks = step_blocks(index)
    step_s, step_rounds, step_shared, step_labels = fused_step_phase(
        blocks, dense_shared, dev, cp, launches)
    del dense_shared

    # ---- 4e. the other engine names --------------------------------------
    engine_s = {}
    for engine in ("scatter", "pallas", "bitmask"):
        reset_counts(cp)
        engine_s[engine] = run_cli(cli, "pairwise", "-i", prefix, "--engine",
                                   engine, "--device", "cuda")
        counts = read_counts(cp)
        if engine != "scatter":
            launches[f"engine_{engine}"] = counts
            chunks[f"engine_{engine}"] = read_chunks(cp)
        print(f"[engine {engine} N={n}] pairwise stage {engine_s[engine]:.3f} s, "
              f"kernel launches {counts}"
              + (f", chunks {chunks[f'engine_{engine}']}" if engine != "scatter"
                 else ""), flush=True)
        phase(f"--engine {engine} TSV == dense TSV",
              filecmp.cmp(tsv, dense_tsv, shallow=False))
        phase(f"--engine {engine} launches",
              counts["total"] == 0 if engine == "scatter" else counts["upper"] > 0,
              f"{counts}")
    phase("--engine pallas shipped posting keys",
          chunks["engine_pallas"]["keys"] > 0, f"{chunks['engine_pallas']}")
    phase("--engine bitmask packed every chunk on the host",
          chunks["engine_bitmask"]["keys"] == 0
          and chunks["engine_bitmask"]["host"] > 0, f"{chunks['engine_bitmask']}")

    # ---- 4f. index --device-build through the CLI on .bin files, and in-process
    cli_build = bins_cli_phase(cli, names, arrays, args.workdir)
    build = device_build_phase(index, names, arrays, host_build_s, dev)

    # ---- 4g-4j. several devices and several processes --------------------
    n_shards = max(2, count)
    devs = ",".join(f"cuda:{i}" for i in range(n_shards)) if count >= 2 \
        else "cuda:0,cuda:0"
    print(f"[devices] DEVS={devs}: {n_shards} shards on {count} card(s); on one "
          "card these phases measure overhead, not scaling", flush=True)
    sharded_s = sharded_dense_phase(cli, cp, prefix, dense_tsv, devs,
                                    n_shards, launches)
    sharded_step_s = sharded_step_phase(
        blocks, step_shared, step_labels, devs, n_shards, cp, launches)
    del blocks, step_shared, step_labels
    tiled_devs_s = tiled_devices_phase(cli, cp, prefix, dense_tsv, devs,
                                       n_shards, launches)
    mp_s, merge_line = multiprocess_phase(
        prefix, dense_tsv, names, arrays, args.workdir,
        [f"cuda:{r}" if count >= 2 else "cuda:0" for r in range(2)], launches)
    del index, names, arrays

    # ---- 4k. the profiled dense stage ------------------------------------
    prof_dense = profiled_stage(
        "profiled_dense", prefix, os.path.join(args.workdir, "prof_dense"),
        dense_tsv, DENSE_RANGES, ("upper",), launches, args.workdir)
    print(f"[profiled dense N={n}] KSPIDER_PROFILE stage {prof_dense[0]:.3f} s "
          f"in a fresh process (unprofiled, phase 4: {pairwise_s:.3f} s); trace {prof_dense[1]} B; "
          f"{prof_dense[2]} kernel events, {prof_dense[3]:.3f} ms of device time "
          f"(phase 4's product: {fmt_ms(dense_prof_ms)} by torch.profiler)",
          flush=True)
    extra = prof_dense[4]
    chunks["profiled_dense"] = extra["chunks"]
    rep = extra["report"]
    print(f"[profiled dense N={n}] chunks {extra['chunks']}; H2D "
          f"{rep['h2d_pinned_bytes']} B from pinned memory, "
          f"{rep['h2d_pageable_bytes']} B pageable, {rep['h2d_ms']:.3f} ms of "
          f"copies ({rep['h2d_under_kernels_ms']:.3f} ms under a kernel); host "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in rep["range_ms"].items())
          + f"; matrix construction {extra['construction_s']:.3f} s, trace "
          f"window {extra['window_ms']:.3f} ms (phase 4: construction "
          f"{construction_s:.3f} s)", flush=True)
    phase("profiled dense shipped posting keys", extra["chunks"]["keys"] > 0,
          f"{extra['chunks']}")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)

    # ---- 5. tiled path at full width -------------------------------------
    big = os.path.join(args.workdir, "big")
    index = make_index(rng, args.tiled_families, big)[0]  # hash sets freed
    n_big = index.num_groups
    t0 = time.perf_counter()
    plan = ttp.build_panel_plan(index.color_offsets, index.color_members,
                                index.color_counts, n_big, 4096)
    print(f"[tiled N={n_big}] panel plan: {plan.n_panels} panels, "
          f"{len(plan.pair_keys)} pairs, {len(plan.ent_sega)} entries, "
          f"L={plan.n_limbs}, {time.perf_counter() - t0:.3f} s", flush=True)
    # the kernel vs plain on the path's own first diagonal and off-diagonal chunks
    keys = plan.pair_keys.tolist()
    tiled_modes, tiled_modes_bf16 = {}, {}
    for label, p in (("upper tiles (tiled diagonal pair (0,0))", keys.index(0)),
                     ("all tiles, rect (tiled pair (0,1))", keys.index(1))):
        bi, bj, wl_t, panel_pad = tiled_chunk_inputs(plan, p, dev)
        nt = panel_pad // cp.TILE
        tiles = cp.upper_triangle_tiles(nt) if bj is bi else cp.all_tiles(nt, nt)
        mode = "upper" if bj is bi else "all"
        tiled_modes[mode] = compare_mode(label, bi, bj, wl_t, *tiles, 5)
        tiled_modes_bf16[mode] = compare_mode(
            label, bi, bj, wl_t, *tiles, 5, compute_dtype=torch.bfloat16)
        del bi, bj, wl_t
    torch.cuda.empty_cache()
    tiled_err = max(r["max_abs_err"] for r in tiled_modes.values())
    max_err = max(max_err, tiled_err)
    phase("kernel vs plain at the tiled shapes", tiled_err == 0,
          f"max_abs_err={tiled_err} (exact int32 required)")
    tiled_err_bf16 = max(r["max_abs_err"] for r in tiled_modes_bf16.values())
    max_err_bf16 = max(max_err_bf16, tiled_err_bf16)
    phase("bf16 kernel vs plain at the tiled shapes", tiled_err_bf16 == 0,
          f"max_abs_err={tiled_err_bf16} (exact int32 required)")

    reset_counts(cp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pairwise_s = run_cli(cli, "pairwise", "-i", big, "--device", "cuda")
    sys.stdout.write(out.getvalue())
    launches["tiled"] = read_counts(cp)
    breakdown = [line.strip() for line in out.getvalue().splitlines()
                 if "stage breakdown" in line]
    print(f"[tiled N={n_big}] pairwise stage {pairwise_s:.3f} s, kernel "
          f"launches {launches['tiled']}; {breakdown[-1] if breakdown else ''}",
          flush=True)
    phase("auto switch took the tiled path in both modes",
          launches["tiled"]["upper"] > 0 and launches["tiled"]["all"] > 0,
          f"{launches['tiled']}")
    cluster_s = run_cli(cli, "cluster", "-i", big, "-c", str(CUTOFF),
                        "--device", "cuda")
    tsv_clusters = os.path.join(args.workdir, "tsv_clusters.tsv")
    shutil.move(big + CLUSTERS_SUFFIX, tsv_clusters)
    reset_counts(cp)
    from_index_s = run_cli(cli, "cluster", "-i", big, "--from-index", "-c",
                           str(CUTOFF), "--device", "cuda")
    launches["from_index"] = read_counts(cp)
    print(f"[tiled N={n_big}] cluster stage {cluster_s:.3f} s, cluster "
          f"--from-index {from_index_s:.3f} s (kernel launches "
          f"{launches['from_index']})", flush=True)
    phase("cluster --from-index launched both modes",
          launches["from_index"]["upper"] > 0 and launches["from_index"]["all"] > 0)

    by_mode, prof_ms, busy_ms, wall_ms, rerun = gram_time_by_mode(
        big, args.workdir)
    print(f"[tiled N={n_big}] Gram kernel device time on the tiled pairs: "
          + ", ".join(f"{m} {c} launches {t:.3f} ms" for m, (c, t) in by_mode.items())
          + f"; torch.profiler total {fmt_ms(prof_ms)}", flush=True)
    if busy_ms > 0:
        print(f"[tiled N={n_big}] engine rerun without the TSV: device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"(idle share {1 - busy_ms / wall_ms:.4f})", flush=True)
    del plan

    # ---- 5b. the profiled tiled stage ------------------------------------
    unprofiled_tsv = os.path.join(args.workdir, "big_unprofiled.tsv")
    shutil.copy(big + "_kSpider_pairwise.tsv", unprofiled_tsv)
    prof_tiled = profiled_stage(
        "profiled_tiled", big, os.path.join(args.workdir, "prof_tiled"),
        unprofiled_tsv, TILED_RANGES, ("upper", "all"), launches, args.workdir)
    os.remove(unprofiled_tsv)
    print(f"[profiled tiled N={n_big}] KSPIDER_PROFILE stage {prof_tiled[0]:.3f} s "
          f"in a fresh process (unprofiled: {pairwise_s:.3f} s); trace {prof_tiled[1]} B; "
          f"{prof_tiled[2]} kernel events, {prof_tiled[3]:.3f} ms of device time "
          f"(engine rerun: torch.profiler total {fmt_ms(prof_ms)})", flush=True)

    big_ref = os.path.join(args.workdir, "big_ref")
    ref_engine, ref_s = host_reference_tsv(index, big_ref, big, True)
    tsv, ref_tsv = big + "_kSpider_pairwise.tsv", big_ref + "_kSpider_pairwise.tsv"
    rows = sum(1 for _ in open(tsv)) - 1
    phase("tiled TSV == host engine", filecmp.cmp(tsv, ref_tsv, shallow=False),
          f"{rows} rows, reference: {ref_engine} ({ref_s:.3f} s)")
    ref_out = core_cluster.cluster_index(big_ref, CUTOFF, device=None)
    check_clusters(tsv_clusters, ref_out, args.tiled_families, "clusters from the TSV")
    check_clusters(big + CLUSTERS_SUFFIX, ref_out, args.tiled_families,
                   "clusters --from-index")
    phase("no jax", "jax" not in sys.modules)
    tpu_mods = [m for m in sys.modules
                if m == "kspider_tpu" or m.startswith("kspider_tpu.")]
    phase("no kspider_tpu", not tpu_mods, f"{tpu_mods[:3]}")
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(f"[smoke] wall {time.perf_counter() - t_start:.3f} s", flush=True)

    print(f"[smoke] summary: fused step {step_s:.3f} s ({step_rounds} CC "
          f"rounds); engines {engine_s}; index CLI host/device "
          f"{cli_build[0]:.3f}/{cli_build[1]:.3f} s; N={build['n']} build host "
          f"{build['host_s']:.3f} s, device {build['device_s']:.3f} s; "
          f"KSPIDER_PROFILE stages dense {prof_dense[0]:.3f} s, tiled "
          f"{prof_tiled[0]:.3f} s", flush=True)
    print(f"[smoke] several devices ({devs}): sharded dense {sharded_s:.3f} s, "
          f"sharded step {sharded_step_s:.3f} s, tiled "
          + ", ".join(f"{k} {v:.3f} s" for k, v in tiled_devs_s.items())
          + "; two processes "
          + ", ".join(f"{k} {v:.3f} s" for k, v in mp_s.items())
          + f"; rank 0: {merge_line or 'no merge line'}", flush=True)
    def kernel_entry(name, compute_dtype, launches_total, err, rows):
        """The kernel's JSON entry: its time, plain time, bound and library
        time at the tiled path's off-diagonal pair (``tiled_all``, the
        shape these fields have always been read at), and every number by
        shape."""
        main = rows["tiled_all"]
        return {
            "name": name,
            "route": "cuda",
            "source": FORMS[compute_dtype][1],
            "replaces": REPLACES,
            "also_replaces": ALSO_REPLACES,
            "compute_dtype": str(compute_dtype)[6:],
            "launches": launches_total,
            "max_abs_err": err,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library": main["library"],
            "by_shape": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}
                         for k, r in rows.items()},
        }

    int8_rows = {"dense_upper": dense_row, "square_all": square_row,
                 "rect_all": rect_row, "tiled_upper": tiled_modes["upper"],
                 "tiled_all": tiled_modes["all"]}
    bf16_rows = {"dense_upper": results_bf16[0], "square_all": results_bf16[1],
                 "rect_all": results_bf16[2],
                 "tiled_upper": tiled_modes_bf16["upper"],
                 "tiled_all": tiled_modes_bf16["all"]}
    int8_entry = kernel_entry("gram_int8_tiles", torch.int8,
                              sum(c["total"] for c in launches.values()),
                              max_err, int8_rows)
    int8_entry["launches_by_path"] = launches
    int8_entry["dense_chunks_by_path"] = chunks
    print(json.dumps({"kernels": [
        int8_entry,
        kernel_entry("gram_bf16_tiles", torch.bfloat16, bf16_launches,
                     max_err_bf16, bf16_rows),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
