"""kspider_tpu_torch's multi-process pairwise vs kspider_tpu's single-process
output.

Real coordinated OS processes, each importing only the port (never jax),
form a gloo group on a free local port and run the three partitionings:
color slices (also through the CLI), panel rows and hash ranges.  The TSVs
that process 0 writes must equal, byte for byte, kspider_tpu's
single-process TSVs of the same index.  The numpy helpers the port
re-homes are held equal to kspider_tpu's.  Every worker has 180 s: a
rendezvous that hangs fails its test instead of stalling the suite.
"""

import filecmp
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from kspider_tpu.core import pairwise as jcore_pairwise
from kspider_tpu.core.index import build_index_from_hash_sets
from kspider_tpu.io import artifacts as artifacts_io
from kspider_tpu.ops import tiled_pairwise as jtp
from kspider_tpu.parallel import distributed as jdist
from kspider_tpu.parallel import multiprocess as jmp
from kspider_tpu_torch.ops import tiled_pairwise as ttp
from kspider_tpu_torch.parallel import distributed as tdist
from kspider_tpu_torch.parallel import multiprocess as tmulti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL = 16
BLOCK = 128

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    from kspider_tpu_torch.parallel import multiprocess as mp

    mode, pid, nproc, port, prefix = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5],
    )
    extra = sys.argv[6:]
    coord = f"localhost:{{port}}"
    if mode == "hashrange":
        from kspider_tpu_torch.parallel import distributed

        top = 2**64 // int(extra[0]) if extra else 2**64
        rng = np.random.default_rng(123)
        names = [f"s{{i}}" for i in range(9)]
        pool = np.unique(rng.integers(0, top, size=2000, dtype=np.uint64))
        arrays = [
            np.unique(np.concatenate([
                rng.integers(0, top, size=3000, dtype=np.uint64),
                pool[rng.random(len(pool)) < 0.5]]))
            for _ in names
        ]
        lo, hi = distributed.my_hash_range(arrays, pid, nproc)
        print("HASHES", pid, sum(len(distributed.filter_to_range(a, lo, hi))
                                 for a in arrays))
        mp.distributed_pairwise_from_hash_sets(
            names, arrays, prefix, ksize=21, device="cpu",
            coordinator=coord, num_processes=nproc, process_id=pid,
        )
    elif mode == "tiled":
        mp.run_distributed_tiled_pairwise(
            prefix, device="cpu", panel={panel}, block={block},
            coordinator=coord, num_processes=nproc, process_id=pid,
            echo_timers=False,
        )
    elif mode == "cli":
        from kspider_tpu_torch.cli.main import cli

        cli.main(["pairwise", "-i", prefix, "--device", "cpu",
                  "--coordinator", coord, "--num-processes", str(nproc),
                  "--process-id", str(pid), *extra], standalone_mode=False)
        import torch.distributed as dist
        assert not dist.is_initialized(), "the CLI leaves no process group"
    else:
        merged = mp.run_distributed_pairwise(
            prefix, device="cpu", coordinator=coord, num_processes=nproc,
            process_id=pid, echo_timers=False,
        )
        assert merged.dtype == np.int64
        # negative int64 is refused before any exchange, as in kspider_tpu
        try:
            mp.psum_across_processes(-np.ones(3, dtype=np.int64))
            raise SystemExit("negative int64 was not refused")
        except ValueError:
            pass
        for dtype in (np.int64, np.int32):
            local = np.full(5, pid + 1, dtype=dtype)
            total = mp.psum_across_processes(local)
            assert total.dtype == dtype and (local == pid + 1).all()
            assert (total == nproc * (nproc + 1) // 2).all(), total
    assert "jax" not in sys.modules, "the port imported jax"
    print("WORKER_OK", pid)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dataset(scale=1):
    """The workers' hash sets: nine samples that share a common pool, every
    hash below 2**64 / scale (a FracMinHash sketch's, for scale > 1)."""
    rng = np.random.default_rng(123)
    names = [f"s{i}" for i in range(9)]
    top = 2**64 // scale
    pool = np.unique(rng.integers(0, top, size=2000, dtype=np.uint64))
    arrays = [
        np.unique(np.concatenate([
            rng.integers(0, top, size=3000, dtype=np.uint64),
            pool[rng.random(len(pool)) < 0.5]]))
        for _ in names
    ]
    return names, arrays


def _index(scale=1):
    names, arrays = _dataset(scale)
    return build_index_from_hash_sets(names, arrays, ksize=21,
                                      params="kSize:21")


def _run_once(script, tmp_path, mode, prefix, nproc, extra):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), mode, str(pid), str(nproc),
             str(port), prefix, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=str(tmp_path),
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 and f"WORKER_OK {pid}" in out
             for pid, (p, out) in enumerate(zip(procs, outs)))
    return ok, procs, outs


def _spawn_workers(tmp_path, mode, prefix, nproc=2, extra=()):
    """Run ``nproc`` coordinated workers; one retry with a fresh port
    absorbs the race between releasing a free port and the rendezvous
    binding it (a deterministic failure fails twice)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, panel=PANEL, block=BLOCK))
    for _ in range(2):
        ok, procs, outs = _run_once(script, tmp_path, mode, prefix, nproc,
                                    list(extra))
        if ok:
            return outs
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK {pid}" in out
    return outs


def _golden_dense(tmp_path, index):
    prefix = str(tmp_path / "golden")
    shared = jcore_pairwise.compute_shared_matrix(index, use_tpu=False)
    jcore_pairwise.write_seq_to_kmers_tsv(prefix, index)
    jcore_pairwise.write_pairwise_tsv(prefix, index, shared)
    return prefix


def _assert_same(got_prefix, want_prefix, tmp_path):
    for suffix in ("_kSpider_pairwise.tsv", "_kSpider_seqToKmersNo.tsv"):
        assert filecmp.cmp(got_prefix + suffix, want_prefix + suffix,
                           shallow=False), suffix
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".part")]


# ---- spawned processes --------------------------------------------------------


@pytest.mark.parametrize("nproc", [2, 3])
def test_hashrange_processes_match_jax_single(tmp_path, nproc):
    golden = _golden_dense(tmp_path, _index())
    prefix = str(tmp_path / "dist")
    _spawn_workers(tmp_path, "hashrange", prefix, nproc=nproc)
    _assert_same(prefix, golden, tmp_path)


@pytest.mark.parametrize("nproc,scale", [(2, 1000), (3, 1000), (4, 1000),
                                         (3, 100_000)])
def test_hash_ranges_split_scaled_sketches(tmp_path, nproc, scale):
    """Every hash below 2**64 / scale, as a FracMinHash sketch's: each rank
    gets its share of the postings (the even u64 split gave them all to
    rank 0), and the TSVs equal kspider_tpu's single-process ones."""
    names, arrays = _dataset(scale)
    assert max(int(a.max()) for a in arrays) < 2**64 // scale
    golden = _golden_dense(tmp_path, _index(scale))
    prefix = str(tmp_path / "dist")
    outs = _spawn_workers(tmp_path, "hashrange", prefix, nproc=nproc,
                          extra=[str(scale)])
    counts = [int(line.split()[2]) for out in outs
              for line in out.splitlines() if line.startswith("HASHES ")]
    total = sum(len(a) for a in arrays)
    assert len(counts) == nproc and sum(counts) == total
    # a quantile cut moves at most the samples sharing one hash
    assert all(abs(c - total / nproc) <= len(arrays) + 1 for c in counts), counts
    _assert_same(prefix, golden, tmp_path)


def test_colorslice_two_processes_match_jax_single(tmp_path):
    index = _index()
    golden = _golden_dense(tmp_path, index)
    prefix = str(tmp_path / "dist")
    artifacts_io.write_index_artifacts(prefix, index)
    _spawn_workers(tmp_path, "colorslice", prefix)
    _assert_same(prefix, golden, tmp_path)


def test_tiled_two_processes_match_jax_stream(tmp_path):
    index = _index()
    golden = str(tmp_path / "golden")
    jtp.stream_pairwise_tsv(index, golden, panel=PANEL, engine="xla",
                            block=BLOCK)
    jcore_pairwise.write_seq_to_kmers_tsv(golden, index)
    prefix = str(tmp_path / "dist")
    artifacts_io.write_index_artifacts(prefix, index)
    _spawn_workers(tmp_path, "tiled", prefix)
    _assert_same(prefix, golden, tmp_path)


@pytest.mark.parametrize("extra", [[], ["--engine", "tiled", "--panel", "4"]])
def test_cli_two_processes_match_jax_single(tmp_path, extra):
    """``pairwise --num-processes 2 --process-id R --coordinator H:P`` runs
    (the port exited 1 on it before) and writes kspider_tpu's bytes."""
    index = _index()
    golden = _golden_dense(tmp_path, index)
    prefix = str(tmp_path / "dist")
    artifacts_io.write_index_artifacts(prefix, index)
    _spawn_workers(tmp_path, "cli", prefix, extra=extra)
    _assert_same(prefix, golden, tmp_path)


# ---- one process ----------------------------------------------------------------


def test_multiprocess_rejects_tiled_engine(tmp_path):
    with pytest.raises(ValueError, match="single-process"):
        jmp.run_distributed_pairwise(str(tmp_path / "x"), engine="tiled")
    with pytest.raises(ValueError, match="single-process"):
        tmulti.run_distributed_pairwise(str(tmp_path / "x"), device="cpu",
                                     engine="tiled")


@pytest.mark.parametrize("run", ["run_distributed_pairwise",
                                 "run_distributed_tiled_pairwise"])
def test_multiprocess_refuses_a_device_list(tmp_path, run):
    with pytest.raises(ValueError, match="one device per process"):
        getattr(tmulti, run)(str(tmp_path / "x"), device="cpu,cpu")


def test_tiled_cleans_stale_parts_from_smaller_panel_runs(tmp_path):
    """A crashed run with a smaller --panel leaves row parts beyond the new
    plan's n_panels; process 0 must remove them all."""
    index = _index()
    prefix = str(tmp_path / "stale")
    artifacts_io.write_index_artifacts(prefix, index)
    orphan = tmulti._part_path(prefix, 37)
    assert orphan == jmp._part_path(prefix, 37)
    with open(orphan, "w") as f:
        f.write("stale\n")
    golden = str(tmp_path / "golden")
    jtp.stream_pairwise_tsv(index, golden, panel=PANEL, engine="xla",
                            block=BLOCK)
    jcore_pairwise.write_seq_to_kmers_tsv(golden, index)
    rows = tmulti.run_distributed_tiled_pairwise(
        prefix, index=index, device="cpu", panel=PANEL, block=BLOCK,
        echo_timers=False,
    )
    assert rows > 0
    assert not os.path.exists(orphan)
    _assert_same(prefix, golden, tmp_path)


def test_single_process_helpers():
    assert tdist.process_info() == (0, 1)
    local = np.arange(6, dtype=np.int64).reshape(2, 3)
    merged = tmulti.psum_across_processes(local)
    assert merged is not local and np.array_equal(merged, local)
    tmulti.barrier()  # no group: returns at once
    assert tmulti.initialize() == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="process id"):
        tdist.initialize("localhost:1", 2, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nproc", [1, 3, 5])
def test_assign_panel_rows_matches_jax(seed, nproc):
    work = np.random.default_rng(seed).integers(0, 1000, size=23)
    work[::5] = work[0]  # ties
    want = jmp.assign_panel_rows(work, nproc)
    got = tmulti.assign_panel_rows(work, nproc)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_assign_panel_rows_over_a_plan_partitions_it():
    from tests.test_pairwise_ops import random_csr

    o, m, w = random_csr(np.random.default_rng(3), 400, 700, max_degree=9,
                         max_weight=500)
    plan = ttp.build_panel_plan(o, m, w, 700, panel=128)
    owner = tmulti.assign_panel_rows(ttp.panel_row_work(plan), 3)
    seen, entries = [], 0
    for q in range(3):
        sub = ttp.filter_plan_rows(plan, np.flatnonzero(owner == q))
        seen.extend(sub.pair_keys.tolist())
        entries += int(sub.pair_off[-1])
    assert sorted(seen) == plan.pair_keys.tolist()
    assert entries == int(plan.pair_off[-1])


@pytest.mark.parametrize("n_colors,nproc", [(10, 3), (7, 7), (5, 8), (0, 2),
                                            (100, 1), (1001, 6)])
def test_color_slice_matches_jax(n_colors, nproc):
    slices = [tmulti.color_slice(n_colors, p, nproc) for p in range(nproc)]
    assert slices == [jmp.color_slice(n_colors, p, nproc) for p in range(nproc)]
    assert slices[0][0] == 0 and slices[-1][1] == n_colors
    assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))


def test_resolve_flags_matches_jax(monkeypatch):
    assert tmulti.resolve_flags() == jmp.resolve_flags() == (None, 1, None)
    monkeypatch.setenv(tmulti.ENV_COORDINATOR, "host:1234")
    monkeypatch.setenv(tmulti.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(tmulti.ENV_PROCESS_ID, "2")
    assert tmulti.resolve_flags() == jmp.resolve_flags() == ("host:1234", 4, 2)
    assert tmulti.resolve_flags("h:1", 2, 0) == jmp.resolve_flags("h:1", 2, 0) \
        == ("h:1", 2, 0)


@pytest.mark.parametrize("nproc", [1, 2, 3, 7])
def test_hash_range_bounds_partition_the_postings(nproc):
    """The ranges cover the u64 space, hold every posting once, about
    1 / nproc each; kspider_tpu's range filter and merge agree."""
    rng = np.random.default_rng(nproc)
    arrays = [np.unique(rng.integers(0, 2**54, size=n, dtype=np.uint64))
              for n in rng.integers(100, 3000, size=6)]
    arrays += [None, np.array([0, 2**63, 2**64 - 1], dtype=np.uint64)]
    bounds = tdist.hash_range_bounds(arrays, nproc)
    assert bounds[0] == 0 and bounds[-1] == 2**64 and bounds == sorted(bounds)
    total = sum(len(a) for a in arrays if a is not None)
    parts = []
    for pid in range(nproc):
        lo, hi = tdist.my_hash_range(arrays, pid, nproc)
        assert (lo, hi) == (bounds[pid], bounds[pid + 1])
        got = [tdist.filter_to_range(a, lo, hi) for a in arrays if a is not None]
        for a, g in zip([a for a in arrays if a is not None], got):
            assert np.array_equal(g, jdist.filter_to_range(a, lo, hi))
        assert abs(sum(map(len, got)) - total / nproc) <= len(arrays) + 1
        parts += got
    assert np.array_equal(np.sort(np.concatenate(parts)),
                          np.sort(np.concatenate([a for a in arrays
                                                  if a is not None])))
    mats = [np.full((3, 3), p, dtype=np.int64) for p in range(nproc)]
    assert np.array_equal(tdist.merge_partial_matrices(mats),
                          jdist.merge_partial_matrices(mats))
