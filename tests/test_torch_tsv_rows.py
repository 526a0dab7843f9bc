"""The port's multi-threaded dense pairwise TSV writer (``io/tsv_rows``).

Its file must equal, byte for byte, what kspider_tpu's native one-thread
writer and the port's pure-Python writer give for the same matrix, at every
thread count and slot size, and the row count it returns must be the number
of qualifying pairs.  The library is built by the host C++ compiler alone.
"""

import ctypes
import filecmp
import logging
import os
import shutil
import threading

import numpy as np
import pytest

from kspider_tpu.io import native as j_native
from kspider_tpu_torch.core import index as t_index
from kspider_tpu_torch.core import pairwise as t_pairwise
from kspider_tpu_torch.io import native as t_native
from kspider_tpu_torch.io import tsv_rows


def shared_matrix(rng, n, *, big=False, species=8):
    """Symmetric int64 matrix with species blocks of large counts and
    scattered small cross counts; ``big`` lifts every count above 2**31."""
    s = np.zeros((n, n), dtype=np.int64)
    ids = rng.permutation(n)
    for start in range(0, n, species):
        g = ids[start:start + species]
        s[np.ix_(g, g)] = rng.integers(500, 6000, size=(len(g), len(g)))
    cross = rng.random((n, n)) < 0.05
    s[cross] = rng.integers(1, 9, size=int(cross.sum()))
    if big:
        s[s > 0] += 3 * 2**31
    s = np.triu(s, 1)
    s = s + s.T
    np.fill_diagonal(s, 7000)
    return s


def index_of(counts):
    n = len(counts)
    return t_index.ColorIndex(
        names=[f"g{i}" for i in range(n)],
        group_kmer_count=np.asarray(counts, dtype=np.int64),
        color_ids=np.empty(0, np.uint64),
        color_offsets=np.zeros(1, np.int64),
        color_members=np.empty(0, np.int32),
        color_counts=np.empty(0, np.int64),
    )


# (n, min_shared, threads, slot_bytes, matrix): threads 0 is the CPUs the
# process may use, slot_bytes 0 the writer's own slots (1 MiB)
CASES = {
    "no_rows": (100, 1, 0, 0, "zeros"),
    "min_shared_1": (300, 1, 0, 0, "species"),
    "min_shared_above_1": (300, 9, 0, 0, "species"),
    "n_1": (1, 1, 0, 0, "species"),
    "n_2": (2, 1, 0, 0, "species"),
    "n_not_a_block_multiple": (197, 1, 3, 0, "species"),
    "zero_kmer_count": (150, 1, 0, 0, "zero_counts"),
    "shared_above_2_31": (150, 1, 0, 0, "big"),
    "threads_1": (300, 1, 1, 0, "species"),
    "threads_2": (300, 1, 2, 0, "species"),
    "threads_above_blocks": (130, 1, 50, 0, "species"),
    "slot_overflows": (300, 1, 4, 512, "dense"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_tsv_bytes_equal_native_and_python(tmp_path, monkeypatch, case):
    n, min_shared, threads, slot_bytes, kind = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if kind == "zeros":
        s = np.zeros((n, n), dtype=np.int64)
    elif kind == "dense":
        s = rng.integers(1, 10**6, size=(n, n), dtype=np.int64)
    else:
        s = shared_matrix(rng, n, big=kind == "big")
    counts = rng.integers(3000, 9000, size=n).astype(np.int64)
    if kind == "big":
        counts += 4 * 2**31
    if kind == "zero_counts":
        counts[::7] = 0

    got = str(tmp_path / "got.tsv")
    rows = tsv_rows.write_dense(got, s, counts, min_shared, threads=threads,
                                slot_bytes=slot_bytes)
    assert rows == int(np.count_nonzero(np.triu(s >= min_shared, 1)))
    if slot_bytes:
        assert os.path.getsize(got) > 5 * slot_bytes  # refilled several times

    j_native.write_pairwise_tsv(str(tmp_path / "native.tsv"), s, counts,
                                min_shared=min_shared)
    assert filecmp.cmp(got, tmp_path / "native.tsv", shallow=False)

    monkeypatch.setenv("KSPIDER_NATIVE", "off")
    py_rows = t_pairwise.write_pairwise_tsv(str(tmp_path / "py"), index_of(counts),
                                            s, min_shared=min_shared)
    assert py_rows == rows
    assert filecmp.cmp(got, tmp_path / "py_kSpider_pairwise.tsv", shallow=False)


def test_many_threads_and_tiny_slots_finish_in_order(tmp_path):
    """More threads than cores, each slot two rows: every hand-over of a
    slot to the writer takes a wait.  Each write finishes within its time
    and gives the native writer's bytes."""
    s = shared_matrix(np.random.default_rng(17), 1100)
    counts = np.full(1100, 4000, dtype=np.int64)
    j_native.write_pairwise_tsv(str(tmp_path / "native.tsv"), s, counts)
    threads = 2 * (os.cpu_count() or 1) + 3
    for rep in range(2):
        path = str(tmp_path / f"{rep}.tsv")
        done = []
        worker = threading.Thread(target=lambda: done.append(tsv_rows.write_dense(
            path, s, counts, threads=threads, slot_bytes=400)))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and len(done) == 1
        assert filecmp.cmp(path, tmp_path / "native.tsv", shallow=False)


def test_threads_follow_the_blocks(tmp_path, caplog):
    """More threads than 64-row blocks run one thread a block; the debug
    line names rows, bytes and threads."""
    s = shared_matrix(np.random.default_rng(5), 130)
    counts = np.full(130, 5000, dtype=np.int64)
    path = str(tmp_path / "t.tsv")
    with caplog.at_level(logging.DEBUG, logger=tsv_rows.__name__):
        rows = tsv_rows.write_dense(path, s, counts, threads=50)
    (record,) = [r for r in caplog.records if r.name == tsv_rows.__name__]
    assert record.getMessage() == (
        f"pairwise TSV {path}: {rows} rows, {os.path.getsize(path)} bytes, 3 threads"
    )


def test_library_builds_with_the_host_compiler_alone(tmp_path, monkeypatch):
    """No nvcc on PATH and no CUDA_HOME: the host compiler builds the library
    into its hashed file, which exports the writer."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(d, "nvcc"))
    ))
    assert shutil.which("nvcc") is None
    monkeypatch.setattr(tsv_rows, "BUILD_DIR", str(tmp_path))
    path = tsv_rows.build()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("libkspider_tsv_")
    assert ctypes.CDLL(path).ks_tsv_write_dense is not None


def test_writer_declares_its_signature():
    fn = tsv_rows.library().ks_tsv_write_dense
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    assert fn.restype is i64
    assert fn.argtypes == [
        ctypes.c_char_p, ctypes.c_void_p, i64, ctypes.c_void_p, i64, i32, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i32),
    ]


def test_failed_open_raises(tmp_path):
    s = np.ones((4, 4), dtype=np.int64)
    with pytest.raises(OSError, match="code -2"):
        tsv_rows.write_dense(str(tmp_path / "no" / "dir.tsv"), s, np.ones(4, np.int64))


def test_stage_takes_the_writer_or_reports_the_fallback(tmp_path, monkeypatch, caplog):
    """write_pairwise_tsv runs the port's writer (its debug line, no
    warning); where the library cannot load it warns once and writes the
    same bytes, and under KSPIDER_NATIVE=force it raises."""
    rng = np.random.default_rng(11)
    s = shared_matrix(rng, 90)
    index = index_of(rng.integers(3000, 9000, size=90))
    monkeypatch.setattr(t_native, "_warned_fallbacks", set())
    with caplog.at_level(logging.DEBUG, logger=tsv_rows.__name__):
        rows = t_pairwise.write_pairwise_tsv(str(tmp_path / "new"), index, s)
    assert [r.name for r in caplog.records] == [tsv_rows.__name__]

    def unavailable():
        raise RuntimeError("no host compiler")

    monkeypatch.setattr(tsv_rows, "library", unavailable)
    with pytest.warns(RuntimeWarning, match="tsv_rows.write_dense"):
        assert t_pairwise.write_pairwise_tsv(str(tmp_path / "old"), index, s) == rows
    assert filecmp.cmp(tmp_path / "new_kSpider_pairwise.tsv",
                       tmp_path / "old_kSpider_pairwise.tsv", shallow=False)
    monkeypatch.setenv("KSPIDER_NATIVE", "force")
    with pytest.raises(t_native.NativeRequiredError):
        t_pairwise.write_pairwise_tsv(str(tmp_path / "forced"), index, s)
