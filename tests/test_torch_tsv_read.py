"""The port's multi-threaded pairwise TSV reader (``io/tsv_rows.read_pairwise``).

Every chunk it yields must equal what kspider_tpu's pandas reader
(``kspider_tpu.io.pairwise_tsv``) yields for the same file and chunk size:
the same dtypes, the same values bit for bit, the same chunking.  That holds
for each distance column, for the ani column file, at every thread count,
and for windows so small that rows straddle the windows and the threads'
ranges.  Where the library cannot load, the stage reads with pandas and
says so.
"""

import ctypes
import logging
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from kspider_tpu.core import cluster as j_cluster
from kspider_tpu.io import pairwise_tsv as j_tsv
from kspider_tpu_torch.core import cluster as t_cluster
from kspider_tpu_torch.io import native as t_native
from kspider_tpu_torch.io import pairwise_tsv as t_tsv
from kspider_tpu_torch.io import tsv_rows

HEADER = ("source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\t"
          "max_containment\n")
BIG = 10**9  # a chunk larger than any file here


def write_rows(path, rows, header=HEADER):
    with open(path, "w") as f:
        f.write(header)
        f.writelines("\t".join(str(x) for x in r) + "\n" for r in rows)
    return str(path)


def dense_tsv(path, n, seed):
    """A pairwise TSV as the port's writer prints it: %g containments."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6000, size=(n, n), dtype=np.int64)
    s[rng.random((n, n)) < 0.3] = 0
    s = np.triu(s, 1)
    tsv_rows.write_dense(str(path), s + s.T, rng.integers(3000, 9000, size=n))
    return str(path)


def assert_same_chunks(got, want):
    got, want = list(got), list(want)
    assert [len(c[0]) for c in got] == [len(c[0]) for c in want]
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype
            assert x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def small_tsv(tmp_path_factory):
    """About 560 rows."""
    return dense_tsv(tmp_path_factory.mktemp("read") / "s_kSpider_pairwise.tsv",
                     40, 3)


@pytest.fixture(scope="module")
def mid_tsv(tmp_path_factory):
    """About 12,000 rows, 440 KB: a hundred times a 4 KiB window."""
    return dense_tsv(tmp_path_factory.mktemp("read") / "m_kSpider_pairwise.tsv",
                     180, 4)


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("chunk_rows", [1, 7, 256, BIG])
@pytest.mark.parametrize("dist_col", [3, 4, 5])
def test_chunks_equal_pandas(small_tsv, dist_col, chunk_rows, threads):
    assert_same_chunks(
        tsv_rows.read_pairwise(small_tsv, dist_col, None, chunk_rows, threads=threads),
        j_tsv.iter_pairwise_chunks(small_tsv, dist_col, chunk_rows=chunk_rows))


@pytest.mark.parametrize("window_bytes,threads,chunk_rows", [
    (128, 8, 256), (100, 3, 7), (333, 8, BIG), (4096, 8, 1000), (4096, 2, BIG),
    (4096, 40, 500)])
def test_small_windows_on_a_large_file_give_pandas_chunks(
        mid_tsv, window_bytes, threads, chunk_rows):
    """Rows straddle the windows and the threads' ranges (40 threads: more
    than the cores); the reader's buffer is the window, a hundredth of the
    file or less."""
    assert os.path.getsize(mid_tsv) > 100 * window_bytes
    with tsv_rows._Reader(mid_tsv, True, 5, threads, window_bytes) as r:
        assert r.window == max(64, window_bytes)
    assert_same_chunks(
        tsv_rows.read_pairwise(mid_tsv, 5, None, chunk_rows, threads=threads,
                               window_bytes=window_bytes),
        j_tsv.iter_pairwise_chunks(mid_tsv, 5, chunk_rows=chunk_rows))


@pytest.mark.parametrize("threads,window_bytes,window", [
    (64, 0, 32 << 20), (2, 0, 8 << 20), (8, 1 << 30, 32 << 20), (1, 10, 64)])
def test_window_is_bounded_whatever_the_file(tmp_path, threads, window_bytes, window):
    """A file of 100 MiB takes a window of 4 MiB a thread, at most
    ``READ_WINDOW_MAX``; a line longer than the window raises."""
    path = tmp_path / "sparse.tsv"
    with open(path, "wb") as f:
        f.truncate(100 << 20)
    with tsv_rows._Reader(str(path), True, 5, threads, window_bytes) as r:
        assert r.window == window <= tsv_rows.READ_WINDOW_MAX
        with pytest.raises(ValueError, match=f"line 1 is longer than the reader's "
                                             f"window of {window} bytes"):
            r.next(10)


@pytest.mark.parametrize("threads", [1, 8])
def test_17_digit_and_cutoff_values_parse_as_float(tmp_path, threads):
    """repr() of random doubles (17 significant digits, where pandas' fast
    parser is 1 ulp off) and %g values printed exactly on a cutoff: each
    column is Python's float() of its text, as pandas' round_trip gives."""
    rng = np.random.default_rng(21)
    reprs = [repr(float(v)) for v in rng.random(3000)]
    reprs += [repr(float(np.nextafter(0.6, d))) for d in (0.0, 1.0)] + ["0.6"]
    on_cut = [f"{v:g}" for v in (0.6, 0.55, 0.9, 0.3, 1.0)] * 40
    rows = [(i + 1, i + 2, 10, a, b, c) for i, (a, b, c)
            in enumerate(zip(reprs, on_cut * 20, reversed(reprs)))]
    path = write_rows(tmp_path / "x_kSpider_pairwise.tsv", rows)
    for col in (3, 4, 5):
        got = list(tsv_rows.read_pairwise(path, col, None, 500, threads=threads,
                                          window_bytes=2048))
        assert_same_chunks(got, j_tsv.iter_pairwise_chunks(path, col, chunk_rows=500))
        want = np.array([float(r[col]) for r in rows])
        assert np.concatenate([c[2] for c in got]).tobytes() == want.tobytes()


@pytest.mark.parametrize("dist_type,cutoff", [
    ("max_cont", 60.0), ("min_cont", 55.00000000000001), ("avg_cont", 90.0)])
def test_thresholded_edges_equal_the_jax_package(tmp_path, dist_type, cutoff):
    rng = np.random.default_rng(8)
    vals = [f"{v:g}" for v in (0.6, 0.55, 0.9)] + [
        repr(float(np.nextafter(x, d))) for x in (0.6, 0.55, 0.9) for d in (0, 1)]
    rows = [(rng.integers(1, 50), rng.integers(1, 50), 10,
             *(vals[k] for k in rng.integers(0, len(vals), size=3)))
            for _ in range(2000)]
    prefix = str(tmp_path / "x")
    write_rows(prefix + "_kSpider_pairwise.tsv", rows)
    for chunk_rows in (333, BIG):
        got = t_cluster.load_pairwise_edges(prefix, dist_type, cutoff, chunk_rows)
        want = j_cluster.load_pairwise_edges(prefix, dist_type, cutoff, chunk_rows)
        assert len(got[0]) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def ani_files(tmp_path, n_pw, n_ani):
    rng = np.random.default_rng(n_pw + n_ani)
    pw = write_rows(tmp_path / "x_kSpider_pairwise.tsv",
                    [(i + 1, i + 2, 10, 0.5, 0.5, 0.5) for i in range(n_pw)])
    ani = tmp_path / "x_kSpider_pairwise.ani_col.tsv"
    ani.write_text("avg_ani\n" + "".join(f"{float(v)!r}\n" for v in rng.random(n_ani)))
    return pw, str(ani)


@pytest.mark.parametrize("n,chunk_rows,threads", [
    (0, 256, 8), (1000, 256, 8), (1000, 1000, 2), (999, 7, 1)])
def test_ani_file_equal_pandas(tmp_path, n, chunk_rows, threads):
    pw, ani = ani_files(tmp_path, n, n)
    assert_same_chunks(
        tsv_rows.read_pairwise(pw, 99, ani, chunk_rows, threads=threads,
                               window_bytes=1024),
        j_tsv.iter_pairwise_chunks(pw, 99, ani, chunk_rows=chunk_rows))


@pytest.mark.parametrize("n_pw,n_ani", [(1000, 0), (1000, 5), (1000, 512),
                                        (1000, 999), (1, 3), (0, 2)])
def test_ani_row_mismatch_raises_the_same_error(tmp_path, n_pw, n_ani):
    pw, ani = ani_files(tmp_path, n_pw, n_ani)
    with pytest.raises(ValueError, match="row-aligned") as want:
        list(j_tsv.iter_pairwise_chunks(pw, 99, ani, chunk_rows=256))
    with pytest.raises(ValueError) as got:
        list(tsv_rows.read_pairwise(pw, 99, ani, 256, threads=4))
    assert str(got.value) == str(want.value)


ROW = "1\t2\t5\t0.1\t0.2\t0.3\n"
#: files the pandas reader reads, each with the rows it gives
EDGE_FILES = {
    "header_only": HEADER,
    "empty": "",
    "header_without_newline": HEADER[:-1],
    "last_line_without_newline": HEADER + ROW + "3\t4\t6\t0.5\t0.25\t0.75",
    "blank_lines": "\n" + HEADER + ROW + "\n  \n\r\n" + ROW + "\n\n",
    "crlf": (HEADER + ROW * 3).replace("\n", "\r\n"),
    "a_blank_line_after_each_row": HEADER + (ROW + "\n") * 7,
    "a_row_with_an_extra_column": HEADER + ROW + ROW.replace("\n", "\t9\n"),
    "inf_and_nan": HEADER + "1\t2\t0\tinf\tinf\tnan\n",
    "rows_a_chunk_multiple": HEADER + ROW * 6,
}


@pytest.mark.parametrize("case", list(EDGE_FILES))
@pytest.mark.parametrize("threads", [1, 8])
def test_edge_files_equal_pandas(tmp_path, case, threads):
    path = tmp_path / "e.tsv"
    path.write_text(EDGE_FILES[case], newline="")
    got = list(tsv_rows.read_pairwise(str(path), 5, None, 3, threads=threads))
    want = list(j_tsv.iter_pairwise_chunks(str(path), 5, chunk_rows=3))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


#: (file, the line the reader names): rows with a missing, empty or
#: non-numeric field
BAD_FILES = {
    "truncated_last_row": (HEADER + ROW * 3 + "1\t2\t5\t0.1", 5),
    "truncated_after_an_id": (HEADER + ROW + "1\t", 3),
    "empty_distance": (HEADER + ROW * 2 + "1\t2\t5\t0.1\t0.2\t\n" + ROW, 4),
    "word_for_an_id": (HEADER + ROW + "one\t2\t5\t0.1\t0.2\t0.3\n", 3),
    "trailing_text": (HEADER + ROW + "1\t2\t5\t0.1\t0.2\t0.3x\n", 3),
    "tab_line_after_a_blank": (HEADER + ROW + "\n\t\n" + ROW, 4),
    "first_of_two_bad_rows": (HEADER + ROW * 300 + "1\tx\n" + ROW * 300 + "x\n", 302),
}


@pytest.mark.parametrize("case", list(BAD_FILES))
@pytest.mark.parametrize("threads", [1, 8])
def test_bad_rows_raise_with_their_line(tmp_path, case, threads):
    text, line = BAD_FILES[case]
    path = tmp_path / "bad.tsv"
    path.write_text(text)
    with pytest.raises(ValueError,
                       match=f"bad.tsv: line {line}: missing or non-numeric"):
        list(tsv_rows.read_pairwise(str(path), 5, None, 1000, threads=threads,
                                    window_bytes=256))


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(tsv_rows.read_pairwise(str(tmp_path / "none.tsv"), 5, None, 10))


def test_debug_line_names_rows_bytes_and_threads(small_tsv, caplog):
    with caplog.at_level(logging.DEBUG, logger=tsv_rows.__name__):
        rows = sum(len(c[0]) for c in tsv_rows.read_pairwise(
            small_tsv, 5, None, 100, threads=3))
    (record,) = [r for r in caplog.records if r.name == tsv_rows.__name__]
    assert record.getMessage() == (f"pairwise TSV read {small_tsv}: {rows} rows, "
                                   f"{os.path.getsize(small_tsv)} bytes, 3 threads")


def test_reader_declares_its_signature():
    lib = tsv_rows.library()
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    assert lib.ks_tsv_read_open.restype is vp
    assert lib.ks_tsv_read_open.argtypes == [
        ctypes.c_char_p, i32, i32, i32, i64, ctypes.POINTER(i32),
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32)]
    assert lib.ks_tsv_read_left.argtypes == [vp]
    assert lib.ks_tsv_read_next.restype is i64
    assert lib.ks_tsv_read_next.argtypes == [vp, i64, vp, vp, vp, ctypes.POINTER(i64)]
    assert lib.ks_tsv_read_close.argtypes == [vp]


def range_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_stage_takes_the_reader_or_reports_the_fallback(small_tsv, monkeypatch):
    """The stage's reader is the library's: ``kspider.tsv_read_pandas`` never
    opens.  Where the library cannot load, pandas gives the same chunks under
    that range, with a warning; under KSPIDER_NATIVE=force it raises."""
    monkeypatch.setattr(t_native, "_warned_fallbacks", set())
    want = list(j_tsv.iter_pairwise_chunks(small_tsv, 4, chunk_rows=50))
    got, names = range_names(
        lambda: list(t_tsv.iter_pairwise_chunks(small_tsv, 4, chunk_rows=50)))
    assert_same_chunks(got, want)
    assert "kspider.tsv_read_pandas" not in names

    def unavailable():
        raise RuntimeError("no host compiler")

    monkeypatch.setattr(tsv_rows, "library", unavailable)
    with pytest.warns(RuntimeWarning, match="tsv_rows.read_pairwise"):
        got, names = range_names(
            lambda: list(t_tsv.iter_pairwise_chunks(small_tsv, 4, chunk_rows=50)))
    assert_same_chunks(got, want)
    assert "kspider.tsv_read_pandas" in names
    monkeypatch.setenv("KSPIDER_NATIVE", "force")
    with pytest.raises(t_native.NativeRequiredError):
        list(t_tsv.iter_pairwise_chunks(small_tsv, 4))
