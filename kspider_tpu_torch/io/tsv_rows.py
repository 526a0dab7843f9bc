"""The port's multi-threaded writer and reader of the pairwise TSV.

``csrc/tsv_rows.cpp`` writes the bytes of ``native/``'s
``ks_write_pairwise_tsv`` from the int64 shared matrix: blocks of source
rows formatted with ``std::to_chars`` on every CPU the process may use,
written in order with ``write(2)``, in at most 32 MiB of buffers whatever
N; and :func:`read_pairwise` parses that TSV (or the ani column file) back
on the same CPUs, in at most 32 MiB of buffers a file.  It is host code,
compiled by the host C++ compiler (``$CXX``, else ``g++``) into
``kspider_tpu_torch/build/`` at first use, under a name that carries a hash
of the source, the compiler and the flags, and loaded with ``ctypes``.
Nothing is compiled at import time.
"""

import ctypes
import functools
import logging
import os

import numpy as np

from kspider_tpu_torch.ops import _build

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tsv_rows.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

_log = logging.getLogger(__name__)


def build() -> str:
    """Compile the source unless the hashed library exists; returns its path."""
    return _build.build_host(BUILD_DIR, "libkspider_tsv", SOURCE)


@functools.lru_cache(maxsize=None)
def _load():
    """(library, None) once built and bound, else (None, the exception):
    a failed build is tried once a process."""
    try:
        lib = ctypes.CDLL(build())
    except Exception as exc:
        return None, exc
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    # path, s, n, kmer_counts, min_shared, threads, slot_bytes, bytes_out,
    # threads_out
    lib.ks_tsv_write_dense.restype = i64
    lib.ks_tsv_write_dense.argtypes = [
        ctypes.c_char_p, vp, i64, vp, i64, i32, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i32),
    ]
    # path, ids, dist_col, threads, window_bytes, threads_out, window_out,
    # size_out, errno_out
    lib.ks_tsv_read_open.restype = vp
    lib.ks_tsv_read_open.argtypes = [
        ctypes.c_char_p, i32, i32, i32, i64, ctypes.POINTER(i32),
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32),
    ]
    lib.ks_tsv_read_left.restype = i64
    lib.ks_tsv_read_left.argtypes = [vp]
    # handle, max_rows, ids1, ids2, dist, info
    lib.ks_tsv_read_next.restype = i64
    lib.ks_tsv_read_next.argtypes = [vp, i64, vp, vp, vp, ctypes.POINTER(i64)]
    lib.ks_tsv_read_close.restype = None
    lib.ks_tsv_read_close.argtypes = [vp]
    return lib, None


def library() -> ctypes.CDLL:
    """The loaded writer and reader library, built on first call."""
    lib, exc = _load()
    if exc is not None:
        raise RuntimeError(f"TSV library unavailable: {exc}") from exc
    return lib


def write_dense(path: str, s: np.ndarray, kmer_counts: np.ndarray,
                min_shared: int = 1, *, threads: int = 0,
                slot_bytes: int = 0) -> int:
    """Write the pairwise TSV of the square shared matrix ``s`` to ``path``;
    returns the number of pair rows.  ``threads`` and ``slot_bytes`` (0: the
    CPUs the process may use; two slots of 1 MiB a thread, 32 MiB in all at
    most) are for tests."""
    s = np.ascontiguousarray(s, dtype=np.int64)
    counts = np.ascontiguousarray(kmer_counts, dtype=np.int64)
    n = s.shape[0]
    if s.shape != (n, n) or counts.shape[0] < n:
        raise ValueError(f"need an n x n matrix and n counts: {s.shape}, {counts.shape}")
    nbytes, nthreads = ctypes.c_int64(), ctypes.c_int32()
    rows = library().ks_tsv_write_dense(
        os.fsencode(path), s.ctypes.data, n, counts.ctypes.data,
        max(1, int(min_shared)), threads, slot_bytes,
        ctypes.byref(nbytes), ctypes.byref(nthreads),
    )
    if rows < 0:
        raise OSError(f"ks_tsv_write_dense failed with code {rows}: {path}")
    _log.debug("pairwise TSV %s: %d rows, %d bytes, %d threads",
               path, rows, nbytes.value, nthreads.value)
    return int(rows)


#: the reader's buffer for one file, whatever its size: 4 MiB a thread, at
#: most 32 MiB (``kReadWindowMax``), so 64 MiB on the ani path's two files
READ_WINDOW_MAX = 32 << 20


class _Reader:
    """One file open in the reader: int64 ids from columns 0 and 1 (with
    ``ids``) and a float64 distance from ``dist_col`` (>= 0)."""

    def __init__(self, path, ids: bool, dist_col: int, threads: int,
                 window_bytes: int):
        self.lib = library()
        self.path, self.ids, self.dist_col = path, ids, dist_col
        nthreads, window = ctypes.c_int32(), ctypes.c_int64()
        size, err = ctypes.c_int64(), ctypes.c_int32()
        self.handle = self.lib.ks_tsv_read_open(
            os.fsencode(path), int(ids), dist_col, threads, window_bytes,
            ctypes.byref(nthreads), ctypes.byref(window), ctypes.byref(size),
            ctypes.byref(err),
        )
        if not self.handle:
            if err.value:
                raise OSError(err.value, os.strerror(err.value), path)
            raise ValueError(f"ks_tsv_read_open refused {path!r}: ids={ids}, "
                             f"dist_col={dist_col}, or no memory")
        self.threads, self.window, self.size = nthreads.value, window.value, size.value
        self.rows = 0
        # the fewest bytes a row takes: a character for each column parsed,
        # a tab before each column up to the last parsed one, and a newline
        last_col = max(1 if ids else 0, dist_col)
        self.row_bytes = 2 * ids + (dist_col >= 0) + last_col + 1

    def next(self, max_rows: int):
        """The next ``(ids1, ids2, dist)`` rows, up to ``max_rows`` (None for
        a column not read); fewer only at the end of the file."""
        left = self.lib.ks_tsv_read_left(self.handle)
        cap = max(1, min(max_rows, (left + 1) // self.row_bytes))
        ids1 = np.empty(cap, np.int64) if self.ids else None
        ids2 = np.empty(cap, np.int64) if self.ids else None
        dist = np.empty(cap, np.float64) if self.dist_col >= 0 else None
        info = ctypes.c_int64()
        n = self.lib.ks_tsv_read_next(
            self.handle, cap, *(None if a is None else a.ctypes.data
                                for a in (ids1, ids2, dist)),
            ctypes.byref(info),
        )
        if n < 0:
            raise self._error(n, info.value)
        self.rows += n
        return tuple(None if a is None else a[:n] for a in (ids1, ids2, dist))

    def _error(self, code: int, info: int) -> Exception:
        if code == -6:
            return OSError(info, os.strerror(info), self.path)
        if code == -7:
            want = ["int64 ids in columns 0 and 1"] if self.ids else []
            if self.dist_col >= 0:
                want.append(f"a number in column {self.dist_col}")
            return ValueError(f"{self.path}: line {info}: missing or non-numeric "
                              f"field (a row needs {' and '.join(want)})")
        if code == -8:
            return ValueError(f"{self.path}: line {info} is longer than the "
                              f"reader's window of {self.window} bytes")
        return RuntimeError(f"ks_tsv_read_next failed with code {code}: {self.path}")

    def close(self):
        if self.handle:
            self.lib.ks_tsv_read_close(self.handle)
            self.handle = None
            _log.debug("pairwise TSV read %s: %d rows, %d bytes, %d threads",
                       self.path, self.rows, self.size, self.threads)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_pairwise(pairwise_tsv: str, dist_col: int, ani_file, chunk_rows: int,
                  *, threads: int = 0, window_bytes: int = 0):
    """Yield ``(ids1 i64, ids2 i64, dist f64)`` chunks of at most
    ``chunk_rows`` rows, in file order: what
    ``io/pairwise_tsv.iter_pairwise_chunks`` yields, from the library's
    reader on every CPU the process may use.

    ``dist_col`` is the distance column of the pairwise TSV; with
    ``ani_file`` the distance is instead the row-aligned ani file's one
    column, and the files' row counts must agree.  The header is skipped,
    and blank lines; the first chunk is yielded even when empty, as pandas
    does.  A row with a missing or non-numeric field raises ``ValueError``
    naming its line (pandas gives a NaN distance for some of them).  Besides
    the chunk's arrays the reader holds one window of each file, at most
    ``READ_WINDOW_MAX`` bytes: 64 MiB in all whatever the files' size.
    ``threads`` and ``window_bytes`` (0: the CPUs the process may use; 4 MiB
    a thread, at most ``READ_WINDOW_MAX``) are for tests."""
    from kspider_tpu_torch.io.pairwise_tsv import misaligned_error

    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be at least 1, not {chunk_rows}")
    if ani_file is None:
        with _Reader(pairwise_tsv, True, dist_col, threads, window_bytes) as pw:
            chunk = pw.next(chunk_rows)
            while True:
                yield chunk
                chunk = pw.next(chunk_rows)
                if not len(chunk[0]):
                    return
    with _Reader(pairwise_tsv, True, -1, threads, window_bytes) as pw, \
            _Reader(ani_file, False, 0, threads, window_bytes) as ani:
        first = True
        while True:
            ids1, ids2, _ = pw.next(chunk_rows)
            dist = ani.next(chunk_rows)[2]
            if not first and not len(ids1) and not len(dist):
                return
            first = False
            if len(ids1) != len(dist):
                raise misaligned_error(pairwise_tsv, ani_file,
                                       pw.rows, ani.rows)
            yield ids1, ids2, dist
