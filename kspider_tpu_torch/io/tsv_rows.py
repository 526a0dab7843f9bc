"""The port's multi-threaded writer of the dense pairwise TSV.

``csrc/tsv_rows.cpp`` writes the bytes of ``native/``'s
``ks_write_pairwise_tsv`` from the int64 shared matrix: blocks of source
rows formatted with ``std::to_chars`` on every CPU the process may use,
written in order with ``write(2)``, in at most 32 MiB of buffers whatever
N.  It is host code, compiled by the host C++ compiler (``$CXX``, else
``g++``) into ``kspider_tpu_torch/build/`` at first use, under a name that
carries a hash of the source, the compiler and the flags, and loaded with
``ctypes``.  Nothing is compiled at import time.
"""

import ctypes
import functools
import hashlib
import logging
import os
import shlex
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tsv_rows.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-fPIC", "-shared")

_log = logging.getLogger(__name__)


def compiler() -> list:
    """``$CXX`` split into words, else ``g++``."""
    return shlex.split(os.environ.get("CXX") or "g++")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(compiler() + list(CXX_FLAGS)).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libkspider_tsv_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless the hashed library exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [*compiler(), *CXX_FLAGS, SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"host compiler failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


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
    return lib, None


def library() -> ctypes.CDLL:
    """The loaded writer library, built on first call."""
    lib, exc = _load()
    if exc is not None:
        raise RuntimeError(f"TSV writer library unavailable: {exc}") from exc
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
