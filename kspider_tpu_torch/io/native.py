"""ctypes bindings to the native runtime (native/libkspider_native.so).

Provides the host-side fast paths: streaming FASTA/FASTQ sketching, phmap
.bin IO, batch hashing, and the OpenMP pairwise engine used as the bench
baseline.  Every entry point has a pure-Python fallback elsewhere in the
package; ``available()`` gates usage.  The library is built on demand with
``make -C native`` (g++ is part of the supported environment).

Fallback policy (``KSPIDER_NATIVE`` env var):

- ``auto`` (default): use native when loadable; on load or call failure
  emit a **one-time RuntimeWarning** naming the failed entry point and
  fall back to the pure-Python path.  Failures are never silent.
- ``force``: any native load/call failure raises ``NativeRequiredError``
  instead of degrading — use in benchmarks and CI where a silent
  slow-path would corrupt measurements.
- ``off``: never load or use the native library.
"""

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np


class NativeRequiredError(RuntimeError):
    """Raised when KSPIDER_NATIVE=force and the native path fails."""


def _mode() -> str:
    return os.environ.get("KSPIDER_NATIVE", "auto").strip().lower()


def enabled() -> bool:
    """False when the user forbade the native library (KSPIDER_NATIVE=off)."""
    return _mode() not in ("off", "0", "forbid", "disable", "disabled")


def required() -> bool:
    """True when the user demands the native path (KSPIDER_NATIVE=force)."""
    return _mode() in ("force", "require", "required")


_warned_fallbacks = set()


def report_fallback(what: str, exc: Optional[BaseException] = None) -> None:
    """Record a native fast-path failure.

    Under ``KSPIDER_NATIVE=force`` raises ``NativeRequiredError``;
    otherwise warns once per entry point (RuntimeWarning) so a broken
    ``libkspider_native.so`` can never silently degrade throughput or
    bit-parity guarantees.
    """
    if required():
        raise NativeRequiredError(
            f"KSPIDER_NATIVE=force but native fast path '{what}' failed"
        ) from exc
    if what not in _warned_fallbacks:
        _warned_fallbacks.add(what)
        warnings.warn(
            f"kspider native fast path '{what}' unavailable "
            f"({exc!r}); falling back to the pure-Python implementation "
            "(set KSPIDER_NATIVE=force to make this an error, "
            "KSPIDER_NATIVE=off to silence)",
            RuntimeWarning,
            stacklevel=3,
        )

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libkspider_native.so")

_lib = None
_lock = threading.Lock()
_build_attempted = False
_load_error: Optional[BaseException] = None

#: bumped in lockstep with ks_abi_version() in native/src/kspider_native.cpp;
#: a stale .so is rebuilt (make clean to force a fresh inode for dlopen)
#: instead of being called with mismatched signatures
_ABI_VERSION = 4


def load_error() -> Optional[BaseException]:
    """The exception from the last failed load attempt, if any."""
    return _load_error


def _abi_of(lib: ctypes.CDLL) -> int:
    try:
        fn = lib.ks_abi_version
    except AttributeError:
        return 1  # pre-versioning builds
    fn.restype = ctypes.c_int
    return int(fn())


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted, _load_error
    if not enabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_attempted:
            _build_attempted = True
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception as exc:
                _load_error = exc
                return None
        if not os.path.exists(_LIB_PATH):
            if _load_error is None:
                _load_error = FileNotFoundError(_LIB_PATH)
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            _load_error = exc
            return None
        if _abi_of(lib) != _ABI_VERSION:
            # stale build: `make clean` first so the rebuilt .so gets a
            # fresh inode — dlopen dedupes by (dev, inode), so an
            # in-place overwrite would hand back the old handle
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "clean"],
                    check=True, capture_output=True, timeout=60,
                )
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
                lib = ctypes.CDLL(_LIB_PATH)
            except Exception as exc:
                _load_error = exc
                return None
            if _abi_of(lib) != _ABI_VERSION:
                _load_error = RuntimeError(
                    f"native ABI {_abi_of(lib)} != expected {_ABI_VERSION} "
                    f"even after rebuild ({_LIB_PATH})"
                )
                return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ks_free.argtypes = [ctypes.c_void_p]
        lib.ks_murmur64_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, u64p,
        ]
        lib.ks_murmur3_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, u64p,
        ]
        lib.ks_integer_hash_batch.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int, u64p,
        ]
        lib.ks_sketch_file.restype = ctypes.c_int
        lib.ks_sketch_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(u64p), ctypes.POINTER(ctypes.c_int64),
            u64p, u64p,
        ]
        lib.ks_write_bin.restype = ctypes.c_int
        lib.ks_write_bin.argtypes = [ctypes.c_char_p, u64p, ctypes.c_int64]
        lib.ks_read_bin.restype = ctypes.c_int
        lib.ks_read_bin.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(u64p), ctypes.POINTER(ctypes.c_int64)
        ]
        lib.ks_pairwise_dense.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ks_omp_max_threads.restype = ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        # n_arrays is an int64_t in the C signature: without argtypes
        # ctypes would pass it as a default C int
        lib.ks_fill_postings.restype = ctypes.c_int
        lib.ks_fill_postings.argtypes = [
            ctypes.POINTER(u64p), i64p, i32p, i64p, ctypes.c_int64, u64p, i32p,
        ]
        lib.ks_build_colors.restype = ctypes.c_int
        lib.ks_build_colors.argtypes = [
            u64p, i32p, ctypes.c_int64,
            ctypes.POINTER(i64p), ctypes.POINTER(i32p), ctypes.POINTER(i64p),
            i64p,
        ]
        lib.ks_write_pairwise_tsv.restype = ctypes.c_int
        lib.ks_write_pairwise_tsv.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int32, i64p, ctypes.c_int64,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ks_pack_segments.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p,
        ]
        lib.ks_write_pairwise_coo.restype = ctypes.c_int
        lib.ks_write_pairwise_coo.argtypes = [
            ctypes.c_char_p, i64p, i64p, i64p, ctypes.c_int64, i64p,
            ctypes.c_int32,
        ]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ks_write_color_to_sources.restype = ctypes.c_int
        lib.ks_write_color_to_sources.argtypes = [
            ctypes.c_char_p, u64p, i64p, u32p, ctypes.c_int64,
        ]
        lib.ks_read_color_to_sources.restype = ctypes.c_int
        lib.ks_read_color_to_sources.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(u64p), ctypes.POINTER(i64p),
            ctypes.POINTER(u32p), i64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _try_load() is not None


def _as_u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def murmur3_batch(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    """First 64 bits of MurmurHash3_x64_128 per row (sourmash convention)."""
    lib = _try_load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, length = rows.shape
    out = np.empty(n, dtype=np.uint64)
    lib.ks_murmur3_batch(
        rows.ctypes.data_as(ctypes.c_char_p),
        n,
        length,
        ctypes.c_uint64(seed),
        _as_u64p(out),
    )
    return out


def murmur64_batch(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    lib = _try_load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, length = rows.shape
    out = np.empty(n, dtype=np.uint64)
    lib.ks_murmur64_batch(
        rows.ctypes.data_as(ctypes.c_char_p),
        n,
        length,
        ctypes.c_uint64(seed),
        _as_u64p(out),
    )
    return out


def sketch_file(path: str, ksize: int, scale: int = 1) -> Tuple[np.ndarray, int, int]:
    """Sketch one FASTA/FASTQ file natively -> (unique sorted hashes,
    total_kmers, inserted_kmers).  sourmash hashing convention."""
    lib = _try_load()
    out_p = ctypes.POINTER(ctypes.c_uint64)()
    n_out = ctypes.c_int64()
    total = ctypes.c_uint64()
    inserted = ctypes.c_uint64()
    rc = lib.ks_sketch_file(
        path.encode(), ksize, ctypes.c_uint64(max(1, scale)),
        ctypes.byref(out_p), ctypes.byref(n_out),
        ctypes.byref(total), ctypes.byref(inserted),
    )
    if rc != 0:
        raise IOError(f"native sketch failed with code {rc} for {path}")
    n = n_out.value
    hashes = np.ctypeslib.as_array(out_p, shape=(n,)).astype(np.uint64, copy=True)
    lib.ks_free(out_p)
    return hashes, int(total.value), int(inserted.value)


def write_bin(path: str, hashes: np.ndarray) -> None:
    lib = _try_load()
    arr = np.ascontiguousarray(hashes, dtype=np.uint64)
    rc = lib.ks_write_bin(path.encode(), _as_u64p(arr), len(arr))
    if rc != 0:
        raise IOError(f"native write_bin failed with code {rc}")


def read_bin(path: str) -> np.ndarray:
    lib = _try_load()
    out_p = ctypes.POINTER(ctypes.c_uint64)()
    n_out = ctypes.c_int64()
    rc = lib.ks_read_bin(path.encode(), ctypes.byref(out_p), ctypes.byref(n_out))
    if rc != 0:
        raise IOError(f"native read_bin failed with code {rc}")
    n = n_out.value
    hashes = np.ctypeslib.as_array(out_p, shape=(n,)).astype(np.uint64, copy=True)
    lib.ks_free(out_p)
    return hashes


def fill_postings(entries, hashes_out: np.ndarray, gids_out: np.ndarray):
    """Parallel copy of per-sample hash arrays into the flat posting
    buffers (``ks_fill_postings``).

    ``entries`` is a list of ``(gid, uint64 C-contiguous array, offset)``
    triples; the caller owns the output buffers and the offsets (an
    exclusive prefix sum of the lengths).  Replaces the per-sample numpy
    slice-assignment loop in core/index.build_index_from_hash_sets
    (~19 s of pure dispatch overhead at 328M postings)."""
    lib = _try_load()
    n = len(entries)
    if n == 0:
        return
    u64p = ctypes.POINTER(ctypes.c_uint64)
    srcs = (u64p * n)(*[a.ctypes.data_as(u64p) for _, a, _ in entries])
    lens = np.fromiter((len(a) for _, a, _ in entries), dtype=np.int64,
                       count=n)
    gids = np.fromiter((g for g, _, _ in entries), dtype=np.int32, count=n)
    offs = np.fromiter((o for _, _, o in entries), dtype=np.int64, count=n)
    rc = lib.ks_fill_postings(
        srcs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        _as_u64p(hashes_out),
        gids_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"native fill_postings failed with code {rc}")


def build_colors(hashes: np.ndarray, gids: np.ndarray):
    """Sort-based color-class build (native counterpart of
    core/index.group_runs_into_classes over raw postings).

    Returns (class_offsets i64[C+1], class_members i32[P], class_counts
    i64[C]) in canonical (degree, members) order.
    """
    lib = _try_load()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    gids = np.ascontiguousarray(gids, dtype=np.int32)
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    mems_p = ctypes.POINTER(ctypes.c_int32)()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    n_classes = ctypes.c_int64()
    rc = lib.ks_build_colors(
        _as_u64p(hashes),
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(hashes),
        ctypes.byref(offs_p),
        ctypes.byref(mems_p),
        ctypes.byref(counts_p),
        ctypes.byref(n_classes),
    )
    if rc != 0:
        raise RuntimeError(f"native build_colors failed with code {rc}")
    c = n_classes.value
    offsets = np.ctypeslib.as_array(offs_p, shape=(c + 1,)).astype(np.int64, copy=True)
    members = np.ctypeslib.as_array(mems_p, shape=(int(offsets[-1]),)).astype(
        np.int32, copy=True
    ) if offsets[-1] else np.empty(0, dtype=np.int32)
    counts = np.ctypeslib.as_array(counts_p, shape=(c,)).astype(
        np.int64, copy=True
    ) if c else np.empty(0, dtype=np.int64)
    for p in (offs_p, mems_p, counts_p):
        lib.ks_free(p)
    return offsets, members, counts


def write_pairwise_tsv(
    path: str, s: np.ndarray, kmer_counts: np.ndarray, min_shared: int = 1
) -> None:
    """Emit the pairwise TSV with true C float formatting (%g, 6 sig
    digits) — identical to the reference's ostream output.  Rows with
    fewer than ``min_shared`` shared k-mers are skipped."""
    lib = _try_load()
    s = np.ascontiguousarray(s, dtype=np.int64)
    counts = np.ascontiguousarray(kmer_counts, dtype=np.int64)
    rc = lib.ks_write_pairwise_tsv(
        path.encode(),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s.shape[0],
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(min_shared),
    )
    if rc != 0:
        raise IOError(f"native write_pairwise_tsv failed with code {rc}")


def pack_segments(
    mem_s: np.ndarray,
    seg_start: np.ndarray,
    seg_count: np.ndarray,
    panel_base: int,
    n8: int,
    block: int,
    n_blocks: int,
    transposed: bool,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """OpenMP bitmask packer for the panel-streamed engine.

    Segment ``s`` (postings ``mem_s[seg_start[s] : seg_start[s] +
    seg_count[s]]``, panel-local after subtracting ``panel_base``) fills
    output row ``(s // block, s % block)``.  Returns the packed blocks:
    ``u8[n_blocks, block, n8]`` or, transposed, ``u8[n_blocks, n8, block]``
    (the Gram kernel's layout) — replacing both the ``np.bitwise_or.at``
    pack and the post-hoc transpose copy.
    """
    lib = _try_load()
    mem_s = np.ascontiguousarray(mem_s, dtype=np.int32)
    seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
    seg_count = np.ascontiguousarray(seg_count, dtype=np.int64)
    shape = (n_blocks, n8, block) if transposed else (n_blocks, block, n8)
    if out is None:
        out = np.zeros(shape, dtype=np.uint8)
    lib.ks_pack_segments(
        mem_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seg_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seg_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seg_start),
        ctypes.c_int64(panel_base),
        ctypes.c_int64(n8),
        ctypes.c_int64(block),
        ctypes.c_int32(1 if transposed else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def write_pairwise_coo(
    path: str,
    gi: np.ndarray,
    gj: np.ndarray,
    shared: np.ndarray,
    kmer_counts: np.ndarray,
    header: bool,
) -> None:
    """Append sorted COO pair rows (0-based ids) to the pairwise TSV;
    ``header=True`` truncates and writes the header line first."""
    lib = _try_load()
    gi = np.ascontiguousarray(gi, dtype=np.int64)
    gj = np.ascontiguousarray(gj, dtype=np.int64)
    shared = np.ascontiguousarray(shared, dtype=np.int64)
    counts = np.ascontiguousarray(kmer_counts, dtype=np.int64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ks_write_pairwise_coo(
        path.encode(),
        gi.ctypes.data_as(p_i64),
        gj.ctypes.data_as(p_i64),
        shared.ctypes.data_as(p_i64),
        len(gi),
        counts.ctypes.data_as(p_i64),
        1 if header else 0,
    )
    if rc != 0:
        raise IOError(f"native write_pairwise_coo failed with code {rc}")


def write_color_to_sources(path, colors, offsets, members1) -> None:
    """Batch writer for _color_to_sources.bin (members are 1-based ids)."""
    lib = _try_load()
    colors = np.ascontiguousarray(colors, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    members = np.ascontiguousarray(members1, dtype=np.uint32)
    rc = lib.ks_write_color_to_sources(
        str(path).encode(),
        _as_u64p(colors),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        members.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(colors),
    )
    if rc != 0:
        raise IOError(f"native write_color_to_sources failed with code {rc}")


def read_color_to_sources(path):
    """Batch reader; returns (colors u64, offsets i64, members i64)."""
    lib = _try_load()
    colors_p = ctypes.POINTER(ctypes.c_uint64)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    mems_p = ctypes.POINTER(ctypes.c_uint32)()
    n = ctypes.c_int64()
    rc = lib.ks_read_color_to_sources(
        str(path).encode(), ctypes.byref(colors_p), ctypes.byref(offs_p),
        ctypes.byref(mems_p), ctypes.byref(n),
    )
    if rc != 0:
        raise IOError(f"native read_color_to_sources failed with code {rc}")
    c = n.value
    colors = np.ctypeslib.as_array(colors_p, shape=(max(1, c),))[:c].astype(
        np.uint64, copy=True
    )
    offsets = np.ctypeslib.as_array(offs_p, shape=(c + 1,)).astype(
        np.int64, copy=True
    )
    total = int(offsets[-1])
    members = np.ctypeslib.as_array(mems_p, shape=(max(1, total),))[:total].astype(
        np.int64, copy=True
    )
    for p in (colors_p, offs_p, mems_p):
        lib.ks_free(p)
    return colors, offsets, members


def shared_kmer_matrix(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    threads: int = 0,
) -> np.ndarray:
    """OpenMP host pairwise engine (the bench baseline)."""
    lib = _try_load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    members = np.ascontiguousarray(members, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.int64)
    s = np.zeros((n, n), dtype=np.int64)
    lib.ks_pairwise_dense(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        members.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(weights),
        n,
        threads,
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return s
