"""The ``_kSpider_pairwise.tsv`` artifact: its format, writers and reader.

Single owner of the pairwise TSV of ``kSpider::pairwise``: a header, then
one row per unordered pair with shared k-mers >= ``min_shared``, sorted by
(source_1, source_2): 1-based ids, the shared count and min/avg/max
containment in float32, printed like C++'s ``ostream << float`` (6
significant digits).

Writers: :func:`write_dense` (from the int64 shared matrix) is the port's
multi-threaded writer (``io/tsv_rows``); :func:`write_rows_coo` (sorted pair
rows, the panel-streamed engine's) is the one-thread writer of the
repository's ``native/`` library (``io/native``).  Where a library cannot
build or load, ``native.report_fallback`` says so and the next in line
writes the same bytes: ``native/``, then the pure-Python rows below.

Reader: how the cluster and export stages stream the pairwise TSV (and the
row-aligned ``..ani_col.tsv`` column file) back in:
both stages in the reference re-parse the file with per-line ``float()``
(kSpider/pykSpider/kSpider2/ks_clustering.py:63-117,
kSpider/pykSpider/kSpider2/ks_export.py:44-60); here the parse is the
port's multi-threaded reader (``io/tsv_rows.read_pairwise``: ``from_chars``
on every CPU the process may use).  Where its library cannot build or load,
``native.report_fallback`` says so and pandas' C engine parses on one thread,
under the ``kspider.tsv_read_pandas`` range, with
``float_precision="round_trip"``.  Both are bit-equal to ``float()``/strtod
on every value (pandas' default fast parser differs by 1 ulp on ~36% of
17-significant-digit reprs — enough to flip a threshold comparison sitting
on the cutoff).

The pairwise/ani files are required to be row-aligned; a length mismatch
(stale or truncated ani file) raises instead of silently zip-truncating.
"""

from typing import Iterator, Optional, Tuple

import numpy as np

from kspider_tpu_torch.io import native, tsv_rows
from kspider_tpu_torch.utils.timing import timed

#: rows parsed per chunk; the reference batches graph edges 10M at a time
#: (kSpider/pykSpider/kSpider2/ks_clustering.py:26) — we bound the
#: *parse* at the same scale so a low --min-shared 100K-sample run
#: (10^8-10^9 TSV rows) streams in constant memory.
PAIRWISE_CHUNK_ROWS = 10_000_000

_COLUMN_NAMES = ["s1", "s2", "sh", "mn", "av", "mx"]

HEADER = ("source_1\tsource_2\tshared_kmers\tmin_containment\t"
          "avg_containment\tmax_containment")


def format_float_cpp(x: float) -> str:
    """Format like C++ ``operator<<(ostream&, float)``: %g, 6 sig digits."""
    return f"{float(x):.6g}"


def containment_columns(shared, k1, k2):
    """float32 containment columns for pair arrays (reference math)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        c12 = np.float32(1.0) * shared.astype(np.float32) / k2.astype(np.float32)
        c21 = shared.astype(np.float32) / k1.astype(np.float32)
    cmin = np.minimum(c12, c21)
    cavg = ((c12 + c21) / np.float32(2.0)).astype(np.float32)
    cmax = np.maximum(c12, c21)
    return cmin, cavg, cmax


def kmer_counts(index) -> np.ndarray:
    """The k-mer count of each group of a ``ColorIndex`` as the containment
    columns take it: a never-ingested group counts 0 k-mers (containment
    inf), like phmap's default-inserting ``operator[]``."""
    return np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)


def write_dense(path: str, shared: np.ndarray, counts: np.ndarray,
                min_shared: int) -> int:
    """Write the pairwise TSV of the square shared matrix ``shared`` (pairs
    i < j with at least ``min_shared`` shared k-mers) to ``path``; returns
    the number of pair rows.  The port's library writes it, else
    ``native/``'s writer, else Python (see the module docstring)."""
    if native.enabled():
        try:
            return tsv_rows.write_dense(path, shared, counts, min_shared)
        except Exception as exc:
            native.report_fallback("tsv_rows.write_dense", exc)
        if _native("write_pairwise_tsv", native.write_pairwise_tsv, path,
                   shared, counts, min_shared=min_shared):
            return int(np.count_nonzero(np.triu(shared >= min_shared, 1)))
    iu, ju = np.triu_indices(len(shared), k=1)
    s = shared[iu, ju]
    nz = s >= min_shared
    _write_rows_python(path, iu[nz], ju[nz], s[nz], counts, header=True)
    return int(nz.sum())


def write_rows_coo(path: str, gi: np.ndarray, gj: np.ndarray,
                   shared: np.ndarray, counts: np.ndarray, header: bool) -> None:
    """Append pair rows (0-based ids, sorted by (gi, gj)) to the pairwise
    TSV at ``path``; ``header=True`` truncates it and writes the header
    first.  ``native/``'s writer writes them, else Python."""
    if not (native.enabled() and _native("write_pairwise_coo",
                                         native.write_pairwise_coo, path, gi,
                                         gj, shared, counts, header)):
        _write_rows_python(path, gi, gj, shared, counts, header)


def _native(what: str, fn, *args, **kwargs) -> bool:
    """Run the ``native/`` writer ``fn``; False, once
    ``native.report_fallback`` has reported why, when it could not."""
    try:
        if not native.available():
            raise RuntimeError(
                f"native library failed to load: {native.load_error()!r}"
            )
        fn(*args, **kwargs)
        return True
    except native.NativeRequiredError:
        raise
    except Exception as exc:
        native.report_fallback(what, exc)
        return False


def _write_rows_python(path, gi, gj, shared, counts, header: bool) -> None:
    """The pure-Python rows of both writers: each row formatted with
    :func:`format_float_cpp`; appended, or after the header into a
    truncated file."""
    counts = np.asarray(counts, dtype=np.int64)
    gi, gj = np.asarray(gi), np.asarray(gj)
    cmin, cavg, cmax = containment_columns(
        np.asarray(shared, dtype=np.int64), counts[gi], counts[gj]
    )
    lines = [HEADER] if header else []
    for a, b, sh, c1, c2, c3 in zip(
        (gi + 1).tolist(), (gj + 1).tolist(), np.asarray(shared).tolist(),
        cmin.tolist(), cavg.tolist(), cmax.tolist(),
    ):
        lines.append(
            f"{a}\t{b}\t{sh}\t{format_float_cpp(c1)}\t{format_float_cpp(c2)}\t{format_float_cpp(c3)}"
        )
    with open(path, "w" if header else "a") as f:
        if lines:
            f.write("\n".join(lines))
            f.write("\n")


def iter_panel_rows(pairs) -> Iterator[Tuple[int, np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """Group the panel-streamed engine's pair stream ``(pi, pj, gi, gj,
    shared)`` (``ops/tiled_pairwise.iter_panel_pairs``, panel pairs in plan
    order) into panel rows: yields ``(pi, gi, gj, shared)`` for each row
    with pairs, sorted by (gi, gj).  A row's pairs are concatenated and
    sorted under a ``kspider.tsv`` range; the rows come in the order of
    the TSV."""
    row, parts = -1, []

    def sorted_row():
        with timed("kspider.tsv"):
            gi, gj, sv = (np.concatenate(c) for c in zip(*parts))
            order = np.lexsort((gj, gi))
            return row, gi[order], gj[order], sv[order]

    for pi, _, gi, gj, sv in pairs:
        if pi != row and parts:
            yield sorted_row()
            parts = []
        row = pi
        parts.append((gi, gj, sv))
    if parts:
        yield sorted_row()


def iter_pairwise_chunks(
    pairwise_tsv: str,
    dist_col: int,
    ani_file: Optional[str] = None,
    chunk_rows: int = PAIRWISE_CHUNK_ROWS,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(ids1 i64, ids2 i64, dist f64)`` chunks of at most
    ``chunk_rows`` rows.

    ``dist_col`` selects the distance column of the pairwise TSV
    (3=min_cont, 4=avg_cont, 5=max_cont); when ``ani_file`` is given the
    distance instead comes from the row-aligned single-column ani file
    and ``dist_col`` is ignored.
    """
    if native.enabled():
        try:
            tsv_rows.library()
        except RuntimeError as exc:
            native.report_fallback("tsv_rows.read_pairwise", exc)
        else:
            yield from tsv_rows.read_pairwise(pairwise_tsv, dist_col, ani_file,
                                              chunk_rows)
            return
    chunks = _pandas_chunks(pairwise_tsv, dist_col, ani_file, chunk_rows)
    while True:
        with timed("kspider.tsv_read_pandas"):
            chunk = next(chunks, None)
        if chunk is None:
            return
        yield chunk


def misaligned_error(pairwise_tsv: str, ani_file: str, rows_pw: int,
                     rows_ani: int) -> ValueError:
    """The error for a pairwise TSV and an ani file whose rows disagree."""
    return ValueError(
        f"row-aligned files disagree: {pairwise_tsv} has "
        f">= {rows_pw} rows but {ani_file} has >= {rows_ani} "
        f"(stale or truncated --estimate-ani output? re-run "
        f"kspider pairwise --estimate-ani)"
    )


def _pandas_chunks(pairwise_tsv, dist_col, ani_file, chunk_rows):
    """:func:`iter_pairwise_chunks` parsed by pandas on one thread."""
    import pandas as pd

    if ani_file is not None:
        pw_iter = pd.read_csv(
            pairwise_tsv, sep="\t", header=0, usecols=[0, 1],
            names=_COLUMN_NAMES,
            dtype={"s1": np.int64, "s2": np.int64},
            chunksize=chunk_rows, engine="c",
        )
        ani_iter = pd.read_csv(
            ani_file, sep="\t", header=0, names=["d"],
            dtype={"d": np.float64}, chunksize=chunk_rows, engine="c",
            float_precision="round_trip",
        )
        rows_pw = rows_ani = 0
        while True:
            pw_chunk = next(pw_iter, None)
            ani_chunk = next(ani_iter, None)
            if pw_chunk is None and ani_chunk is None:
                return
            rows_pw += 0 if pw_chunk is None else len(pw_chunk)
            rows_ani += 0 if ani_chunk is None else len(ani_chunk)
            if (
                pw_chunk is None
                or ani_chunk is None
                or len(pw_chunk) != len(ani_chunk)
            ):
                raise misaligned_error(pairwise_tsv, ani_file, rows_pw, rows_ani)
            yield (
                pw_chunk["s1"].to_numpy(),
                pw_chunk["s2"].to_numpy(),
                ani_chunk["d"].to_numpy(),
            )

    for chunk in pd.read_csv(
        pairwise_tsv, sep="\t", header=0, usecols=[0, 1, dist_col],
        names=_COLUMN_NAMES,
        dtype={
            "s1": np.int64,
            "s2": np.int64,
            _COLUMN_NAMES[dist_col]: np.float64,
        },
        chunksize=chunk_rows, engine="c",
        float_precision="round_trip",
    ):
        yield (
            chunk["s1"].to_numpy(),
            chunk["s2"].to_numpy(),
            chunk[_COLUMN_NAMES[dist_col]].to_numpy(),
        )
