"""Chunked, vectorized reader for the ``_kSpider_pairwise.tsv`` artifact.

Single source of truth for how the cluster and export stages stream the
pairwise TSV (and the row-aligned ``..ani_col.tsv`` column file) back in:
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

from kspider_tpu_torch.utils.timing import timed

#: rows parsed per chunk; the reference batches graph edges 10M at a time
#: (kSpider/pykSpider/kSpider2/ks_clustering.py:26) — we bound the
#: *parse* at the same scale so a low --min-shared 100K-sample run
#: (10^8-10^9 TSV rows) streams in constant memory.
PAIRWISE_CHUNK_ROWS = 10_000_000

_COLUMN_NAMES = ["s1", "s2", "sh", "mn", "av", "mx"]


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
    from kspider_tpu_torch.io import native, tsv_rows

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
