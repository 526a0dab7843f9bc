"""Pairwise stage: shared-k-mer matrix and reference-exact TSV output.

Counterpart of ``kspider_tpu/core/pairwise.py``, with the same output
contract (``kSpider::pairwise``):

- ``{p}_kSpider_seqToKmersNo.tsv``: header ``ID\\tseq\\tkmers``, then one row
  per ingested group: running 1-based counter, groupID, k-mer count.
- ``{p}_kSpider_pairwise.tsv``: header, then one row per unordered pair
  with shared k-mers >= ``min_shared``, sorted by (source_1, source_2):
  shared count and min/avg/max containment in float32, printed like C++'s
  ``ostream << float`` (6 significant digits).

The TSV is written by the native writers of ``kspider_tpu_torch.io.native``
(a copy of kspider_tpu's bridge to the same ``native/`` library; pure-Python
fallbacks below), so both packages emit the same bytes for the same pairs.  Up to ``AUTO_TILED_THRESHOLD`` samples a torch device runs the
dense engine (one NxN matrix); above it, or with ``engine="tiled"``, the
panel-streamed engine writes the TSV panel row by panel row.  ``--cpu``
(``device=None``) runs the numpy dense engine at any size, as kspider_tpu
does.
"""

import time
from typing import Optional

import numpy as np

from kspider_tpu_torch.core.index import ColorIndex
from kspider_tpu_torch.ops import pairwise as pairwise_ops

# beyond this sample count the JAX package switches to its panel-streamed
# engine (the int64 NxN host matrix would exceed ~2 GB)
AUTO_TILED_THRESHOLD = 16384


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


def write_seq_to_kmers_tsv(prefix: str, index: ColorIndex) -> None:
    ingested = np.flatnonzero(index.group_kmer_count >= 0)
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("ID\tseq\tkmers\n")
        for counter, g in enumerate(ingested, start=1):
            f.write(f"{counter}\t{g + 1}\t{index.group_kmer_count[g]}\n")


def write_pairwise_tsv(
    prefix: str, index: ColorIndex, shared: np.ndarray, min_shared: int = 1
) -> int:
    """Emit ``{p}_kSpider_pairwise.tsv``; returns the number of pair rows."""
    from kspider_tpu_torch.io import native

    n = index.num_groups
    min_shared = max(1, int(min_shared))
    # never-ingested groups count 0 k-mers (containment inf), like phmap's
    # default-inserting operator[]
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            native.write_pairwise_tsv(
                prefix + "_kSpider_pairwise.tsv", shared, counts,
                min_shared=min_shared,
            )
            return int((shared >= min_shared).sum()) // 2
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("write_pairwise_tsv", exc)
    iu, ju = np.triu_indices(n, k=1)
    s = shared[iu, ju]
    nz = s >= min_shared
    iu, ju, s = iu[nz], ju[nz], s[nz]
    cmin, cavg, cmax = containment_columns(s, counts[iu], counts[ju])

    lines = ["source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment"]
    for a, b, sh, c1, c2, c3 in zip(
        (iu + 1).tolist(), (ju + 1).tolist(), s.tolist(),
        cmin.tolist(), cavg.tolist(), cmax.tolist(),
    ):
        lines.append(
            f"{a}\t{b}\t{sh}\t{format_float_cpp(c1)}\t{format_float_cpp(c2)}\t{format_float_cpp(c3)}"
        )
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("\n".join(lines))
        f.write("\n")
    return int(nz.sum())


def write_pairwise_rows_coo(
    path: str,
    gi: np.ndarray,
    gj: np.ndarray,
    shared: np.ndarray,
    kmer_counts: np.ndarray,
    header: bool,
) -> None:
    """Append pre-sorted COO pair rows (0-based ids) to the pairwise TSV;
    ``header=True`` truncates and writes the header line first.  Same row
    format as :func:`write_pairwise_tsv`."""
    from kspider_tpu_torch.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            native.write_pairwise_coo(path, gi, gj, shared, kmer_counts, header)
            return
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("write_pairwise_coo", exc)
    counts = np.asarray(kmer_counts, dtype=np.int64)
    cmin, cavg, cmax = containment_columns(
        np.asarray(shared, dtype=np.int64), counts[gi], counts[gj]
    )
    lines = []
    if header:
        lines.append(
            "source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment"
        )
    for a, b, sh, c1, c2, c3 in zip(
        (np.asarray(gi) + 1).tolist(), (np.asarray(gj) + 1).tolist(),
        np.asarray(shared).tolist(), cmin.tolist(), cavg.tolist(),
        cmax.tolist(),
    ):
        lines.append(
            f"{a}\t{b}\t{sh}\t{format_float_cpp(c1)}\t{format_float_cpp(c2)}\t{format_float_cpp(c3)}"
        )
    with open(path, "w" if header else "a") as f:
        if lines:
            f.write("\n".join(lines))
            f.write("\n")


def compute_shared_matrix(
    index: ColorIndex, *, device, engine: str = "auto"
) -> np.ndarray:
    """S[i, j] = number of k-mer hashes shared by groups i and j (int64).

    ``device=None`` runs the numpy host reference (the CLI's ``--cpu``)
    whatever the engine, as kspider_tpu does; otherwise ``device`` is one
    device or a device list and ``engine`` picks the dense, sharded or
    scatter engine (``ops.pairwise.shared_kmer_matrix``)."""
    args = (index.color_offsets, index.color_members, index.color_counts,
            index.num_groups)
    if device is None:
        return pairwise_ops.shared_kmer_matrix_numpy(*args)
    return pairwise_ops.shared_kmer_matrix(*args, device=device, engine=engine)


def run_pairwise(
    prefix: str,
    index: Optional[ColorIndex] = None,
    *,
    device,
    engine: str = "auto",
    panel: int = 4096,
    min_shared: int = 1,
    device_pack: Optional[str] = None,
    echo_timers: bool = True,
) -> Optional[np.ndarray]:
    """Full pairwise stage: load artifacts if needed, compute, emit TSVs.

    ``device`` is a torch device for the Gram kernel, a device list
    (``parallel/mesh.make_mesh``) whose devices share the work, or None for
    the numpy host engine.  ``engine="tiled"``, or ``"auto"`` with a device
    and more than ``AUTO_TILED_THRESHOLD`` samples, takes the panel-streamed
    engine (on the CPU when ``device`` is None) with ``panel``-wide panels
    and ``device_pack`` (see ``ops.bitmask.device_pack_policy``), and returns
    None: the pairs then live only in the TSV.  Otherwise ``engine``
    ("auto", "bitmask", "pallas", "scatter" or "sharded", see
    :func:`compute_shared_matrix`) computes the dense shared matrix, which
    is returned."""
    t0 = time.perf_counter()
    if index is None:
        from kspider_tpu_torch.io import artifacts, npz_index

        index = npz_index.load(prefix)
        if index is None:
            index = artifacts.load_index_artifacts(prefix)
    if echo_timers:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    write_seq_to_kmers_tsv(prefix, index)
    if echo_timers:
        print(f"kmer counting: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    tiled = engine == "tiled" or (
        engine == "auto" and device is not None
        and index.num_groups > AUTO_TILED_THRESHOLD
    )
    if tiled:
        from kspider_tpu_torch.ops import tiled_pairwise

        n_rows = tiled_pairwise.stream_pairwise_tsv(
            index, prefix, device="cpu" if device is None else device,
            panel=panel, min_shared=min_shared, device_pack=device_pack,
            echo_progress=echo_timers,
        )
        if echo_timers:
            print(
                f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
            )
            print(f"streamed {n_rows} pair rows to {prefix}_kSpider_pairwise.tsv")
        return None
    shared = compute_shared_matrix(index, device=device, engine=engine)
    if echo_timers:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )
        print(f"writing pairwise matrix to {prefix}_kSpider_pairwise.tsv")
    t0 = time.perf_counter()
    write_pairwise_tsv(prefix, index, shared, min_shared=min_shared)
    if echo_timers:
        print(f"pairwise TSV written: {time.perf_counter() - t0:.6g} secs")
    return shared
