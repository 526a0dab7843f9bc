"""Threshold clustering over the pairwise TSV.

Counterpart of ``kspider_tpu/core/cluster.py`` (the reference's
``Clusters`` class): one node per namesMap entry (node = groupID - 1),
an edge for every pairwise row whose selected distance column * 100 >=
cutoff, connected components written one comma-joined cluster per line to
``{prefix}_kSpider_clusters_{cutoff*100}%.tsv``.  The TSV is read by the
chunked reader of ``kspider_tpu_torch.io.pairwise_tsv``.
:func:`cluster_from_index` (``--from-index``) skips the TSV and clusters
straight from the panel-streamed engine's pair stream.
"""

import os
from typing import List, Optional, Tuple

import numpy as np

from kspider_tpu_torch.io import artifacts as artifacts_io
from kspider_tpu_torch.io import pairwise_tsv as pw_tsv
from kspider_tpu_torch.utils.logger import Logger
from kspider_tpu_torch.ops import cc as cc_ops
from kspider_tpu_torch.parallel.mesh import make_mesh

DISTANCE_TO_COL = {
    "min_cont": 3,
    "avg_cont": 4,
    "max_cont": 5,
    "ani": 6,
}

EDGE_CHUNK_ROWS = pw_tsv.PAIRWISE_CHUNK_ROWS


def iter_pairwise_edge_chunks(
    prefix: str,
    dist_type: str,
    cutoff_percent: float,
    chunk_rows: int = EDGE_CHUNK_ROWS,
):
    """Yield thresholded ``(src, dst)`` int32 edge-array chunks (0-based
    node ids) from the pairwise TSV, ``chunk_rows`` rows at a time."""
    pairwise_file = prefix + "_kSpider_pairwise.tsv"
    # the ani column file is row-aligned with the pairwise TSV
    ani_file = (
        prefix + "_kSpider_pairwise.ani_col.tsv" if dist_type == "ani" else None
    )
    col = DISTANCE_TO_COL[dist_type]
    for ids1, ids2, dist in pw_tsv.iter_pairwise_chunks(
        pairwise_file, col, ani_file, chunk_rows
    ):
        keep = dist * 100.0 >= cutoff_percent
        yield (
            (ids1[keep] - 1).astype(np.int32),
            (ids2[keep] - 1).astype(np.int32),
        )


def load_pairwise_edges(
    prefix: str,
    dist_type: str,
    cutoff_percent: float,
    chunk_rows: int = EDGE_CHUNK_ROWS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked-vectorized thresholded edge list (0-based node ids)."""
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    for s, d in iter_pairwise_edge_chunks(
        prefix, dist_type, cutoff_percent, chunk_rows
    ):
        if len(s):
            srcs.append(s)
            dsts.append(d)
    if not srcs:
        return np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32)
    return np.concatenate(srcs), np.concatenate(dsts)


def fold_edges_into_labels(labels, src, dst, n, cc_fn):
    """Union a batch of edges into running component labels.

    The labels compress everything seen so far into at most n "star" edges
    (node -> component representative), so peak memory is O(n + batch)
    however many edges stream through.  Every CC engine returns
    min-node-index representatives, which keeps the star edges a faithful
    summary across folds."""
    star = np.nonzero(labels != np.arange(len(labels), dtype=np.int32))[0]
    src_all = np.concatenate([np.asarray(src, dtype=np.int32), star.astype(np.int32)])
    dst_all = np.concatenate([np.asarray(dst, dtype=np.int32), labels[star]])
    return np.asarray(cc_fn(src_all, dst_all, n), dtype=np.int32)


def _cc_fn(device):
    """Connected components on ``device`` (torch), or scipy for None."""
    if device is None:
        return cc_ops.connected_components_scipy

    def cc_fn(src, dst, n_nodes):
        return cc_ops.connected_components(src, dst, n_nodes, device=device)

    return cc_fn


def cluster_from_index(
    index,
    prefix: str,
    cutoff: float,
    dist_type: str = "max_cont",
    *,
    device,
    panel: int = 4096,
    block: int = 1024,
    min_shared: int = 1,
    logger: Optional[Logger] = None,
    edge_batch: int = EDGE_CHUNK_ROWS,
) -> str:
    """Cluster from the panel-streamed engine's pairs, with no pairwise TSV;
    returns the output file path.

    ``device`` runs the Gram kernel and the CC on a torch device; a device
    list (``parallel/mesh.make_mesh``) runs the Gram kernel over the list
    (see ``ops/tiled_pairwise.iter_panel_pairs``) and the CC on its first
    device; None runs the engine's plain version on the CPU and scipy's
    CC.  The cutoff is applied to the full-precision float32 containment,
    so a pair sitting exactly on a %g rounding boundary of the TSV may
    classify differently from :func:`cluster_index`.  ``ani`` needs the ani column file and is
    refused."""
    from kspider_tpu_torch.core import pairwise as core_pw
    from kspider_tpu_torch.ops import tiled_pairwise as tp

    log = logger or Logger(quiet=True)
    if dist_type == "ani":
        log.ERROR("--from-index clustering does not support the ani metric")
        raise ValueError("ani unsupported in from-index mode")
    if dist_type not in DISTANCE_TO_COL:
        log.ERROR("unknown distance!")
        raise ValueError("unknown distance")

    devices = make_mesh("cpu" if device is None else device)
    cutoff_percent = float(cutoff) * 100.0
    n = index.num_groups
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    cc_fn = _cc_fn(None if device is None else devices[0])
    plan = tp.build_panel_plan(
        index.color_offsets, index.color_members, index.color_counts,
        n, panel,
    )
    labels = np.arange(max(n, 1), dtype=np.int32)
    buf_src: List[np.ndarray] = []
    buf_dst: List[np.ndarray] = []
    pending = 0

    def fold():
        nonlocal labels, pending
        if not buf_src:
            return
        labels = fold_edges_into_labels(
            labels, np.concatenate(buf_src), np.concatenate(buf_dst), n, cc_fn
        )
        buf_src.clear()
        buf_dst.clear()
        pending = 0

    log.INFO("Clustering from the panel-streamed engine (no TSV)...")
    for _, _, gi, gj, vals in tp.iter_panel_pairs(
        plan, device=devices, block=block, min_shared=min_shared,
    ):
        cmin, cavg, cmax = core_pw.containment_columns(
            vals, counts[gi], counts[gj]
        )
        d = {3: cmin, 4: cavg, 5: cmax}[DISTANCE_TO_COL[dist_type]]
        keep = d.astype(np.float64) * 100.0 >= cutoff_percent
        if keep.any():
            buf_src.append(gi[keep].astype(np.int32))
            buf_dst.append(gj[keep].astype(np.int32))
            pending += int(keep.sum())
            if pending >= edge_batch:
                fold()
    fold()

    comps = cc_ops.labels_to_clusters(labels[:n])
    log.INFO(f"number of clusters: {len(comps)}")
    out_path = prefix + f"_kSpider_clusters_{cutoff_percent}%.tsv"
    with open(out_path, "w") as f:
        for comp in comps:
            f.write(",".join(index.names[int(node)] for node in comp) + "\n")
    return out_path


def cluster_index(
    prefix: str,
    cutoff: float,
    dist_type: str = "max_cont",
    *,
    device,
    logger: Optional[Logger] = None,
    chunk_rows: int = EDGE_CHUNK_ROWS,
) -> str:
    """Run the full cluster stage; returns the output file path.

    ``cutoff`` is in 0..1 (CLI semantics), scaled to percent inside.
    ``device`` is a torch device for the label-propagation CC, or None for
    scipy's host CC."""
    log = logger or Logger(quiet=True)
    if dist_type not in DISTANCE_TO_COL:
        log.ERROR("unknown distance!")
        raise ValueError("unknown distance")

    cutoff_percent = float(cutoff) * 100.0
    names_map = artifacts_io.read_names_map(prefix + ".namesMap")
    n = max(names_map) if names_map else 0

    if dist_type == "ani" and not os.path.exists(
        prefix + "_kSpider_pairwise.ani_col.tsv"
    ):
        log.ERROR(
            f"ANI was selected, but the ani file "
            f"{prefix}_kSpider_pairwise.ani_col.tsv was not found!"
        )
        raise FileNotFoundError("ani column file missing")

    cc_fn = _cc_fn(device)
    log.INFO("Clustering...")
    labels = np.arange(max(n, 1), dtype=np.int32)
    for src, dst in iter_pairwise_edge_chunks(
        prefix, dist_type, cutoff_percent, chunk_rows
    ):
        if len(src):
            labels = fold_edges_into_labels(labels, src, dst, n, cc_fn)
    comps = cc_ops.labels_to_clusters(labels[:n])
    log.INFO(f"number of clusters: {len(comps)}")

    out_path = prefix + f"_kSpider_clusters_{cutoff_percent}%.tsv"
    with open(out_path, "w") as f:
        for comp in comps:
            f.write(",".join(names_map[int(node) + 1] for node in comp) + "\n")
    return out_path
