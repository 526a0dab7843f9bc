"""Export the pairwise matrix to labeled TSV, distance matrix, and newick.

Behavioral mirror of kSpider/pykSpider/kSpider2/ks_export.py:

- labeled pairwise TSV ``kSpider_{base}_pairwise.tsv`` with group names;
- symmetric NxN distance matrix ``kSpider_{base}_distmat.tsv`` with
  ``1 - dist`` entries, zero diagonal/missing;
- optional newick via scipy single-linkage and the recursive conversion
  (reference :16-38).
"""

import csv
import os
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from kspider_tpu_torch.io import artifacts as artifacts_io
from kspider_tpu_torch.io import pairwise_tsv as pairwise_tsv_io
from kspider_tpu_torch.utils.logger import Logger

DISTANCE_TO_COL = {
    "min_cont": 3,
    "avg_cont": 4,
    "max_cont": 5,
    "ani": 99,  # sentinel: read the separate ani column file
}


def get_newick(node, parent_dist, leaf_names, newick="") -> str:
    """scipy hierarchy tree -> newick (reference ks_export.py:16-38).

    Attribution: the recursive conversion is the public Stack Overflow
    recipe https://stackoverflow.com/a/31878514 (CC BY-SA) — the same
    snippet the reference credits; kept verbatim because byte-identical
    newick output (including the ``%.2f`` rounding) is part of the
    export contract."""
    if node.is_leaf():
        return "%s:%.2f%s" % (leaf_names[node.id], parent_dist - node.dist, newick)
    if len(newick) > 0:
        newick = "):%.2f%s" % (parent_dist - node.dist, newick)
    else:
        newick = ");"
    newick = get_newick(node.get_left(), node.dist, leaf_names, newick=newick)
    newick = get_newick(node.get_right(), node.dist, leaf_names, newick=",%s" % newick)
    return "(%s" % newick


#: rows parsed per chunk when streaming the pairwise TSV (same scale as
#: the reference's 10M-edge batches, ks_clustering.py:26)
EXPORT_CHUNK_ROWS = pairwise_tsv_io.PAIRWISE_CHUNK_ROWS


def export_pairwise(
    index_prefix: str,
    distance_type: str = "max_cont",
    newick: bool = False,
    output_prefix: Optional[str] = None,
    logger: Optional[Logger] = None,
    distmat: Optional[bool] = None,
    chunk_rows: int = EXPORT_CHUNK_ROWS,
) -> Tuple[str, str, Optional[str]]:
    """Labeled TSV (streamed/vectorized, any N) + NxN distance matrix and
    optional newick.

    The distance matrix is inherently O(N^2) text; with ``distmat=None``
    (the default) it is auto-gated off above the same sample threshold at
    which pairwise switches to the streaming engine
    (``core.pairwise.AUTO_TILED_THRESHOLD``) — pass ``distmat=True``
    (CLI ``--force-distmat``) to override, ``False`` to always skip.
    The reference (ks_export.py:152-160) would attempt the quadratic
    pandas pivot at any N and OOM long before.  Output bytes are
    identical to the reference's per-line loop: pandas ``to_csv`` float
    formatting is the same shortest-round-trip repr as an f-string."""
    log = logger or Logger(quiet=True)
    if distance_type not in DISTANCE_TO_COL:
        log.ERROR("unknown distance!")
        raise ValueError("unknown distance")
    dist_col = DISTANCE_TO_COL[distance_type]
    if newick and distmat is False:
        log.ERROR("--newick requires the distance matrix (remove --no-distmat)")
        raise ValueError("newick requires distmat")

    index_basename = os.path.basename(index_prefix)
    pairwise_tsv = f"{index_prefix}_kSpider_pairwise.tsv"
    names_map_file = f"{index_prefix}.namesMap"
    seq_to_kmers_tsv = f"{index_prefix}_kSpider_seqToKmersNo.tsv"
    for _file in [pairwise_tsv, names_map_file, seq_to_kmers_tsv]:
        if not os.path.exists(_file):
            log.ERROR(f"File {_file} is not found.")
            raise FileNotFoundError(_file)

    names_map = artifacts_io.read_names_map(names_map_file)

    if distmat is None:
        # auto-gate: consistent with pairwise's automatic switch to the
        # streaming engine at the same N
        from kspider_tpu_torch.core.pairwise import AUTO_TILED_THRESHOLD

        distmat = len(names_map) <= AUTO_TILED_THRESHOLD
        if not distmat:
            if newick:
                log.ERROR(
                    f"--newick needs the NxN distance matrix, which is "
                    f"auto-skipped at {len(names_map)} samples (> "
                    f"{AUTO_TILED_THRESHOLD}); pass --force-distmat to "
                    "build it anyway"
                )
                raise ValueError("newick requires distmat")
            log.WARNING(
                f"skipping the NxN distance matrix: {len(names_map)} "
                f"samples exceed the {AUTO_TILED_THRESHOLD}-sample "
                "auto-gate (O(N^2) text); pass --force-distmat to build "
                "it anyway"
            )

    if output_prefix:
        labeled_out = f"{output_prefix}_pairwise.tsv"
        distmat_out = f"{output_prefix}_distmat.tsv"
        newick_out = f"{output_prefix}.newick"
    else:
        labeled_out = f"kSpider_{index_basename}_pairwise.tsv"
        distmat_out = f"kSpider_{index_basename}_distmat.tsv"
        newick_out = f"kSpider_{index_basename}.newick"

    ani_file = None
    if distance_type == "ani":
        ani_file = index_prefix + "_kSpider_pairwise.ani_col.tsv"
        if not os.path.exists(ani_file):
            log.ERROR(
                "ANI was selected but the ani column file was not found.\n"
                "Please run: kspider pairwise --estimate-ani -i <index_prefix>"
            )
            raise FileNotFoundError(ani_file)

    # group id -> name lookup array (ids are 1-based)
    max_id = max(names_map) if names_map else 0
    name_arr = np.empty(max_id + 1, dtype=object)
    for gid, name in names_map.items():
        name_arr[gid] = name

    header = (
        f"source1\tsource2\t{distance_type}\n"
        if distance_type == "ani"
        else f"grp1\tgrp2\t{distance_type}\n"
    )
    # pair chunks retained for the distmat pass (ids are small vs the TSV)
    kept: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    log.INFO(f"Writing pairwise matrix to {labeled_out}")
    with open(labeled_out, "w") as new:
        new.write(header)
        for ids1, ids2, dist in pairwise_tsv_io.iter_pairwise_chunks(
            pairwise_tsv, dist_col, ani_file, chunk_rows
        ):
            pd.DataFrame(
                {"a": name_arr[ids1], "b": name_arr[ids2], "d": dist}
            ).to_csv(
                new, sep="\t", header=False, index=False,
                quoting=csv.QUOTE_NONE,
            )
            if distmat:
                kept.append((ids1, ids2, dist))

    newick_path = None
    if not distmat:
        log.SUCCESS("Done.")
        return labeled_out, "", newick_path

    all1 = np.concatenate([c[0] for c in kept]) if kept else np.empty(0, np.int64)
    all2 = np.concatenate([c[1] for c in kept]) if kept else np.empty(0, np.int64)
    alld = np.concatenate([c[2] for c in kept]) if kept else np.empty(0, np.float64)
    seen_ids = np.unique(np.concatenate([all1, all2]))
    unique_ids = sorted(name_arr[seen_ids].tolist())
    pos = {name: i for i, name in enumerate(unique_ids)}
    m = len(unique_ids)
    # object matrix: int 0 fill (reference fillna(0) writes "0", not "0.0"),
    # float 1-dist entries — byte-compatible with the reference's pivot
    mat = np.zeros((m, m), dtype=object)
    if m:
        i_idx = np.array([pos[n] for n in name_arr[all1]], dtype=np.int64)
        j_idx = np.array([pos[n] for n in name_arr[all2]], dtype=np.int64)
        vals = 1.0 - alld
        mat[i_idx, j_idx] = vals
        mat[j_idx, i_idx] = vals
    df = pd.DataFrame(mat, index=unique_ids, columns=unique_ids)
    log.INFO(f"Writing distance matrix to {distmat_out}")
    df.to_csv(distmat_out, sep="\t")

    newick_path = None
    if newick:
        from warnings import simplefilter

        from scipy.cluster.hierarchy import ClusterWarning, linkage, to_tree

        simplefilter("ignore", ClusterWarning)

        loaded_df = pd.read_csv(distmat_out, sep="\t")
        log.INFO(f"Writing newick to {newick_out}.")
        names = list(loaded_df.columns[1:])
        dist = loaded_df[loaded_df.columns[1:]].to_numpy()
        z = linkage(dist, "single")
        tree = to_tree(z, False)
        nw = get_newick(tree, tree.dist, names)
        with open(newick_out, "w") as f:
            f.write(nw)
        newick_path = newick_out

    log.SUCCESS("Done.")
    return labeled_out, distmat_out, newick_path
