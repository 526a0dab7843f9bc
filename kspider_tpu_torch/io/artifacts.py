"""On-disk index artifacts — the reference's storage contract.

Five files per index prefix ``{p}`` (reference writers:
kSpider/src/index.cpp:333-386, src/sourmash_indexing.cpp:280-327):

a) ``{p}_groupID_to_kmerCount.bin`` — phmap flat_hash_map<u32,u32> dump
b) ``{p}_color_to_sources.bin``    — u64 count, then (u64 color,
                                     flat_hash_set<u32> groupIDs) records
c) ``{p}_color_count.bin``         — phmap flat_hash_map<u64,u64> dump
d) ``{p}.namesMap``                — text: count line, then
                                     "<groupID> <groupName>" lines
e) ``{p}.extra``                   — text: kSize, hash_mode, slicing_mode,
                                     kmerDecoder params string

These writers/readers allow this framework to consume indexes produced by
the reference binaries and vice versa (modulo color-id assignment; see
core/index.py docstring).
"""

import os
from typing import Dict, Tuple

import numpy as np

from kspider_tpu_torch.core.index import ColorIndex
from kspider_tpu_torch.io import phmap


def write_index_artifacts(prefix: str, index: ColorIndex, npz_cache: bool = True) -> None:
    n = index.num_groups
    if npz_cache:
        from kspider_tpu_torch.io import npz_index

        npz_index.save(prefix, index)

    # (a) groupID -> kmerCount, omitting never-ingested groups
    ingested = np.flatnonzero(index.group_kmer_count >= 0)
    phmap.write_u32_u32_map(
        prefix + "_groupID_to_kmerCount.bin",
        (ingested + 1).astype(np.uint32),
        index.group_kmer_count[ingested].astype(np.uint32),
    )

    # (b) color -> sources (groupIDs are 1-based)
    phmap.write_color_to_sources(
        prefix + "_color_to_sources.bin",
        index.color_ids,
        index.color_offsets,
        index.color_members.astype(np.int64) + 1,
    )

    # (c) color -> count; include zero entries for base colors without a
    # surviving singleton class (the reference keeps those at 0:
    # kSpider/src/sourmash_indexing.cpp:114,231)
    base_present = np.zeros(n, dtype=bool)
    degrees = index.color_degrees()
    singles = degrees == 1
    single_gids = index.color_members[index.color_offsets[:-1][singles]]
    base_present[single_gids] = True
    zero_ids = np.flatnonzero(~base_present).astype(np.uint64) + 1
    keys = np.concatenate([index.color_ids, zero_ids])
    vals = np.concatenate(
        [
            index.color_counts.astype(np.uint64),
            np.zeros(len(zero_ids), dtype=np.uint64),
        ]
    )
    phmap.write_u64_u64_map(prefix + "_color_count.bin", keys, vals)

    # (d) namesMap
    with open(prefix + ".namesMap", "w") as f:
        f.write(f"{n}\n")
        for g, name in enumerate(index.names):
            f.write(f"{g + 1} {name}\n")

    # (e) extra
    with open(prefix + ".extra", "w") as f:
        f.write(f"{index.ksize}\n")
        f.write(f"{index.hash_mode}\n")
        f.write(f"{index.slicing_mode}\n")
        f.write(f"{index.params}\n")


def read_names_map(path: str) -> Dict[int, str]:
    """Parse ``{p}.namesMap`` -> {groupID: name} (1-based ids)."""
    out: Dict[int, str] = {}
    with open(path) as f:
        next(f)
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                out[int(parts[0])] = parts[1]
    return out


def read_extra(path: str) -> Tuple[int, int, int, str]:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    ksize = int(lines[0])
    hash_mode = int(lines[1]) if len(lines) > 1 and lines[1].strip() else 0
    slicing_mode = int(lines[2]) if len(lines) > 2 and lines[2].strip() else 0
    params = lines[3] if len(lines) > 3 else ""
    return ksize, hash_mode, slicing_mode, params


def load_index_artifacts(prefix: str) -> ColorIndex:
    """Reconstruct a :class:`ColorIndex` from on-disk artifacts.

    Accepts artifacts produced by this framework *or* by the reference
    binaries (the load path mirrors kSpider/src/pairwise.cpp:95-170).
    """
    colors, offsets, members1 = phmap.read_color_to_sources(
        prefix + "_color_to_sources.bin"
    )
    cc_keys, cc_vals = phmap.read_u64_u64_map(prefix + "_color_count.bin")
    count_of = dict(zip(cc_keys.tolist(), cc_vals.tolist()))
    # missing color -> 0, like phmap operator[] default-insert
    color_counts = np.array(
        [count_of.get(int(c), 0) for c in colors], dtype=np.int64
    )

    gk_ids, gk_counts = phmap.read_u32_u32_map(prefix + "_groupID_to_kmerCount.bin")

    names_map = {}
    if os.path.exists(prefix + ".namesMap"):
        names_map = read_names_map(prefix + ".namesMap")
    max_gid = 0
    if len(names_map):
        max_gid = max(names_map)
    if len(gk_ids):
        max_gid = max(max_gid, int(gk_ids.max()))
    if len(members1):
        max_gid = max(max_gid, int(members1.max()))
    names = [names_map.get(g + 1, str(g + 1)) for g in range(max_gid)]

    counts = np.full(max_gid, -1, dtype=np.int64)
    counts[gk_ids.astype(np.int64) - 1] = gk_counts

    ksize, hash_mode, slicing_mode, params = (0, 0, 0, "")
    if os.path.exists(prefix + ".extra"):
        ksize, hash_mode, slicing_mode, params = read_extra(prefix + ".extra")

    return ColorIndex(
        names=names,
        group_kmer_count=counts,
        color_ids=colors,
        color_offsets=offsets,
        color_members=(members1 - 1).astype(np.int32),
        color_counts=color_counts,
        ksize=ksize,
        hash_mode=hash_mode,
        slicing_mode=slicing_mode,
        params=params,
    )
