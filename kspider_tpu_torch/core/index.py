"""The color index built with the postings sort on a torch device.

Counterpart of ``build_index_device`` in ``kspider_tpu/core/index.py``.  The
host build (``build_index_from_hash_sets``), the ``ColorIndex`` record and
the class grouping are jax-free there and used as they are.
"""

from typing import Optional, Sequence

import numpy as np

from kspider_tpu.core.constants import HashingMode, SlicingMode
from kspider_tpu.core.index import (
    ColorIndex,
    _finish_index,
    build_index_from_hash_sets,
    group_runs_into_classes,
)
from kspider_tpu_torch.ops import device_build


def build_index_device(
    names: Sequence[str],
    hash_arrays: Sequence[Optional[np.ndarray]],
    kmer_counts: Optional[Sequence[Optional[int]]] = None,
    ksize: int = 0,
    hash_mode: int = int(HashingMode.mumur_hasher),
    slicing_mode: int = int(SlicingMode.KMERS),
    params: str = "",
    *,
    device,
    stats: Optional[dict] = None,
) -> ColorIndex:
    """Index build whose u64 postings sort, run detection and singleton
    filter run on the torch ``device`` (``ops/device_build.py``); only the
    compacted multi-sample postings are grouped into classes on the host.
    Produces a ColorIndex identical to ``build_index_from_hash_sets``.
    ``stats`` is passed to ``compact_multi_postings``."""
    n = len(names)
    counts = np.full(n, -1, dtype=np.int64)
    for g, arr in enumerate(hash_arrays):
        if arr is not None:
            counts[g] = len(arr)
    if kmer_counts is not None:
        for g, c in enumerate(kmer_counts):
            if c is not None:
                counts[g] = c

    chunks, gid_chunks, unique_per_gid = [], [], np.zeros(n, dtype=np.int64)
    for g, arr in enumerate(hash_arrays):
        if arr is None or len(arr) == 0:
            continue
        a = np.unique(np.asarray(arr, dtype=np.uint64))
        unique_per_gid[g] = len(a)
        chunks.append(a)
        gid_chunks.append(np.full(len(a), g, dtype=np.int32))
    if not chunks:
        return build_index_from_hash_sets(
            names, hash_arrays, kmer_counts, ksize, hash_mode, slicing_mode, params
        )

    hashes = np.concatenate(chunks)
    gids = np.concatenate(gid_chunks)
    del chunks, gid_chunks
    mh, mg = device_build.compact_multi_postings(
        hashes, gids, device=device, stats=stats
    )
    del hashes, gids

    # the postings come back in ascending (hash, gid) order: no host re-sort
    if len(mh):
        new_run = np.empty(len(mh), dtype=bool)
        new_run[0] = True
        np.not_equal(mh[1:], mh[:-1], out=new_run[1:])
        run_starts = np.flatnonzero(new_run)
        run_lengths = np.diff(np.append(run_starts, len(mh)))
        offsets, members, class_counts = group_runs_into_classes(
            run_starts, run_lengths, mg
        )
    else:
        offsets = np.zeros(1, dtype=np.int64)
        members = np.empty(0, dtype=np.int32)
        class_counts = np.empty(0, dtype=np.int64)

    # singleton classes recovered arithmetically: distinct hashes of g not
    # in any multi-sample run are private to g
    multi_per_gid = np.bincount(mg, minlength=n).astype(np.int64)
    singleton_per_gid = unique_per_gid - multi_per_gid
    sing_gids = np.flatnonzero(singleton_per_gid > 0)

    # canonical order is (degree, members lex): singletons (degree 1) first,
    # ordered by gid, then the multi-sample classes
    all_offsets = np.zeros(len(sing_gids) + len(class_counts) + 1, dtype=np.int64)
    np.cumsum(
        np.concatenate(
            [np.ones(len(sing_gids), dtype=np.int64), np.diff(offsets)]
        ),
        out=all_offsets[1:],
    )
    all_members = np.concatenate([sing_gids.astype(np.int32), members])
    all_counts = np.concatenate([singleton_per_gid[sing_gids], class_counts])

    return _finish_index(
        names, counts, all_offsets, all_members, all_counts,
        ksize, hash_mode, slicing_mode, params,
    )
