"""The k-mer -> color index core.

The reference builds its index with a sequential, hash-map-heavy color
update algorithm (kSpider/src/sourmash_indexing.cpp:190-260,
kSpider/src/index.cpp:236-318, kSpider/src/bins_indexing.cpp:
160-272): each k-mer carries a "color" identifying the exact set of samples
containing it; colors are created/recycled incrementally as samples stream
in.  The *final* state is order-independent: a color is simply an
equivalence class of k-mers by their sample set, and ``colorsCount[c]`` is
the class size.

This module computes that final state directly with a sort: concatenate
``(hash, sample)`` pairs, lexsort, find runs of equal hash (one run = one
unique k-mer, its samples = the run's members), then group runs with
identical member sets into color classes.  Everything is vectorized numpy
(run grouping batches runs by degree and uses ``np.unique(axis=0)``), and
the same layout feeds the pairwise Gram kernel without further
conversion.

Color-id compatibility: in the reference, the class ``{g}`` (k-mers private
to group g) always has color id g, because base colors are seeded as
1..N before ingestion (kSpider/src/sourmash_indexing.cpp:104-116).
Multi-sample classes get ids that depend on processing order and free-list
recycling; since no consumer keys on those ids (pairwise only reads the
member sets and counts), we assign them deterministically: N+1, N+2, ... in
(degree, members) lexicographic order.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from kspider_tpu_torch.core.constants import HashingMode, SlicingMode


@dataclasses.dataclass
class ColorIndex:
    """Final color-index state.

    Attributes
    ----------
    names:
        Sample (group) names; index ``g`` corresponds to 1-based
        ``groupID = g + 1`` everywhere in the artifact formats.
    group_kmer_count:
        Per-group k-mer count as reported at ingest time (mirrors
        ``mins.size()`` semantics, kSpider/src/sourmash_indexing.cpp:187).
        ``-1`` for groups that were registered but never ingested (the
        reference's ``.gz`` two-pass quirk) — these are omitted from the
        kmer-count artifact, exactly like the reference.
    color_ids:
        u64 color id per class (see module docstring for the id scheme).
    color_offsets / color_members:
        CSR layout of each class's member groups (0-based gids, ascending).
    color_counts:
        Number of distinct k-mer hashes in each class.
    ksize, hash_mode, slicing_mode, params:
        Metadata recorded in the ``.extra`` artifact.
    """

    names: List[str]
    group_kmer_count: np.ndarray
    color_ids: np.ndarray
    color_offsets: np.ndarray
    color_members: np.ndarray
    color_counts: np.ndarray
    ksize: int = 0
    hash_mode: int = int(HashingMode.mumur_hasher)
    slicing_mode: int = int(SlicingMode.KMERS)
    params: str = ""

    @property
    def num_groups(self) -> int:
        return len(self.names)

    @property
    def num_colors(self) -> int:
        return len(self.color_counts)

    @property
    def num_kmers(self) -> int:
        return int(self.color_counts.sum())

    def color_degrees(self) -> np.ndarray:
        return np.diff(self.color_offsets)


def group_runs_into_classes(
    run_starts: np.ndarray, run_lengths: np.ndarray, members_flat: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group runs (CSR over ``members_flat``) by identical member content.

    Returns ``(class_offsets, class_members, class_counts)`` where classes
    are ordered by (degree, members lexicographic) — a deterministic,
    order-independent canonical order.

    Vectorized exactly: runs are batched by length so each batch is a dense
    (n_runs, L) matrix deduplicated with ``np.unique(axis=0)``.
    """
    class_member_blocks: List[np.ndarray] = []
    class_count_blocks: List[np.ndarray] = []
    class_len_blocks: List[np.ndarray] = []
    for L in np.unique(run_lengths):
        L = int(L)
        sel = np.flatnonzero(run_lengths == L)
        # gather the runs of this length into a dense (nL, L) matrix
        idx = run_starts[sel][:, None] + np.arange(L, dtype=np.int64)[None, :]
        mat = members_flat[idx]
        uniq, counts = np.unique(mat, axis=0, return_counts=True)
        class_member_blocks.append(uniq.reshape(-1))
        class_count_blocks.append(counts.astype(np.int64))
        class_len_blocks.append(np.full(len(uniq), L, dtype=np.int64))
    if not class_member_blocks:
        return (
            np.zeros(1, dtype=np.int64),
            np.empty(0, dtype=np.int32),
            np.empty(0, dtype=np.int64),
        )
    members = np.concatenate(class_member_blocks).astype(np.int32)
    counts = np.concatenate(class_count_blocks)
    lengths = np.concatenate(class_len_blocks)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return offsets, members, counts


#: postings copied into the flat buffer per batch of the index build;
#: with consume=True a batch's source arrays are released before the next
#: batch is copied (64 Mi postings: 512 MB of hashes)
FILL_BATCH_POSTINGS = 1 << 26


def build_index_from_hash_sets(
    names: Sequence[str],
    hash_arrays: Sequence[Optional[np.ndarray]],
    kmer_counts: Optional[Sequence[Optional[int]]] = None,
    ksize: int = 0,
    hash_mode: int = int(HashingMode.mumur_hasher),
    slicing_mode: int = int(SlicingMode.KMERS),
    params: str = "",
    consume: bool = False,
) -> ColorIndex:
    """Build the final color index from per-sample hash arrays.

    ``hash_arrays[g]`` is the u64 hash set of group ``g`` (``None`` for a
    registered-but-not-ingested group).  ``kmer_counts[g]`` overrides the
    reported per-group k-mer count (defaults to ``len(hash_arrays[g])``) —
    the reference reports the raw ``mins`` length even if it contains
    duplicates (kSpider/src/sourmash_indexing.cpp:187).

    ``consume=True`` releases the source arrays as they are copied into
    the flat posting buffer, in batches of about ``FILL_BATCH_POSTINGS``
    postings (``hash_arrays`` must then be a mutable list; entries are set
    to ``None``).  At 2.5B postings the per-sample arrays are ~20 GB —
    without consume they stay co-resident with the flat copy through the
    whole build, which is what bounds the max N on a 125 GB host
    (BASELINE.md, 1M-run wall #3).
    """
    n = len(names)
    if len(hash_arrays) != n:
        raise ValueError("names and hash_arrays length mismatch")

    counts = np.full(n, -1, dtype=np.int64)
    for g, arr in enumerate(hash_arrays):
        if arr is not None:
            counts[g] = len(arr)
    if kmer_counts is not None:
        for g, c in enumerate(kmer_counts):
            if c is not None:
                counts[g] = c

    total = int(sum(len(a) for a in hash_arrays if a is not None))
    if total == 0:
        return ColorIndex(
            names=list(names),
            group_kmer_count=counts,
            color_ids=np.empty(0, dtype=np.uint64),
            color_offsets=np.zeros(1, dtype=np.int64),
            color_members=np.empty(0, dtype=np.int32),
            color_counts=np.empty(0, dtype=np.int64),
            ksize=ksize,
            hash_mode=hash_mode,
            slicing_mode=slicing_mode,
            params=params,
        )

    # exact-size flat buffers, filled in batches of about
    # FILL_BATCH_POSTINGS postings.  With consume each batch's sources are
    # released before the next batch is copied, so they overlap the flat
    # copy by one batch and the peak is about one copy of the postings
    # instead of two.  At >=1M postings the copy runs in native OpenMP
    # (ks_fill_postings) — the per-sample numpy slice-assignment loop is
    # ~19 s of pure dispatch overhead at 328M postings (BASELINE.md round-5
    # phase split); the numpy copy takes one sample at a time.
    if total >= 100_000_000:
        # Return accumulated heap fragments to the OS before the
        # multi-GB allocations below: a preamble that churned millions
        # of small arrays (e.g. per-sample sketch merges) leaves the
        # glibc arenas in a state that degrades the whole build ~25%
        # (measured at 2.57B postings: 577-711 s without, 466.8 s with;
        # BASELINE.md round-5 allocator-state section).  glibc-only,
        # best-effort.
        try:
            import ctypes

            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except Exception:
            pass
    hashes = np.empty(total, dtype=np.uint64)
    gids = np.empty(total, dtype=np.int32)
    native_fill = None
    if total >= 1_000_000:
        from kspider_tpu_torch.io import native as _native

        if _native.enabled() and _native.available():
            native_fill = _native
    batch = []  # (gid, uint64 C-contiguous array, offset) not yet copied

    def copy_batch():
        nonlocal native_fill
        if native_fill is not None:
            try:
                native_fill.fill_postings(batch, hashes, gids)
            except native_fill.NativeRequiredError:
                raise
            except Exception as exc:
                native_fill.report_fallback("fill_postings", exc)
                native_fill = None
        if native_fill is None:
            for g, a, off in batch:
                hashes[off : off + len(a)] = a
                gids[off : off + len(a)] = g
        if consume:
            for g, _, _ in batch:
                hash_arrays[g] = None
        batch.clear()

    pos = batch_start = 0
    for g in range(n):
        arr = hash_arrays[g]
        if arr is None or len(arr) == 0:
            continue
        batch.append((g, np.ascontiguousarray(arr, dtype=np.uint64), pos))
        pos += len(arr)
        if native_fill is None or pos - batch_start >= FILL_BATCH_POSTINGS:
            copy_batch()
            batch_start = pos
    arr = None  # the loop's last sample goes with its batch
    if batch:
        copy_batch()
    assert pos == total

    # native fast path for large posting sets (failure warns once or, under
    # KSPIDER_NATIVE=force, raises — see io/native.report_fallback)
    if len(hashes) >= 1_000_000:
        from kspider_tpu_torch.io import native

        if native.enabled():
            try:
                if not native.available():
                    raise RuntimeError(
                        f"native library failed to load: {native.load_error()!r}"
                    )
                offsets, members, class_counts = native.build_colors(hashes, gids)
                return _finish_index(
                    names, counts, offsets, members, class_counts,
                    ksize, hash_mode, slicing_mode, params,
                )
            except native.NativeRequiredError:
                raise
            except Exception as exc:
                native.report_fallback("build_colors", exc)

    order = np.lexsort((gids, hashes))
    hashes = hashes[order]
    gids = gids[order]

    # drop duplicate (hash, gid) pairs — a sample's sketch is a set
    if len(hashes) > 1:
        keep = np.empty(len(hashes), dtype=bool)
        keep[0] = True
        np.logical_or(hashes[1:] != hashes[:-1], gids[1:] != gids[:-1], out=keep[1:])
        hashes = hashes[keep]
        gids = gids[keep]

    # runs of equal hash = unique k-mers with their member sets
    new_run = np.empty(len(hashes), dtype=bool)
    new_run[0] = True
    np.not_equal(hashes[1:], hashes[:-1], out=new_run[1:])
    run_starts = np.flatnonzero(new_run)
    run_lengths = np.diff(np.append(run_starts, len(hashes)))

    offsets, members, class_counts = group_runs_into_classes(
        run_starts, run_lengths, gids
    )
    return _finish_index(
        names, counts, offsets, members, class_counts,
        ksize, hash_mode, slicing_mode, params,
    )


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
    from kspider_tpu_torch.ops import device_build

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


def _finish_index(
    names, counts, offsets, members, class_counts,
    ksize, hash_mode, slicing_mode, params,
) -> ColorIndex:
    n = len(names)
    # reference-compatible color ids: singleton class {g} -> groupID g+1;
    # multi-member classes -> N+1, N+2, ... in canonical class order.
    degrees = np.diff(offsets)
    ids = np.zeros(len(class_counts), dtype=np.uint64)
    singleton = degrees == 1
    ids[singleton] = members[offsets[:-1][singleton]].astype(np.uint64) + 1
    n_multi = int((~singleton).sum())
    ids[~singleton] = np.arange(n + 1, n + 1 + n_multi, dtype=np.uint64)

    return ColorIndex(
        names=list(names),
        group_kmer_count=counts,
        color_ids=ids,
        color_offsets=offsets,
        color_members=members,
        color_counts=class_counts,
        ksize=ksize,
        hash_mode=hash_mode,
        slicing_mode=slicing_mode,
        params=params,
    )
