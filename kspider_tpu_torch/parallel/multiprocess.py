"""Multi-process pairwise on ``torch.distributed``.

Counterpart of ``kspider_tpu/parallel/multiprocess.py``.  N coordinated
processes each compute a partial result on their own device (one
``--device`` per process, or the numpy host engine for ``--cpu``) and
merge it over a gloo process group (``parallel/distributed.py``).  Three
partitionings, all exact:

- **color slices** (:func:`run_distributed_pairwise`): the processes split
  an existing index's color classes into contiguous blocks; the partial
  shared matrices sum to the full matrix, because every color contributes
  on its own.  One ``all_reduce`` merges them.
- **panel rows** (:func:`run_distributed_tiled_pairwise`): the processes
  split the panel-streamed engine's panel rows, each writes one sorted part
  file per row, and process 0 concatenates them in row order.
- **hash ranges** (:func:`distributed_pairwise_from_hash_sets`): the
  processes split the u64 hash space during ingestion, each builds a local
  index of its range, and the partials sum because a hash's postings never
  straddle ranges.

The merge always runs on host tensors over gloo: gloo sums int64 exactly,
so kspider_tpu's base-2**16 limb encoding of the psum is not needed, and
gloo, unlike NCCL, lets two processes share one card.  Process 0 writes the
``_kSpider_pairwise.tsv`` and ``_kSpider_seqToKmersNo.tsv`` bytes of a
single-process run; a barrier holds the others until they are on disk.
The library functions leave the process group up, as kspider_tpu does;
:func:`shutdown` takes it down.
"""

import glob
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kspider_tpu_torch.parallel import distributed
from kspider_tpu_torch.parallel.mesh import make_mesh

ENV_COORDINATOR = "KSPIDER_COORDINATOR"
ENV_NUM_PROCESSES = "KSPIDER_NUM_PROCESSES"
ENV_PROCESS_ID = "KSPIDER_PROCESS_ID"


def resolve_flags(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[Optional[str], int, Optional[int]]:
    """Merge CLI flags with the KSPIDER_* environment fallbacks."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR) or None
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    return coordinator, int(num_processes or 1), process_id


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group from flags or environment; a no-op for one
    process.  Returns ``(rank, world size)``."""
    distributed.initialize(*resolve_flags(coordinator, num_processes,
                                          process_id))
    return distributed.process_info()


def shutdown() -> None:
    """Leave the process group, if this process belongs to one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device):
    """The one torch device of this process (None for the host engine);
    a list of several devices is refused: each process takes one."""
    if device is None:
        return None
    devices = make_mesh(device)
    if len(devices) > 1:
        raise ValueError(
            f"a multi-process run takes one device per process, got "
            f"{len(devices)} ({', '.join(map(str, devices))})"
        )
    return devices[0]


def psum_across_processes(local: np.ndarray) -> np.ndarray:
    """The sum of a per-process host array over all processes: one gloo
    ``all_reduce`` of a copy, exact for int64.  ``local`` is left as it
    was."""
    local = np.asarray(local)
    if distributed.process_info()[1] == 1:
        return local.copy()
    if local.dtype == np.int64 and (local < 0).any():
        raise ValueError("int64 psum merge expects non-negative counts")
    total = torch.from_numpy(np.array(local, copy=True))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy()


def barrier() -> None:
    """Block until every process reaches this point."""
    if distributed.process_info()[1] > 1:
        dist.barrier()


def color_slice(
    n_colors: int, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Contiguous [lo, hi) color-class block for one process."""
    base = n_colors // num_processes
    rem = n_colors % num_processes
    lo = process_id * base + min(process_id, rem)
    hi = lo + base + (1 if process_id < rem else 0)
    return lo, hi


def _local_partial_from_slice(index, lo: int, hi: int, device,
                              engine: str = "auto"):
    """Partial shared matrix from a contiguous color-class slice."""
    from kspider_tpu_torch.core.index import ColorIndex
    from kspider_tpu_torch.core.pairwise import compute_shared_matrix

    off = index.color_offsets
    sub = ColorIndex(
        names=index.names,
        group_kmer_count=index.group_kmer_count,
        color_ids=index.color_ids[lo:hi],
        color_offsets=(off[lo : hi + 1] - off[lo]).astype(np.int64),
        color_members=index.color_members[off[lo] : off[hi]],
        color_counts=index.color_counts[lo:hi],
        ksize=index.ksize,
        hash_mode=index.hash_mode,
        slicing_mode=index.slicing_mode,
        params=index.params,
    )
    return compute_shared_matrix(sub, device=device, engine=engine)


def _load_index(prefix: str):
    from kspider_tpu_torch.io import artifacts, npz_index

    index = npz_index.load(prefix)
    return artifacts.load_index_artifacts(prefix) if index is None else index


def run_distributed_pairwise(
    prefix: str,
    index=None,
    *,
    device,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    echo_timers: bool = True,
    engine: str = "auto",
    min_shared: int = 1,
) -> Optional[np.ndarray]:
    """Color-sliced multi-process pairwise over an existing index.

    Every process loads the same artifacts, computes the partial matrix of
    its color block on ``device`` (one device, or None for the numpy
    engine), and the partials are summed; process 0 writes the TSVs.
    Returns the full matrix on every process.  The merge is dense, so the
    panel-streamed ``tiled`` engine is refused here, as in kspider_tpu."""
    from kspider_tpu_torch.core import pairwise as core_pairwise

    if engine == "tiled":
        raise ValueError(
            "the panel-streamed 'tiled' engine is single-process only; "
            "multi-process pairwise merges dense partials "
            "(use --engine auto/bitmask/pallas/scatter, or drop "
            "--num-processes to stream)"
        )
    device = rank_device(device)
    pid, nproc = initialize(coordinator, num_processes, process_id)
    t0 = time.perf_counter()
    if index is None:
        index = _load_index(prefix)
    if echo_timers and pid == 0:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    lo, hi = color_slice(index.num_colors, pid, nproc)
    partial = _local_partial_from_slice(index, lo, hi, device, engine)
    t_merge = time.perf_counter()
    merged = psum_across_processes(partial)
    t_merge = time.perf_counter() - t_merge
    if echo_timers and pid == 0:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )
        print(f"merging {partial.nbytes} B partials across {nproc} processes: "
              f"{t_merge:.6g} secs")
    del partial

    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, index)
        core_pairwise.write_pairwise_tsv(
            prefix, index, merged, min_shared=min_shared
        )
    barrier()
    return merged


def assign_panel_rows(work: np.ndarray, num_processes: int) -> np.ndarray:
    """Deterministic greedy balanced assignment of panel rows to
    processes: rows in descending work order go to the least-loaded
    process (ties by process id).  Every process computes the same
    assignment from the same plan, so no coordination is needed."""
    loads = np.zeros(num_processes, dtype=np.int64)
    owner = np.zeros(len(work), dtype=np.int64)
    for r in np.argsort(-np.asarray(work), kind="stable"):
        p = int(np.argmin(loads))  # argmin ties -> lowest id
        owner[r] = p
        loads[p] += int(work[r])
    return owner


def _part_path(prefix: str, pi: int) -> str:
    return f"{prefix}_kSpider_pairwise.row{pi:06d}.part"


def run_distributed_tiled_pairwise(
    prefix: str,
    index=None,
    *,
    device,
    panel: int = 4096,
    block: int = 1024,
    min_shared: int = 1,
    device_pack: Optional[str] = None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    echo_timers: bool = True,
) -> int:
    """Multi-process panel-streamed pairwise.

    Panel rows partition the streamed TSV into disjoint contiguous blocks
    (``ops/tiled_pairwise.filter_plan_rows``), so each process computes
    whole panel rows, greedily balanced by pair-entry count, on ``device``
    (None: the engine's plain version on the CPU), and writes one sorted
    part file per owned row.  Process 0 concatenates the parts in row order
    into the single-process TSV bytes.  The part files need a filesystem
    that every process sees.  Returns the global pair-row count on every
    process."""
    from kspider_tpu_torch.core import pairwise as core_pairwise
    from kspider_tpu_torch.ops import tiled_pairwise as tp

    device = rank_device(device)
    pid, nproc = initialize(coordinator, num_processes, process_id)
    t0 = time.perf_counter()
    if index is None:
        index = _load_index(prefix)
    if echo_timers and pid == 0:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    plan = tp.build_panel_plan(
        index.color_offsets, index.color_members, index.color_counts,
        index.num_groups, panel,
    )
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    owner = assign_panel_rows(tp.panel_row_work(plan), nproc)
    sub = tp.filter_plan_rows(plan, np.flatnonzero(owner == pid))
    # the part writer appends: process 0 clears every stale part of a
    # crashed run (one with a smaller --panel leaves rows beyond this
    # plan's n_panels), then everyone syncs before writing
    if pid == 0:
        for part in glob.glob(f"{prefix}_kSpider_pairwise.row*.part"):
            os.remove(part)
    barrier()

    total_local = 0
    current_row = -1
    buf_i: List[np.ndarray] = []
    buf_j: List[np.ndarray] = []
    buf_v: List[np.ndarray] = []

    def flush():
        nonlocal total_local
        if current_row < 0 or not buf_i:
            return
        gi = np.concatenate(buf_i)
        gj = np.concatenate(buf_j)
        sv = np.concatenate(buf_v)
        order = np.lexsort((gj, gi))
        core_pairwise.write_pairwise_rows_coo(
            _part_path(prefix, current_row),
            gi[order], gj[order], sv[order], counts, header=False,
        )
        total_local += len(gi)
        buf_i.clear()
        buf_j.clear()
        buf_v.clear()

    for pi, pj, gi, gj, vals in tp.iter_panel_pairs(
        sub, device="cpu" if device is None else device, block=block,
        min_shared=min_shared, device_pack=device_pack,
    ):
        if pi != current_row:
            flush()
            current_row = pi
        buf_i.append(gi)
        buf_j.append(gj)
        buf_v.append(vals)
    flush()

    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, index)
    barrier()
    total = int(
        psum_across_processes(np.array([total_local], dtype=np.int64))[0]
    )
    if echo_timers and pid == 0:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )

    if pid == 0:
        path = prefix + "_kSpider_pairwise.tsv"
        core_pairwise.write_pairwise_rows_coo(
            path,
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), counts, header=True,
        )
        with open(path, "ab") as out:
            for pi in range(plan.n_panels):
                part = _part_path(prefix, pi)
                if os.path.exists(part):
                    with open(part, "rb") as f:
                        while True:
                            chunk = f.read(1 << 24)
                            if not chunk:
                                break
                            out.write(chunk)
                    os.remove(part)
    barrier()
    return total


def run_multiprocess_pairwise(
    prefix: str,
    *,
    device,
    engine: str = "auto",
    panel: int = 4096,
    min_shared: int = 1,
    device_pack: Optional[str] = None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """CLI dispatcher, with the engine rule of the single-process
    ``core.pairwise.run_pairwise``: the panel-streamed path for
    ``engine="tiled"``, or ``"auto"`` with a device and N above the
    threshold; the dense color-sliced path otherwise."""
    from kspider_tpu_torch.core.pairwise import AUTO_TILED_THRESHOLD

    index = _load_index(prefix)
    tiled = engine == "tiled" or (
        engine == "auto" and device is not None
        and index.num_groups > AUTO_TILED_THRESHOLD
    )
    if tiled:
        run_distributed_tiled_pairwise(
            prefix, index=index, device=device, panel=panel,
            min_shared=min_shared, device_pack=device_pack,
            coordinator=coordinator, num_processes=num_processes,
            process_id=process_id,
        )
        return
    run_distributed_pairwise(
        prefix, index=index, device=device, engine=engine,
        coordinator=coordinator, num_processes=num_processes,
        process_id=process_id, min_shared=min_shared,
    )


def distributed_pairwise_from_hash_sets(
    names: Sequence[str],
    hash_arrays: Sequence[np.ndarray],
    prefix: str,
    ksize: int = 0,
    *,
    device,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Hash-range-partitioned ingest + pairwise.

    Each process keeps only its ``my_hash_range`` slice of every sample's
    hashes, builds a local ColorIndex, computes its partial matrix on
    ``device`` (None: the numpy engine), and one ``all_reduce`` gives the
    exact global matrix; process 0 writes the TSVs.  The true per-group
    k-mer totals are passed through so the containments are exact."""
    from kspider_tpu_torch.core.index import build_index_from_hash_sets
    from kspider_tpu_torch.core import pairwise as core_pairwise

    device = rank_device(device)
    pid, nproc = initialize(coordinator, num_processes, process_id)
    lo, hi = distributed.my_hash_range(pid, nproc)
    full_counts: List[Optional[int]] = [
        None if a is None else len(a) for a in hash_arrays
    ]
    sub = [
        None if a is None else distributed.filter_to_range(a, lo, hi)
        for a in hash_arrays
    ]
    local_index = build_index_from_hash_sets(
        list(names), sub, kmer_counts=full_counts, ksize=ksize,
        params=f"kSize:{ksize}",
    )
    partial = core_pairwise.compute_shared_matrix(local_index, device=device)
    merged = psum_across_processes(partial)
    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, local_index)
        core_pairwise.write_pairwise_tsv(prefix, local_index, merged)
    barrier()
    return merged
