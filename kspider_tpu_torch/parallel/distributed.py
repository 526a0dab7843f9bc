"""Multi-process initialization and hash-range work partitioning.

Counterpart of ``kspider_tpu/parallel/distributed.py``, on
``torch.distributed`` in place of ``jax.distributed``.  The processes meet
at ``tcp://<coordinator>`` and form a gloo group: the partial matrices are
merged as host arrays (``parallel/multiprocess.py``), as kspider_tpu merges
them, and gloo lets several processes share one card, which NCCL refuses.

The index build is embarrassingly parallel over hash ranges: every unique
hash belongs to exactly one range, so each process groups only its range
and the color classes concatenate without reconciliation.  The ranges cut
the postings at their quantiles, not the u64 space into equal parts: a
FracMinHash sketch's hashes all lie below 2**64 / scale, so equal parts
would give them all to process 0.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group at ``tcp://coordinator_address`` when
    running multi-process; a no-op for one process or when this process
    already belongs to a group."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if not coordinator_address:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address (host:port)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process, or (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def hash_range_bounds(
    hash_arrays: Sequence[Optional[np.ndarray]], num_processes: int
) -> List[int]:
    """The ``num_processes + 1`` bounds of the processes' hash ranges: 0,
    the k / num_processes quantiles of all postings (every hash of every
    sample; ``None`` for a sample without hashes), 2**64.  Every process
    holds the same hash sets, so all compute the same bounds without
    communicating, and each range holds 1 / num_processes of the postings
    to within the samples sharing one hash."""
    arrays = [np.asarray(a, dtype=np.uint64) for a in hash_arrays
              if a is not None and len(a)]
    cuts = [0] * (num_processes - 1)
    if arrays and num_processes > 1:
        postings = np.concatenate(arrays)
        kth = [k * len(postings) // num_processes
               for k in range(1, num_processes)]
        cuts = np.partition(postings, sorted(set(kth)))[kth].tolist()
    return [0, *cuts, 1 << 64]


def my_hash_range(
    hash_arrays: Sequence[Optional[np.ndarray]],
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> Tuple[int, int]:
    """This process's [lo, hi) slice of the u64 hash space, from
    :func:`hash_range_bounds` of ``hash_arrays``."""
    rank, world = process_info()
    if process_id is None:
        process_id = rank
    if num_processes is None:
        num_processes = world
    bounds = hash_range_bounds(hash_arrays, num_processes)
    return bounds[process_id], bounds[process_id + 1]


def filter_to_range(hashes: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Keep only the hashes in [lo, hi)."""
    h = np.asarray(hashes, dtype=np.uint64)
    mask = h >= np.uint64(lo)
    if hi < (1 << 64):
        mask &= h < np.uint64(hi)
    return h[mask]


def merge_partial_matrices(partials) -> np.ndarray:
    """Host-side merge of per-range shared-k-mer matrices (ranges are
    disjoint, so the merge is a plain sum)."""
    out = None
    for p in partials:
        out = p.copy() if out is None else out + p
    return out
