"""Index ingestion on a torch device: sort postings, drop duplicates and
singleton runs.

Counterpart of ``kspider_tpu/ops/device_build.py``.  The index build is a
sort + run-length problem (``kspider_tpu/core/index.py``): a hash owned by
one sample contributes nothing to the pairwise matrix, and in typical
collections that is the large majority of postings.  On the device:

  1. the (hash, gid) postings are sorted by hash as **unsigned** 64-bit,
     then gid: two stable sorts, by gid and then by key.  torch has no
     unsigned 64-bit sort on CUDA, so each hash is mapped to int64 with its
     sign bit flipped, which makes signed order equal unsigned order;
  2. duplicate (hash, gid) postings are dropped;
  3. ``unique_consecutive`` counts the distinct samples of every hash run;
  4. postings of runs with >= 2 samples are kept by a boolean mask, which
     preserves their ascending (hash, gid) order.

JAX's shape buckets (``_posting_bucket``), pad sentinel and bucketed D2H
slice exist only to bound jit recompiles; torch runs the exact sizes.
"""

from typing import Optional, Tuple

import numpy as np
import torch

_SIGN = -(2**63)  # int64 with only the sign bit set


def _to_ordered_int64(hashes: np.ndarray) -> np.ndarray:
    """u64 hashes -> int64 keys whose signed order is the unsigned order."""
    return hashes.view(np.int64) ^ np.int64(_SIGN)


def compact_multi_postings(
    hashes: np.ndarray, gids: np.ndarray, *, device,
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The deduplicated (hash, gid) postings whose hash is shared by >= 2
    samples, sorted by (hash, gid): ``(u64 hashes, int32 gids)``.

    Runs on the torch ``device``.  ``stats``, if given, receives
    ``postings_in``, ``postings_kept``, ``h2d_bytes`` and, on a CUDA device,
    ``sort_ms`` (CUDA events around the two sorts)."""
    device = torch.device(device)
    keys_np = _to_ordered_int64(np.ascontiguousarray(hashes, dtype=np.uint64))
    gids_np = np.ascontiguousarray(gids, dtype=np.int32)
    if len(keys_np) != len(gids_np):
        raise ValueError(f"{len(keys_np)} hashes but {len(gids_np)} gids")
    keys = torch.from_numpy(keys_np).to(device)
    gid = torch.from_numpy(gids_np).to(device)
    timed = device.type == "cuda" and stats is not None
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    gid, order = torch.sort(gid, stable=True)
    keys = keys[order]
    keys, order = torch.sort(keys, stable=True)
    gid = gid[order]
    del order
    if timed:
        end.record()
    if len(keys) > 1:
        fresh = torch.ones(len(keys), dtype=torch.bool, device=device)
        fresh[1:] = (keys[1:] != keys[:-1]) | (gid[1:] != gid[:-1])
        keys, gid = keys[fresh], gid[fresh]
    _, run_samples = torch.unique_consecutive(keys, return_counts=True)
    keep = torch.repeat_interleave(run_samples >= 2, run_samples)
    keys, gid = keys[keep], gid[keep]
    out_hashes = _to_ordered_int64(keys.cpu().numpy()).view(np.uint64)
    out_gids = gid.cpu().numpy()
    if stats is not None:
        stats["postings_in"] = len(keys_np)
        stats["postings_kept"] = len(out_gids)
        stats["h2d_bytes"] = keys_np.nbytes + gids_np.nbytes
        if timed:
            stats["sort_ms"] = start.elapsed_time(end)
    return out_hashes, out_gids
