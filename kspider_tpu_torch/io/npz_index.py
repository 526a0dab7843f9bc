"""Fast-reload index cache (.kidx.npz).

The reference reloads its index by deserializing phmap tables
(kSpider/src/pairwise.cpp:95-170).  For repeated analysis runs we
additionally persist the :class:`ColorIndex` arrays as a single compressed
npz — loading is a plain mmap-friendly array read, and the layout is the
same CSR the engines consume directly.  The phmap artifacts remain the
interchange format; this cache is an optimization written alongside them.
"""

import json
import os
from typing import Optional

import numpy as np

from kspider_tpu_torch.core.index import ColorIndex

SUFFIX = ".kidx.npz"


def save(prefix: str, index: ColorIndex) -> str:
    path = prefix + SUFFIX
    meta = {
        "names": index.names,
        "ksize": index.ksize,
        "hash_mode": index.hash_mode,
        "slicing_mode": index.slicing_mode,
        "params": index.params,
        "version": 1,
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        group_kmer_count=index.group_kmer_count,
        color_ids=index.color_ids,
        color_offsets=index.color_offsets,
        color_members=index.color_members,
        color_counts=index.color_counts,
    )
    return path


def load(prefix: str) -> Optional[ColorIndex]:
    path = prefix + SUFFIX
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        return ColorIndex(
            names=list(meta["names"]),
            group_kmer_count=z["group_kmer_count"],
            color_ids=z["color_ids"],
            color_offsets=z["color_offsets"],
            color_members=z["color_members"],
            color_counts=z["color_counts"],
            ksize=int(meta["ksize"]),
            hash_mode=int(meta["hash_mode"]),
            slicing_mode=int(meta["slicing_mode"]),
            params=meta["params"],
        )
