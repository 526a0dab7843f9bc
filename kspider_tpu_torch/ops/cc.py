"""Connected components: min-label propagation with pointer jumping.

Counterpart of ``kspider_tpu/ops/cc.py``.  Every node starts with its own
index as label; each round scatters the smaller endpoint label of every
edge onto both endpoints (``scatter_reduce`` with ``amin``), then halves
paths twice (``labels = labels[labels]``).  It stops when a round changes
nothing, so it converges in O(log n) rounds, and a final gather points
every node at its component's minimum node index.
:func:`connected_components_dense` runs the same rounds over a dense
boolean adjacency, for the fused step (``parallel/step.py``).
"""

from typing import Optional

import numpy as np
import torch


def connected_components(
    edges_src: np.ndarray, edges_dst: np.ndarray, n: int, *, device
) -> np.ndarray:
    """Labels (int32, length n): each node's component representative
    (the minimum node index in its component), computed on ``device``."""
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if len(edges_src) == 0:
        return np.arange(n, dtype=np.int32)
    src = torch.as_tensor(np.asarray(edges_src, dtype=np.int64), device=device)
    dst = torch.as_tensor(np.asarray(edges_dst, dtype=np.int64), device=device)
    labels = torch.arange(n, dtype=torch.int64, device=device)
    while True:
        m = torch.minimum(labels[src], labels[dst])
        nxt = labels.scatter_reduce(0, src, m, "amin")
        nxt = nxt.scatter_reduce(0, dst, m, "amin")
        nxt = nxt[nxt]
        nxt = nxt[nxt]
        if torch.equal(nxt, labels):
            break
        labels = nxt
    return labels[labels].to(torch.int32).cpu().numpy()


def connected_components_dense(
    adj: torch.Tensor, stats: Optional[dict] = None
) -> torch.Tensor:
    """Labels (int32 tensor on ``adj``'s device) over a dense boolean
    adjacency ``[n, n]``: each node's component minimum node index.

    Counterpart of ``kspider_tpu/ops/cc.py:connected_components_dense``:
    each round takes the minimum label over every node's neighbours (self
    included), then halves paths twice; it stops when a round changes
    nothing.  ``stats``, if given, receives the number of ``rounds``."""
    n = adj.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    a = adj | eye
    labels = torch.arange(n, dtype=torch.int32, device=adj.device)
    none = torch.tensor(n, dtype=torch.int32, device=adj.device)
    rounds = 0
    while True:
        rounds += 1
        neigh = torch.where(a, labels[None, :], none).amin(dim=1)
        nxt = torch.minimum(labels, neigh)
        nxt = nxt[nxt]
        nxt = nxt[nxt]
        if torch.equal(nxt, labels):
            break
        labels = nxt
    if stats is not None:
        stats["rounds"] = rounds
    return labels[labels]


def connected_components_scipy(
    edges_src: np.ndarray, edges_dst: np.ndarray, n: int
) -> np.ndarray:
    """Host engine and cross-check via scipy.sparse.csgraph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as _cc

    if n == 0:
        return np.zeros(0, dtype=np.int32)
    g = sp.coo_matrix(
        (np.ones(len(edges_src), dtype=np.int8), (edges_src, edges_dst)),
        shape=(n, n),
    )
    _, raw = _cc(g, directed=False)
    # canonicalize: representative = min node index per component
    reps = np.full(raw.max() + 1, n, dtype=np.int64)
    np.minimum.at(reps, raw, np.arange(n))
    return reps[raw].astype(np.int32)


def labels_to_clusters(labels: np.ndarray):
    """Group node indices by label -> list of ascending-index components,
    ordered by their smallest node index."""
    order = np.lexsort((np.arange(len(labels)), labels))
    sorted_labels = labels[order]
    boundaries = np.flatnonzero(
        np.concatenate(([True], sorted_labels[1:] != sorted_labels[:-1]))
    )
    comps = np.split(order, boundaries[1:])
    comps.sort(key=lambda c: c[0])
    return comps
