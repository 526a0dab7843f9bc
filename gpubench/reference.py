"""The plain reference: pairs and clusters worked out again from the colors.

Plain numpy over a :class:`gpubench.datagen.Collection`, the same colors
that the benchmark writes into the index the program loads.  It imports
nothing of the program.

- :func:`pairs`: every pair of genomes that shares at least one hash, with
  its shared count: each color adds its count to every pair of its
  members.
- :func:`containment`: the three containment columns, in float32 as the
  pairwise TSV states them (C++ ``float``).
- :func:`printed`: a float32 value as the TSV prints it (``%g``, six
  significant digits) and a reader parses it back.
- :func:`components`: connected components by min-label propagation.
"""

from dataclasses import dataclass

import numpy as np

#: the distance columns of ``cluster -d``
DISTANCES = ("min_cont", "avg_cont", "max_cont")


@dataclass
class Pairs:
    """Pairs i < j (0-based) with shared >= 1, sorted by (i, j)."""

    i: np.ndarray  # int64
    j: np.ndarray  # int64
    shared: np.ndarray  # int64


def pairs(offsets: np.ndarray, members: np.ndarray, counts: np.ndarray,
          n: int) -> Pairs:
    """Shared counts of every pair that shares a hash."""
    degrees = np.diff(offsets)
    keys, weights = [], []
    for d in np.unique(degrees[degrees >= 2]):
        d = int(d)
        sel = np.flatnonzero(degrees == d)
        rows = members[offsets[sel][:, None] + np.arange(d)].astype(np.int64)
        a, b = np.triu_indices(d, k=1)
        lo = np.minimum(rows[:, a], rows[:, b])
        hi = np.maximum(rows[:, a], rows[:, b])
        keys.append((lo * n + hi).reshape(-1))
        weights.append(np.repeat(counts[sel], len(a)))
    if not keys:
        empty = np.zeros(0, np.int64)
        return Pairs(empty, empty, empty)
    keys = np.concatenate(keys)
    weights = np.concatenate(weights)
    order = np.argsort(keys, kind="stable")
    keys, weights = keys[order], weights[order]
    first = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
    uniq = keys[first]
    shared = np.add.reduceat(weights, first)
    return Pairs(uniq // n, uniq % n, shared.astype(np.int64))


def containment(shared: np.ndarray, k_i: np.ndarray, k_j: np.ndarray,
                dtype=np.float32):
    """(min, avg, max) containment of pairs: shared / k_j and shared / k_i
    divided in ``dtype`` (float32, as the TSV states); ``avg`` is their
    mean."""
    s = shared.astype(dtype)
    c_ij = s / k_j.astype(dtype)
    c_ji = s / k_i.astype(dtype)
    return (np.minimum(c_ij, c_ji), ((c_ij + c_ji) / dtype(2)).astype(dtype),
            np.maximum(c_ij, c_ji))


def printed(x: np.ndarray) -> np.ndarray:
    """float64 of ``"%g" % x`` for each float32 ``x`` (six significant
    digits, as C++ prints a float and the TSV holds it)."""
    return np.array([float(f"{v:.6g}") for v in np.asarray(x, np.float64)])


def half_digit(x: np.ndarray) -> np.ndarray:
    """Half a unit of the sixth significant digit of each value: the most
    by which a correctly printed value may differ from it."""
    x = np.abs(np.asarray(x, np.float64))
    exp = np.floor(np.log10(np.where(x > 0, x, 1.0)))
    return 0.5 * 10.0 ** (exp - 5)


def above_cutoff_printed(d: np.ndarray, cutoff: float) -> np.ndarray:
    """The TSV reader's edge rule on float32 distances ``d``: the printed
    value, times 100, at least ``cutoff`` times 100.  Values far from the
    cutoff are decided on ``d`` itself; the rest are printed."""
    c = float(cutoff)
    d64 = np.asarray(d, np.float64)
    keep = d64 * 100.0 >= c * 100.0
    near = np.flatnonzero(np.abs(d64 - c) <= 4 * half_digit(np.array([c]))[0]
                          + 1e-12)
    if len(near):
        keep[near] = printed(d64[near]) * 100.0 >= c * 100.0
    return keep


def components(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Each node's component label, the smallest node in its component."""
    labels = np.arange(n, dtype=np.int64)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    while True:
        low = np.minimum(labels[src], labels[dst])
        nxt = labels.copy()
        np.minimum.at(nxt, src, low)
        np.minimum.at(nxt, dst, low)
        while True:
            jumped = nxt[nxt]
            if np.array_equal(jumped, nxt):
                break
            nxt = jumped
        if np.array_equal(nxt, labels):
            return labels
        labels = nxt


def partition(labels: np.ndarray):
    """The components as a set of frozensets of node ids."""
    order = np.argsort(labels, kind="stable")
    cut = np.flatnonzero(np.diff(labels[order])) + 1
    return {frozenset(c.tolist()) for c in np.split(order, cut)}
