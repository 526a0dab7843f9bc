"""The plain reference: pairs and clusters worked out again from the colors.

Plain numpy over a :class:`gpubench.datagen.Collection`, the same colors
that the benchmark writes into the index the program loads.  It imports
nothing of the program.

- :func:`pairs`: every pair of genomes that shares at least one hash, with
  its shared count: each color adds its count to every pair of its
  members.  Colors are listed pair by pair, except those that lie inside
  one of the groups that :func:`groups` finds (the large species of a
  ``species_sizes`` collection): those are summed per group as a dense
  product in float64 (:func:`group_pairs`).
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


#: colors of more members than this link their neighbouring members (two
#: members with no member of the color between them) for :func:`groups`:
#: more than the largest species that draws its core as one multinomial
#: (``datagen.MULTINOMIAL_MAX_SIZE``), so that species of a few genomes
#: make no links
LINK_MIN_DEGREE = 12
#: :func:`groups` reads every this many of those colors, in index order
LINK_SAMPLE = 8
#: two genomes are linked when they are neighbours in this many of the
#: colors read: a species above the cut-over gives tens to thousands, a
#: color over random genomes, as a cross-species hash is, 1
LINK_MIN = 4
#: a group of more genomes than this is listed pair by pair
GROUP_MAX = 16384
#: columns of a group's product at a time, and the float64 elements of one
#: block of its membership matrix (128 MiB)
GROUP_TILE = 2048
BLOCK_ELEMENTS = 1 << 24


def _positions(offsets: np.ndarray, colors: np.ndarray, drop_last: int = 0):
    """Positions in ``members`` of each color's members, color by color,
    without the last ``drop_last`` of each."""
    deg = offsets[colors + 1] - offsets[colors] - drop_last
    return (np.repeat(offsets[colors] - np.cumsum(deg) + deg, deg)
            + np.arange(int(deg.sum())))


def groups(offsets: np.ndarray, members: np.ndarray, n: int) -> np.ndarray:
    """Each genome's group, labelled by its smallest genome: the components
    of the links between genomes that are neighbours in :data:`LINK_MIN` or
    more of the colors read.  :func:`pairs` gives the same answer for any
    grouping; this one finds the species of more than
    :data:`LINK_MIN_DEGREE` genomes, and makes no group of the colors of
    small species or of colors over random genomes."""
    read = np.flatnonzero(np.diff(offsets) > LINK_MIN_DEGREE)[::LINK_SAMPLE]
    pos = _positions(offsets, read, drop_last=1)
    keys = members[pos].astype(np.int64) * n + members[pos + 1]
    uniq, seen = np.unique(keys, return_counts=True)
    strong = uniq[seen >= LINK_MIN]
    return components(n, strong // n, strong % n)


def group_pairs(offsets: np.ndarray, members: np.ndarray, weights: np.ndarray,
                colors: np.ndarray, genomes: np.ndarray, n: int):
    """(keys ``i * n + j``, shared counts) of the pairs that ``colors``, whose
    members all lie in the ascending ``genomes``, give: the upper triangle
    of Mᵀ·diag(w)·M in float64, M the colors' 0/1 membership of
    ``genomes``, in column tiles and blocks of colors.  Exact while every
    sum stays below 2**53, which it checks: the weights are not negative,
    so no sum exceeds their total."""
    if int(weights[colors].sum()) >= 2 ** 53:
        raise ValueError("a group's weights sum to 2**53 or more: float64 "
                         "would round its shared counts")
    w = weights[colors].astype(np.float64)
    g = len(genomes)
    local_of = np.zeros(n, np.int64)
    local_of[genomes] = np.arange(g)
    block = max(1, BLOCK_ELEMENTS // g)
    keys, shared = [], []
    for j0 in range(0, g, GROUP_TILE):
        j1 = min(g, j0 + GROUP_TILE)
        acc = np.zeros((j1, j1 - j0))  # rows i < j1, columns j0 <= j < j1
        for c0 in range(0, len(colors), block):
            cb = colors[c0:c0 + block]
            deg = offsets[cb + 1] - offsets[cb]
            local = local_of[members[_positions(offsets, cb)]]
            row = np.repeat(np.arange(len(cb)), deg)
            keep = local < j1
            m = np.zeros((len(cb), j1))
            m[row[keep], local[keep]] = 1.0
            acc += (m * w[c0:c0 + block, None]).T @ m[:, j0:]
        i, j = np.nonzero(acc)
        j += j0
        upper = i < j
        i, j = i[upper], j[upper]
        keys.append(genomes[i] * n + genomes[j])
        shared.append(acc[i, j - j0].astype(np.int64))
    return np.concatenate(keys), np.concatenate(shared)


def pairs(offsets: np.ndarray, members: np.ndarray, counts: np.ndarray,
          n: int) -> Pairs:
    """Shared counts of every pair that shares a hash: each color of two or
    more genomes inside one of :func:`groups`' groups through
    :func:`group_pairs`, every other color pair by pair."""
    degrees = np.diff(offsets)
    keys, weights = [], []
    listed = degrees >= 2
    label = groups(offsets, members, n)
    size = np.bincount(label, minlength=n)
    if (size[label] > 1).any():
        lab = label.astype(np.int32)[members]
        home = np.minimum.reduceat(lab, offsets[:-1])
        one = home == np.maximum.reduceat(lab, offsets[:-1])
        inside = np.flatnonzero(listed & one & (size[home] <= GROUP_MAX))
        listed[inside] = False
        inside = inside[np.argsort(home[inside], kind="stable")]
        cut = np.flatnonzero(np.diff(home[inside])) + 1
        for part in np.split(inside, cut) if len(inside) else ():
            genomes = np.flatnonzero(label == home[part[0]])
            k, s = group_pairs(offsets, members, counts, part, genomes, n)
            keys.append(k)
            weights.append(s)
    for d in np.unique(degrees[listed]):
        d = int(d)
        sel = np.flatnonzero(listed & (degrees == d))
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
