"""A genome collection's color index, drawn from ``--seed`` in seconds.

The pairwise and cluster stages read the color index, not the sketches, so
the benchmark draws the index's color classes straight from the collection
model instead of drawing hash sets and indexing them (which takes minutes
at N = 32,768).  The model, set in a configuration file:

- genomes come in species: ``group_size`` genomes each, or sizes as the
  histogram ``species_sizes`` gives them, ``[[size, species], ...]`` with
  sizes strictly ascending and sizes times counts summing to ``genomes``
  (data the configuration defends; no law of sizes is written here);
- each species has a core of ``core_hashes`` hashes (uniform, inclusive);
- each genome keeps each core hash with its own probability, drawn from
  ``retention`` (uniform), and adds ``own_hashes`` hashes of its own;
- ``cross_hashes_per_8192`` hashes per 8,192 genomes each sit in
  ``cross_degree`` genomes (uniform, inclusive) drawn from the whole
  collection;
- genome ids are a permutation drawn from the seed, so a species' members
  lie scattered over the id range, as in an index ordered by accession
  (and so over the panel engine's panels, which are ranges of ids).

A color is the set of genomes that hold a hash, and its count is the
number of such hashes.  A species of up to :data:`MULTINOMIAL_MAX_SIZE`
members contributes, for every subset of its members, the number of core
hashes that exactly that subset kept (one multinomial draw over the
``2**size`` subsets).  A larger one draws each core hash's member set
directly, one Bernoulli draw per member, and equal member sets merge into
one color whose count is their multiplicity.  Both draw from the same law,
so the cut-over sets the cost, not the model.  The empty subset holds no
hash, and a one-member subset merges with that genome's own hashes into
its singleton color.  Each cross hash is a color of count 1.  A genome's
k-mer count is the sum of the counts of its colors.  ``group_size: s`` is
the histogram ``[[s, genomes // s]]``.

Colors are kept in the index's canonical order, by degree and then by
their member lists, with ids ``g + 1`` for the singleton of genome ``g``
and ``N + 1, N + 2, ...`` for the others.  :func:`write_index` writes the
``.kidx.npz`` and ``.namesMap`` files that the program's ``pairwise`` and
``cluster`` commands load.  Plain numpy; nothing here imports the program.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

#: the npz index's metadata, as an index built with ``-k 21`` records it
#: (hash_mode 1 is the murmur hasher, slicing_mode 1 plain k-mers)
HASH_MODE = 1
SLICING_MODE = 1
#: the largest species whose core is one multinomial over its member
#: subsets; a larger one draws a Bernoulli per member and core hash.  At
#: 12 the multinomial's 4,096 subsets cost less than the 5,500 x 12 draws
#: of a core of 5,500 hashes, and its [species, 2**size] table stays small;
#: beyond it the table doubles with each member
MULTINOMIAL_MAX_SIZE = 12
#: uniform draws held at once on the Bernoulli path (32 MiB of float64)
DRAW_BLOCK = 1 << 22


@dataclass
class Collection:
    """A drawn collection: the color CSR and each genome's k-mer count."""

    names: List[str]
    kmer_counts: np.ndarray  # int64[N]
    offsets: np.ndarray  # int64[C + 1]
    members: np.ndarray  # int32[postings], ascending within a color
    counts: np.ndarray  # int64[C], hashes per color
    ksize: int

    @property
    def n(self) -> int:
        return len(self.names)


def _subset_bits(size: int) -> np.ndarray:
    """bits[m, i] = 1 when member i is in subset m (int8[2**size, size])."""
    masks = np.arange(1 << size)
    return ((masks[:, None] >> np.arange(size)) & 1).astype(np.int8)


def _draw_cross_members(rng, n: int, degrees: np.ndarray) -> List[np.ndarray]:
    return [np.sort(rng.choice(n, size=int(d), replace=False)) for d in degrees]


def _canonical(rows_by_degree, counts_by_degree):
    """Colors ordered by degree, then by member list; returns the CSR."""
    offsets, members, counts = [np.zeros(1, np.int64)], [], []
    end = 0
    for d in sorted(rows_by_degree):
        rows = np.concatenate(rows_by_degree[d]).reshape(-1, d)
        cnt = np.concatenate(counts_by_degree[d])
        order = np.lexsort(rows.T[::-1])
        members.append(rows[order].reshape(-1))
        counts.append(cnt[order])
        offsets.append(end + d * np.arange(1, len(cnt) + 1, dtype=np.int64))
        end += d * len(cnt)
    return (np.concatenate(offsets), np.concatenate(members).astype(np.int32),
            np.concatenate(counts).astype(np.int64))


def species_sizes(config: dict) -> np.ndarray:
    """Each species' size, in the histogram's order (int64): ``group_size``
    repeated, or ``species_sizes`` expanded."""
    n = int(config["genomes"])
    if "species_sizes" not in config:
        size = int(config["group_size"])
        if n % size:
            raise ValueError(f"genomes ({n}) is not a multiple of group_size ({size})")
        return np.full(n // size, size, np.int64)
    hist = [(int(s), int(c)) for s, c in config["species_sizes"]]
    sizes = [s for s, _ in hist]
    if any(s < 1 for s in sizes) or any(c < 0 for _, c in hist):
        raise ValueError(f"species_sizes {hist}: sizes must be >= 1, counts >= 0")
    if sizes != sorted(set(sizes)):
        raise ValueError(f"species_sizes {hist}: sizes must be strictly ascending")
    total = sum(s * c for s, c in hist)
    if total != n:
        raise ValueError(f"species_sizes hold {total} genomes, not genomes ({n})")
    return np.repeat(np.array(sizes, np.int64), [c for _, c in hist])


def _multinomial_class(rng, size, core, keep_p, first, own, rows, counts):
    """The cores of the species of one ``size`` up to the cut-over: one
    multinomial over the ``2**size`` member subsets per species; ``first``
    holds each species' first member slot.  Colors go into ``rows`` and
    ``counts`` by degree, as member slots; one-member subsets into ``own``."""
    bits = _subset_bits(size)
    # P(exactly subset m kept a core hash), per species: [species, 2**size]
    log_p = bits @ np.log(keep_p).T + (1 - bits) @ np.log1p(-keep_p).T
    probs = np.exp(log_p.T)
    probs /= probs.sum(axis=1, keepdims=True)
    subset_counts = rng.multinomial(core, probs).astype(np.int64)
    own[(first[:, None] + np.arange(size)).reshape(-1)] += \
        subset_counts[:, 1 << np.arange(size)].reshape(-1)
    popcount = bits.sum(axis=1)
    for d in range(2, size + 1):
        for m in np.flatnonzero(popcount == d):
            c = subset_counts[:, m]
            held = np.flatnonzero(c)
            rows.setdefault(d, []).append(
                (first[held][:, None] + np.flatnonzero(bits[m])[None, :]).reshape(-1))
            counts.setdefault(d, []).append(c[held])


def _bernoulli_species(rng, core, keep_p, first, own, rows, counts):
    """One species above the cut-over: each of ``core`` hashes kept by
    each member with its probability ``keep_p``; equal member sets merge."""
    size = len(keep_p)
    step = max(1, DRAW_BLOCK // size)
    packed = np.concatenate([
        np.packbits(rng.random((min(step, core - r), size)) < keep_p, axis=1)
        for r in range(0, core, step)]) if core else np.zeros((0, (size + 7) // 8),
                                                             np.uint8)
    sets, mult = np.unique(packed, axis=0, return_counts=True)
    kept = np.unpackbits(sets, axis=1, count=size).astype(bool)
    degree = kept.sum(axis=1)
    single = degree == 1
    own[first + np.argmax(kept[single], axis=1)] += mult[single]
    multi = np.flatnonzero(degree >= 2)
    multi = multi[np.argsort(degree[multi], kind="stable")]
    slots = first + np.nonzero(kept[multi])[1]
    ds, n_sets = np.unique(degree[multi], return_counts=True)
    ends = np.cumsum(ds * n_sets)
    for d, k, end, stop in zip(ds.tolist(), n_sets.tolist(), ends.tolist(),
                               np.cumsum(n_sets).tolist()):
        rows.setdefault(d, []).append(slots[end - d * k:end])
        counts.setdefault(d, []).append(mult[multi[stop - k:stop]].astype(np.int64))


def generate(config: dict, seed) -> Collection:
    """Draw one collection of ``config["genomes"]`` genomes from ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(config["genomes"])
    sizes = species_sizes(config)
    core_lo, core_hi = config["core_hashes"]
    own_lo, own_hi = config["own_hashes"]
    ret_lo, ret_hi = config["retention"]
    deg_lo, deg_hi = config["cross_degree"]
    if deg_hi > n:
        raise ValueError(f"cross_degree {deg_hi} exceeds the {n} genomes")

    core = rng.integers(core_lo, core_hi + 1, len(sizes))
    keep_p = rng.uniform(ret_lo, ret_hi, n)  # per member slot
    own = rng.integers(own_lo, own_hi + 1, n).astype(np.int64)
    first = np.concatenate(([0], np.cumsum(sizes)[:-1])).astype(np.int64)
    # colors by degree, their members as member slots
    rows: Dict[int, List[np.ndarray]] = {}
    weights: Dict[int, List[np.ndarray]] = {}
    for size in np.unique(sizes).tolist():
        of = np.flatnonzero(sizes == size)
        if size <= MULTINOMIAL_MAX_SIZE:
            slots = first[of][:, None] + np.arange(size)
            _multinomial_class(rng, size, core[of], keep_p[slots], first[of],
                               own, rows, weights)
        else:
            for k in of:
                _bernoulli_species(rng, int(core[k]), keep_p[first[k]:first[k] + size],
                                   first[k], own, rows, weights)

    n_cross = int(config["cross_hashes_per_8192"]) * n // 8192
    cross_deg = rng.integers(deg_lo, deg_hi + 1, n_cross)
    cross_rows = _draw_cross_members(rng, n, cross_deg)

    # genome id of member slot s: genome_id[s]
    genome_id = rng.permutation(n).astype(np.int64)

    rows_by_degree = {1: [genome_id]}
    counts_by_degree = {1: [own]}
    for d in sorted(rows):
        slots = np.concatenate(rows[d]).reshape(-1, d)
        rows_by_degree[d] = [np.sort(genome_id[slots], axis=1).reshape(-1)]
        counts_by_degree[d] = [np.concatenate(weights[d])]
    for d in np.unique(cross_deg).tolist():
        sel = np.flatnonzero(cross_deg == d)
        rows_by_degree.setdefault(d, []).append(
            np.concatenate([cross_rows[i] for i in sel]).astype(np.int64))
        counts_by_degree.setdefault(d, []).append(np.ones(len(sel), np.int64))
    offsets, members, counts = _canonical(rows_by_degree, counts_by_degree)

    kmer_counts = np.bincount(members, weights=np.repeat(counts, np.diff(offsets)),
                              minlength=n).astype(np.int64)
    names = [f"GCA_{g + 1:09d}.1" for g in range(n)]
    return Collection(names=names, kmer_counts=kmer_counts, offsets=offsets,
                      members=members, counts=counts, ksize=int(config["ksize"]))


def color_ids(col: Collection) -> np.ndarray:
    """The index's color ids: ``g + 1`` for genome g's singleton, then
    ``N + 1, N + 2, ...`` in order for the colors of two or more genomes."""
    degrees = np.diff(col.offsets)
    ids = np.zeros(len(col.counts), dtype=np.uint64)
    single = degrees == 1
    ids[single] = col.members[col.offsets[:-1][single]].astype(np.uint64) + 1
    ids[~single] = np.arange(col.n + 1, col.n + 1 + int((~single).sum()),
                             dtype=np.uint64)
    return ids


def write_index(col: Collection, prefix: str) -> None:
    """Write ``<prefix>.kidx.npz`` and ``<prefix>.namesMap`` as the program's
    ``index`` command writes them."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    meta = {"names": col.names, "ksize": col.ksize, "hash_mode": HASH_MODE,
            "slicing_mode": SLICING_MODE, "params": f"kSize:{col.ksize}",
            "version": 1}
    np.savez_compressed(
        prefix + ".kidx.npz",
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        group_kmer_count=col.kmer_counts,
        color_ids=color_ids(col),
        color_offsets=col.offsets,
        color_members=col.members,
        color_counts=col.counts,
    )
    with open(prefix + ".namesMap", "w") as f:
        f.write(f"{col.n}\n")
        f.writelines(f"{g + 1} {name}\n" for g, name in enumerate(col.names))
