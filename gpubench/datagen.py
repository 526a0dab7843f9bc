"""A genome collection's color index, drawn from ``--seed`` in seconds.

The pairwise and cluster stages read the color index, not the sketches, so
the benchmark draws the index's color classes straight from the collection
model instead of drawing hash sets and indexing them (which takes minutes
at N = 32,768).  The model, set in a configuration file:

- genomes come in species groups of ``group_size``; each group has a core
  of ``core_hashes`` hashes (uniform, inclusive);
- each genome keeps each core hash with its own probability, drawn from
  ``retention`` (uniform), and adds ``own_hashes`` hashes of its own;
- ``cross_hashes_per_8192`` hashes per 8,192 genomes each sit in
  ``cross_degree`` genomes (uniform, inclusive) drawn from the whole
  collection;
- genome ids are a permutation drawn from the seed, so a species' members
  lie scattered over the id range, as in an index ordered by accession
  (and so over the panel engine's panels, which are ranges of ids).

A color is the set of genomes that hold a hash, and its count is the
number of such hashes.  So each group contributes, for every subset of its
members, the number of core hashes that exactly that subset kept (one
multinomial draw over the ``2**group_size`` subsets); the empty subset
holds no hash, and a one-member subset merges with that genome's own
hashes into its singleton color.  Each cross hash is a color of count 1.
A genome's k-mer count is the sum of the counts of its colors.

Colors are kept in the index's canonical order, by degree and then by
their member lists, with ids ``g + 1`` for the singleton of genome ``g``
and ``N + 1, N + 2, ...`` for the others.  :func:`write_index` writes the
``.kidx.npz`` and ``.namesMap`` files that the program's ``pairwise`` and
``cluster`` commands load.  Plain numpy; nothing here imports the program.
"""

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

#: the npz index's metadata, as an index built with ``-k 21`` records it
#: (hash_mode 1 is the murmur hasher, slicing_mode 1 plain k-mers)
HASH_MODE = 1
SLICING_MODE = 1


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


def generate(config: dict, seed: int) -> Collection:
    """Draw one collection of ``config["genomes"]`` genomes from ``seed``."""
    rng = np.random.default_rng(seed)
    n, size = int(config["genomes"]), int(config["group_size"])
    if n % size:
        raise ValueError(f"genomes ({n}) is not a multiple of group_size ({size})")
    groups = n // size
    core_lo, core_hi = config["core_hashes"]
    own_lo, own_hi = config["own_hashes"]
    ret_lo, ret_hi = config["retention"]
    deg_lo, deg_hi = config["cross_degree"]
    if deg_hi > n:
        raise ValueError(f"cross_degree {deg_hi} exceeds the {n} genomes")

    core = rng.integers(core_lo, core_hi + 1, groups)
    keep_p = rng.uniform(ret_lo, ret_hi, (groups, size))
    own = rng.integers(own_lo, own_hi + 1, n).astype(np.int64)
    bits = _subset_bits(size)
    # P(exactly subset m kept a core hash), per group: [groups, 2**size]
    log_p = bits @ np.log(keep_p).T + (1 - bits) @ np.log1p(-keep_p).T
    probs = np.exp(log_p.T)
    probs /= probs.sum(axis=1, keepdims=True)
    subset_counts = rng.multinomial(core, probs).astype(np.int64)

    n_cross = int(config["cross_hashes_per_8192"]) * n // 8192
    cross_deg = rng.integers(deg_lo, deg_hi + 1, n_cross)
    cross_rows = _draw_cross_members(rng, n, cross_deg)

    # genome id of member i of group k: genome_id[k * size + i]
    genome_id = rng.permutation(n).astype(np.int64)

    popcount = bits.sum(axis=1)
    # a one-member subset's hashes join that genome's own hashes
    own += subset_counts[:, 1 << np.arange(size)].reshape(-1)

    rows_by_degree = {1: [genome_id]}
    counts_by_degree = {1: [own]}
    base = (np.arange(groups, dtype=np.int64) * size)[:, None]
    for d in range(2, size + 1):
        for m in np.flatnonzero(popcount == d):
            c = subset_counts[:, m]
            held = np.flatnonzero(c)
            rows = np.sort(genome_id[base[held] + np.flatnonzero(bits[m])[None, :]],
                           axis=1)
            rows_by_degree.setdefault(d, []).append(rows.reshape(-1))
            counts_by_degree.setdefault(d, []).append(c[held])
    for d in np.unique(cross_deg):
        d = int(d)
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
