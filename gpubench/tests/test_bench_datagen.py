"""The generator: deterministic per seed, consistent as an index, and the
same collection model as explicit hash sets."""

import numpy as np
import pytest

from conftest import TINY
from gpubench import datagen, reference


def test_same_seed_same_collection(tiny_config):
    a = datagen.generate(tiny_config, [2**31 + 5, 0])
    b = datagen.generate(tiny_config, [2**31 + 5, 0])
    c = datagen.generate(tiny_config, [2**31 + 6, 0])
    for field in ("kmer_counts", "offsets", "members", "counts"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert a.names == b.names
    assert not np.array_equal(a.counts, c.counts) or not np.array_equal(
        a.members, c.members)


#: species of sizes on both sides of the multinomial's cut-over (12), with
#: small cores so that the explicit sets stay cheap
SPECIES = {"genomes": 174, "species_sizes": [[1, 20], [2, 10], [7, 4], [13, 2], [40, 2]],
           "core_hashes": [200, 300], "retention": [0.6, 0.95],
           "own_hashes": [10, 20], "cross_hashes_per_8192": 2000,
           "cross_degree": [16, 64], "ksize": 21, "scaled": 1000}

CONFIGS = pytest.mark.parametrize("config", [TINY, SPECIES],
                                  ids=["group_size", "species_sizes"])


@CONFIGS
def test_kmer_counts_are_the_sum_of_their_colors(config):
    col = datagen.generate(config, 11)
    want = np.zeros(col.n, np.int64)
    for c in range(len(col.counts)):
        for g in col.members[col.offsets[c]:col.offsets[c + 1]]:
            want[g] += col.counts[c]
    assert np.array_equal(col.kmer_counts, want)


@CONFIGS
def test_colors_are_an_index_in_canonical_order(config):
    col = datagen.generate(config, 12)
    rows = [tuple(col.members[col.offsets[c]:col.offsets[c + 1]].tolist())
            for c in range(len(col.counts))]
    assert all(list(r) == sorted(set(r)) for r in rows)
    assert rows == sorted(rows, key=lambda r: (len(r), r))
    assert len(set(rows)) == len(rows) and (col.counts > 0).all()
    assert [r[0] for r in rows if len(r) == 1] == list(range(col.n))
    ids = datagen.color_ids(col)
    assert ids[:col.n].tolist() == list(range(1, col.n + 1))
    assert ids[col.n:].tolist() == list(range(col.n + 1, len(rows) + 1))


def species_of(config):
    """Each species' size: ``group_size`` repeated, or ``species_sizes``."""
    if "species_sizes" in config:
        return [s for s, c in config["species_sizes"] for _ in range(c)]
    return [config["group_size"]] * (config["genomes"] // config["group_size"])


def explicit_hash_sets(config, seed):
    """The collection model drawn hash by hash, as a plain loop."""
    rng = np.random.default_rng(seed)
    n = config["genomes"]
    sets = [set() for _ in range(n)]
    next_hash = 0
    first = 0
    for size in species_of(config):
        core = range(next_hash, next_hash + int(rng.integers(
            config["core_hashes"][0], config["core_hashes"][1] + 1)))
        next_hash = core.stop
        first += size
        for g in range(first - size, first):
            p = rng.uniform(*config["retention"])
            sets[g].update(np.array(core)[rng.random(len(core)) < p].tolist())
            own = int(rng.integers(config["own_hashes"][0], config["own_hashes"][1] + 1))
            sets[g].update(range(next_hash, next_hash + own))
            next_hash += own
    for _ in range(config["cross_hashes_per_8192"] * n // 8192):
        d = int(rng.integers(config["cross_degree"][0], config["cross_degree"][1] + 1))
        for g in rng.choice(n, size=d, replace=False):
            sets[g].add(next_hash)
        next_hash += 1
    return sets


def colors_of(sets):
    """The colors of explicit hash sets: member set -> hashes."""
    holders = {}
    for g, s in enumerate(sets):
        for h in s:
            holders.setdefault(h, []).append(g)
    colors = {}
    for members in holders.values():
        key = tuple(sorted(members))
        colors[key] = colors.get(key, 0) + 1
    return colors


@pytest.mark.parametrize("config,bins,tol", [
    (dict(TINY, genomes=256), [], 0.03),
    # colors of 2-7 genomes come from the small species and the sizes
    # above 7 from the large ones (cross-species colors hold 16 or more)
    (SPECIES, [(2, 7), (8, 15), (16, 40), (41, 64)], 0.1),
], ids=["group_size", "species_sizes"])
def test_generator_matches_explicit_hash_sets_of_the_model(config, bins, tol):
    """Over several seeds, the drawn colors and counts follow the same
    distribution as hash sets drawn one hash at a time from the model: in
    total, and by the size of the color.  The histogram holds species of
    sizes 1, 2, 7 (multinomial), 13 and 40 (a Bernoulli per member and core
    hash)."""
    n = config["genomes"]
    drawn = [datagen.generate(config, s) for s in range(6)]
    explicit = [colors_of(explicit_hash_sets(config, 100 + s)) for s in range(6)]

    def d_stats(c):
        deg = np.diff(c.offsets)
        return [len(c.counts), c.kmer_counts.mean(), int((deg >= 2).sum()),
                float(c.counts[deg >= 2].sum())] + [
            int(((deg >= lo) & (deg <= hi)).sum()) for lo, hi in bins]

    def e_stats(c):
        return [len(c), sum(w * len(k) for k, w in c.items()) / n,
                sum(len(k) >= 2 for k in c),
                float(sum(w for k, w in c.items() if len(k) >= 2))] + [
            sum(lo <= len(k) <= hi for k in c) for lo, hi in bins]

    d = np.array([d_stats(c) for c in drawn], np.float64)
    e = np.array([e_stats(c) for c in explicit], np.float64)
    # each mean within four standard errors of the other's (per-seed
    # statistics vary with the cores and retentions drawn)
    gap = np.abs(d.mean(axis=0) - e.mean(axis=0))
    se = np.sqrt(d.var(axis=0, ddof=1) / len(d) + e.var(axis=0, ddof=1) / len(e))
    assert (gap <= 4 * se).all(), (d.mean(axis=0), e.mean(axis=0), se)
    assert (gap < tol * e.mean(axis=0)).all(), (d.mean(axis=0), e.mean(axis=0))


def test_a_large_species_keeps_each_core_hash_at_its_members_retention():
    """One species of 13 (Bernoulli per member) at a retention of 0.1, with
    one own hash a genome and no cross hashes: the core hashes that no
    member, one member, or two and more kept come out at the rates of the
    law, within five standard deviations."""
    config = {"genomes": 13, "species_sizes": [[13, 1]], "core_hashes": [5000, 5000],
              "retention": [0.1, 0.1], "own_hashes": [1, 1], "cross_hashes_per_8192": 0,
              "cross_degree": [2, 2], "ksize": 21, "scaled": 1000}
    core, p, size = 5000, 0.1, 13
    for seed in range(3):
        col = datagen.generate(config, seed)
        deg = np.diff(col.offsets)
        alone = int(col.counts[deg == 1].sum()) - size  # less the own hashes
        shared = int(col.counts[deg >= 2].sum())
        for got, rate in ((alone, size * p * (1 - p) ** (size - 1)),
                          (shared, 1 - (1 - p) ** size - size * p * (1 - p) ** (size - 1))):
            assert abs(got - core * rate) < 5 * np.sqrt(core * rate * (1 - rate))
        assert abs((col.kmer_counts - 1).mean() - core * p) < 5 * np.sqrt(core * p / size)


def test_one_species_size_draws_as_group_size(tiny_config):
    """A histogram of one size at most the cut-over draws the very
    collection that ``group_size`` of that size draws."""
    config = {k: v for k, v in tiny_config.items() if k != "group_size"}
    config["species_sizes"] = [[8, tiny_config["genomes"] // 8]]
    for seed in ([2**31 + 5, 0], 17):
        a = datagen.generate(tiny_config, seed)
        b = datagen.generate(config, seed)
        for field in ("kmer_counts", "offsets", "members", "counts"):
            assert np.array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("sizes,error", [
    ([[1, 10], [8, 20]], "hold 170 genomes"),
    ([[8, 20], [1, 14]], "strictly ascending"),
    ([[0, 14], [8, 20]], "sizes must be >= 1"),
])
def test_species_sizes_are_checked(sizes, error):
    with pytest.raises(ValueError, match=error):
        datagen.generate(dict(SPECIES, species_sizes=sizes), 1)


def test_pairs_equal_a_brute_force_intersection_of_explicit_sets(tiny_config):
    """Give each color's hashes to its members as explicit sets: every
    pair's set intersection is the reference's shared count."""
    col = datagen.generate(tiny_config, 13)
    sets = [set() for _ in range(col.n)]
    h = 0
    for c in range(len(col.counts)):
        hashes = range(h, h + int(col.counts[c]))
        h = hashes.stop
        for g in col.members[col.offsets[c]:col.offsets[c + 1]]:
            sets[g].update(hashes)
    assert [len(s) for s in sets] == col.kmer_counts.tolist()
    p = reference.pairs(col.offsets, col.members, col.counts, col.n)
    got = {(i, j): s for i, j, s in zip(p.i.tolist(), p.j.tolist(), p.shared.tolist())}
    want = {(i, j): len(sets[i] & sets[j]) for i in range(col.n)
            for j in range(i + 1, col.n) if sets[i] & sets[j]}
    assert got == want
    # the index written for the program holds the same colors
    assert colors_of(sets) == {
        tuple(col.members[col.offsets[c]:col.offsets[c + 1]].tolist()): int(col.counts[c])
        for c in range(len(col.counts))}


def test_write_index_files(tiny_config, tmp_path):
    import json

    col = datagen.generate(tiny_config, 14)
    prefix = str(tmp_path / "d" / "derep")
    datagen.write_index(col, prefix)
    with np.load(prefix + ".kidx.npz") as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        assert meta["names"] == col.names and meta["ksize"] == 21
        assert np.array_equal(z["color_members"], col.members)
        assert np.array_equal(z["group_kmer_count"], col.kmer_counts)
    with open(prefix + ".namesMap") as f:
        lines = f.read().splitlines()
    assert lines[0] == str(col.n) and lines[1] == f"1 {col.names[0]}"
