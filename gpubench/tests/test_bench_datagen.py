"""The generator: deterministic per seed, consistent as an index, and the
same collection model as explicit hash sets."""

import numpy as np

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


def test_kmer_counts_are_the_sum_of_their_colors(tiny_config):
    col = datagen.generate(tiny_config, 11)
    want = np.zeros(col.n, np.int64)
    for c in range(len(col.counts)):
        for g in col.members[col.offsets[c]:col.offsets[c + 1]]:
            want[g] += col.counts[c]
    assert np.array_equal(col.kmer_counts, want)


def test_colors_are_an_index_in_canonical_order(tiny_config):
    col = datagen.generate(tiny_config, 12)
    rows = [tuple(col.members[col.offsets[c]:col.offsets[c + 1]].tolist())
            for c in range(len(col.counts))]
    assert all(list(r) == sorted(set(r)) for r in rows)
    assert rows == sorted(rows, key=lambda r: (len(r), r))
    assert (col.counts > 0).all()
    assert [r[0] for r in rows if len(r) == 1] == list(range(col.n))
    ids = datagen.color_ids(col)
    assert ids[:col.n].tolist() == list(range(1, col.n + 1))
    assert ids[col.n:].tolist() == list(range(col.n + 1, len(rows) + 1))


def explicit_hash_sets(config, seed):
    """The collection model drawn hash by hash, as a plain loop."""
    rng = np.random.default_rng(seed)
    n, size = config["genomes"], config["group_size"]
    sets = [set() for _ in range(n)]
    next_hash = 0
    for group in range(n // size):
        core = range(next_hash, next_hash + int(rng.integers(
            config["core_hashes"][0], config["core_hashes"][1] + 1)))
        next_hash = core.stop
        for g in range(group * size, (group + 1) * size):
            p = rng.uniform(*config["retention"])
            sets[g].update(h for h in core if rng.random() < p)
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


def test_generator_matches_explicit_hash_sets_of_the_model(tiny_config):
    """Over several seeds, the drawn colors and counts follow the same
    distribution as hash sets drawn one hash at a time from the model."""
    config = dict(tiny_config, genomes=256)
    drawn = [datagen.generate(config, s) for s in range(6)]
    explicit = [colors_of(explicit_hash_sets(config, 100 + s)) for s in range(6)]
    def stats(colors_by_degree):
        return np.array(colors_by_degree, dtype=np.float64)
    d_colors = stats([len(c.counts) for c in drawn])
    e_colors = stats([len(c) for c in explicit])
    d_kmers = stats([c.kmer_counts.mean() for c in drawn])
    e_kmers = stats([sum(w * len(k) for k, w in c.items()) / config["genomes"]
                     for c in explicit])
    d_multi = stats([int((np.diff(c.offsets) >= 2).sum()) for c in drawn])
    e_multi = stats([sum(len(k) >= 2 for k in c) for c in explicit])
    for d, e in ((d_colors, e_colors), (d_kmers, e_kmers), (d_multi, e_multi)):
        assert abs(d.mean() - e.mean()) < 0.03 * e.mean()


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
