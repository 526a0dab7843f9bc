"""The plain reference against brute force."""

import itertools

import numpy as np
import pytest

from gpubench import datagen, reference as ref


def brute_pairs(offsets, members, counts, n):
    shared = np.zeros((n, n), np.int64)
    for c in range(len(counts)):
        ms = members[offsets[c]:offsets[c + 1]]
        for a, b in itertools.combinations(ms, 2):
            shared[min(a, b), max(a, b)] += counts[c]
    return shared


def test_pairs_equal_brute_force(tiny_config):
    col = datagen.generate(tiny_config, 21)
    p = ref.pairs(col.offsets, col.members, col.counts, col.n)
    want = brute_pairs(col.offsets, col.members, col.counts, col.n)
    i, j = np.nonzero(want)
    assert np.array_equal(p.i, i) and np.array_equal(p.j, j)
    assert np.array_equal(p.shared, want[i, j])


def test_containment_is_float32_division():
    shared = np.array([1, 3, 700])
    ki, kj = np.array([3, 7, 4000]), np.array([9, 3, 3500])
    cmin, cavg, cmax = ref.containment(shared, ki, kj)
    for s, a, b, lo, mid, hi in zip(shared, ki, kj, cmin, cavg, cmax):
        c1, c2 = np.float32(s) / np.float32(b), np.float32(s) / np.float32(a)
        assert lo == min(c1, c2) and hi == max(c1, c2)
        assert mid == np.float32((c1 + c2) / np.float32(2))
    assert cmax.dtype == np.float32


def test_printed_is_six_significant_digits():
    x = np.array([0.123456789, 1.0, 1 / 3, 2.5e-5], np.float32)
    assert ref.printed(x).tolist() == [float(f"{float(v):.6g}") for v in x]
    gap = np.abs(ref.printed(x) - x.astype(np.float64)) / ref.half_digit(x)
    assert (gap <= 1.0 + 1e-9).all()


def test_cutoff_on_printed_values_matches_formatting():
    rng = np.random.default_rng(3)
    cut = 0.6
    d = np.concatenate([np.float32(cut) + rng.integers(-40, 40, 400).astype(np.float32)
                        * np.float32(1e-7), rng.random(1000).astype(np.float32)])
    d = d.astype(np.float32)
    want = np.array([float(f"{float(v):.6g}") * 100.0 >= cut * 100.0 for v in d])
    assert np.array_equal(ref.above_cutoff_printed(d, cut), want)


def test_components_equal_a_breadth_first_search():
    rng = np.random.default_rng(4)
    n = 200
    src, dst = rng.integers(0, n, 150), rng.integers(0, n, 150)
    labels = ref.components(n, src, dst)
    adj = {g: set() for g in range(n)}
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].add(b)
        adj[b].add(a)
    seen, want = set(), set()
    for g in range(n):
        if g in seen:
            continue
        comp, todo = {g}, [g]
        while todo:
            for h in adj[todo.pop()] - comp:
                comp.add(h)
                todo.append(h)
        seen |= comp
        want.add(frozenset(comp))
    assert ref.partition(labels) == want
    assert all(labels[g] == min(c) for c in want for g in c)


def csr(colors, counts):
    """offsets, members, counts of a list of member lists."""
    offsets = np.concatenate(([0], np.cumsum([len(c) for c in colors]))).astype(np.int64)
    members = np.concatenate([np.sort(c) for c in colors]).astype(np.int32)
    return offsets, members, np.asarray(counts, np.int64)


def assert_pairs_equal_brute_force(offsets, members, counts, n):
    p = ref.pairs(offsets, members, counts, n)
    want = brute_pairs(offsets, members, counts, n)
    i, j = np.nonzero(want)
    assert np.array_equal(p.i, i) and np.array_equal(p.j, j)
    assert np.array_equal(p.shared, want[i, j])


def grouped_collection(degree, repeats, n=260, seed=0):
    """Singletons; one color of ``degree`` members of genomes 0-79, the
    first multi-member color, ``repeats`` times; colors of 63, 64 and 65
    members of genomes 100-199, enough times each to be linked; colors
    over genomes 200-259 as a cross-species hash's are."""
    rng = np.random.default_rng(seed)
    colors = [[g] for g in range(n)]
    colors += [rng.choice(80, degree, replace=False)] * repeats
    for d in (63, 64, 65):
        colors += [100 + rng.choice(100, d, replace=False)] * (
            ref.LINK_SAMPLE * ref.LINK_MIN)
    colors += [200 + rng.choice(60, d, replace=False) for d in (2, 13, 40, 60)]
    counts = rng.integers(1, 3000, len(colors))
    return csr(colors, counts) + (n,)


@pytest.mark.parametrize("degree", [ref.LINK_MIN_DEGREE - 1, ref.LINK_MIN_DEGREE,
                                    ref.LINK_MIN_DEGREE + 1, 40])
@pytest.mark.parametrize("seen", [ref.LINK_MIN - 1, ref.LINK_MIN])
def test_grouped_pairs_equal_brute_force(degree, seen):
    """A color just below, at and above the size that makes links, read
    just below and at the count that makes a link, goes pair by pair or
    into its group's product; colors of 63-65 members go into theirs; the
    pairs are the same."""
    repeats = ref.LINK_SAMPLE * (seen - 1) + 1  # read ``seen`` times
    offsets, members, counts, n = grouped_collection(degree, repeats)
    label = ref.groups(offsets, members, n)
    first = members[offsets[n]:offsets[n + 1]]
    linked = degree > ref.LINK_MIN_DEGREE and seen >= ref.LINK_MIN
    assert len(set(label[first].tolist())) == (1 if linked else degree)
    assert len(set(label[100:200].tolist())) < 10
    assert len(set(label[200:].tolist())) == 60
    assert_pairs_equal_brute_force(offsets, members, counts, n)


def test_grouped_pairs_in_tiles_and_blocks_and_past_the_largest_group(monkeypatch):
    """Species of 40 and 100 drawn by the generator: the pairs are the same
    with the group's product in column tiles and blocks of colors, and with
    its groups too large to take the product."""
    config = {"genomes": 256, "species_sizes": [[1, 56], [2, 10], [40, 2], [100, 1]],
              "core_hashes": [200, 300], "retention": [0.6, 0.95],
              "own_hashes": [10, 20], "cross_hashes_per_8192": 2000,
              "cross_degree": [16, 64], "ksize": 21, "scaled": 1000}
    col = datagen.generate(config, 5)
    args = (col.offsets, col.members, col.counts, col.n)
    sizes = np.bincount(ref.groups(col.offsets, col.members, col.n))
    assert sorted(sizes[sizes > 1].tolist()) == [40, 40, 100]
    assert_pairs_equal_brute_force(*args)
    monkeypatch.setattr(ref, "GROUP_TILE", 16)
    monkeypatch.setattr(ref, "BLOCK_ELEMENTS", 1000)
    assert_pairs_equal_brute_force(*args)
    monkeypatch.setattr(ref, "GROUP_MAX", 39)
    assert_pairs_equal_brute_force(*args)


def test_group_product_refuses_sums_that_float64_would_round():
    colors = [[0, 1, 2]] * 64
    offsets, members, counts = csr(colors, [2 ** 47] * 64)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        ref.group_pairs(offsets, members, counts, np.arange(64), np.arange(3), 3)
    counts[:] = 2 ** 47 - 1
    k, s = ref.group_pairs(offsets, members, counts, np.arange(64), np.arange(3), 3)
    assert k.tolist() == [1, 2, 5] and s.tolist() == [64 * (2 ** 47 - 1)] * 3
