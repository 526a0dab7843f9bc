"""The plain reference against brute force."""

import itertools

import numpy as np

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
