"""kspider_tpu_torch connected components vs kspider_tpu's and scipy's.

Seeded random graphs (isolated nodes, self-loops, duplicate edges), a long
path and the cases of tests/test_cc.py go through the port's torch label
propagation on the CPU, the JAX package's XLA version and scipy.
Tolerance: exact labels.
"""

import numpy as np
import pytest

from kspider_tpu.core import cluster as jcluster
from kspider_tpu.ops import cc as jcc
from kspider_tpu_torch.core import cluster as tcluster
from kspider_tpu_torch.ops import cc as tcc


def port_cc(src, dst, n):
    return tcc.connected_components(src, dst, n, device="cpu")


@pytest.mark.parametrize("n,e,seed", [(500, 800, 1), (800, 600, 2), (300, 40, 3),
                                      (64, 2000, 4)])
def test_random_graphs_match_jax_and_scipy(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    src[:5] = dst[:5]  # self-loops
    got = port_cc(src, dst, n)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jcc.connected_components(src, dst, n)))
    assert np.array_equal(got, jcc.connected_components_scipy(src, dst, n))
    assert np.array_equal(tcc.connected_components_scipy(src, dst, n),
                          jcc.connected_components_scipy(src, dst, n))


def test_long_path_converges():
    n = 4097
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    perm = np.random.default_rng(5).permutation(n - 1)  # edges out of order
    labels = port_cc(src[perm], dst[perm], n)
    assert np.all(labels == 0)


def test_simple_components():
    src = np.array([0, 1, 3], dtype=np.int32)
    dst = np.array([1, 2, 4], dtype=np.int32)
    assert port_cc(src, dst, 6).tolist() == [0, 0, 0, 3, 3, 5]


def test_no_edges_and_no_nodes():
    assert port_cc(np.empty(0, np.int32), np.empty(0, np.int32), 4).tolist() == [0, 1, 2, 3]
    assert port_cc(np.empty(0, np.int32), np.empty(0, np.int32), 0).tolist() == []


def test_labels_to_clusters_matches_jax():
    labels = np.array([0, 0, 2, 2, 0, 5], dtype=np.int32)
    got = tcc.labels_to_clusters(labels)
    assert [c.tolist() for c in got] == [[0, 1, 4], [2, 3], [5]]
    rng = np.random.default_rng(6)
    src = rng.integers(0, 300, 200)
    dst = rng.integers(0, 300, 200)
    labels = tcc.connected_components_scipy(src, dst, 300)
    assert [c.tolist() for c in tcc.labels_to_clusters(labels)] == [
        c.tolist() for c in jcc.labels_to_clusters(labels)]


def test_fold_edges_into_labels_matches_jax():
    rng = np.random.default_rng(8)
    n = 200
    labels_t = labels_j = np.arange(n, dtype=np.int32)
    for _ in range(4):
        src = rng.integers(0, n, 60).astype(np.int32)
        dst = rng.integers(0, n, 60).astype(np.int32)
        labels_t = tcluster.fold_edges_into_labels(labels_t, src, dst, n, port_cc)
        labels_j = jcluster.fold_edges_into_labels(
            labels_j, src, dst, n, jcc.connected_components)
        assert np.array_equal(labels_t, labels_j)


def write_graph(prefix, n, rng, rows=400):
    with open(prefix + ".namesMap", "w") as f:
        f.write(f"{n}\n")
        for i in range(1, n + 1):
            f.write(f"{i} s{i}\n")
    lines = []
    for _ in range(rows):
        a, b = sorted(rng.choice(n, size=2, replace=False) + 1)
        d = float(rng.random())
        lines.append(f"{a}\t{b}\t10\t{d:.4f}\t{d * 0.9:.4f}\t{d:.6g}")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h1\th2\th3\th4\th5\th6\n")
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("dist_type", ["min_cont", "avg_cont", "max_cont"])
def test_cluster_index_matches_jax(tmp_path, dist_type):
    n = 40
    prefix = str(tmp_path / "idx")
    write_graph(prefix, n, np.random.default_rng(9))
    want = open(jcluster.cluster_index(prefix, 0.5, dist_type, use_tpu=False)).read()
    for device, chunk_rows in ((None, 7), ("cpu", 13), ("cpu", 10**7)):
        out = tcluster.cluster_index(prefix, 0.5, dist_type, device=device,
                                     chunk_rows=chunk_rows)
        assert open(out).read() == want, (device, chunk_rows)


def test_edge_chunks_match_jax(tmp_path):
    prefix = str(tmp_path / "idx")
    write_graph(prefix, 30, np.random.default_rng(10), rows=120)
    got = tcluster.load_pairwise_edges(prefix, "max_cont", 35.0, chunk_rows=11)
    want = jcluster.load_pairwise_edges(prefix, "max_cont", 35.0, chunk_rows=11)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert tcluster.DISTANCE_TO_COL == jcluster.DISTANCE_TO_COL
