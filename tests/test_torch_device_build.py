"""kspider_tpu_torch's device index build vs kspider_tpu's.

The same seeded hashes go through kspider_tpu's ``compact_multi_postings``
and ``build_index_device`` (jax on the CPU), its host lexsort build, and
the port's torch versions on CPU tensors.  Tolerance: exact equality of
every array and every artifact byte.  The port on the card is held against
a numpy brute force in tests/test_torch_gpu.py.
"""

import dataclasses
import filecmp
import os
from collections import defaultdict

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from kspider_tpu.cli.main import cli as jax_cli
from kspider_tpu.core.index import build_index_device as jax_build_device
from kspider_tpu.core.index import build_index_from_hash_sets
from kspider_tpu.io import phmap as phmap_io
from kspider_tpu.ops.device_build import compact_multi_postings as jax_compact
from kspider_tpu_torch.cli.main import cli
from kspider_tpu_torch.core import dataset
from kspider_tpu_torch.core.index import build_index_device
from kspider_tpu_torch.ops.device_build import compact_multi_postings

ARTIFACTS = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
             "_color_count.bin", ".namesMap", ".extra")


def full_range_hashes(rng, size, distinct):
    """``size`` hashes drawn from ``distinct`` values over the whole u64
    range, about half of them >= 2**63."""
    pool = rng.integers(0, 2**64 - 1, size=distinct, dtype=np.uint64, endpoint=True)
    return pool[rng.integers(0, distinct, size=size)]


def brute_force(hashes, gids):
    d = defaultdict(set)
    for h, g in zip(hashes.tolist(), gids.tolist()):
        d[h].add(g)
    return sorted((h, g) for h, gs in d.items() if len(gs) >= 2 for g in gs)


@pytest.mark.parametrize("size,distinct,n_gids", [
    (3000, 400, 20),    # many duplicates and shared runs
    (5000, 4500, 50),   # mostly singleton runs
    (1, 1, 1),
    (0, 1, 1),
])
def test_compact_matches_jax(size, distinct, n_gids):
    rng = np.random.default_rng(size + distinct)
    hashes = full_range_hashes(rng, size, distinct)
    gids = rng.integers(0, n_gids, size=size).astype(np.int32)
    want = jax_compact(hashes, gids)
    stats = {}
    got = compact_multi_postings(hashes, gids, device="cpu", stats=stats)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert list(zip(got[0].tolist(), got[1].tolist())) == brute_force(hashes, gids)
    assert stats == {"postings_in": size, "postings_kept": len(got[0]),
                     "h2d_bytes": 12 * size}


def test_compact_orders_hashes_unsigned():
    """Hashes at the top of the u64 range sort after the rest, and gids
    ascend inside a run whatever order they came in."""
    top = np.uint64(2**64 - 1)
    hashes = np.array([top, 5, top, 2**63, 5, 2**63, 2**63 - 1, 2**63 - 1],
                      dtype=np.uint64)
    gids = np.array([9, 4, 1, 7, 0, 3, 2, 2], dtype=np.int32)
    got_h, got_g = compact_multi_postings(hashes, gids, device="cpu")
    assert got_h.tolist() == [5, 5, 2**63, 2**63, 2**64 - 1, 2**64 - 1]
    assert got_g.tolist() == [0, 4, 3, 7, 1, 9]


def collection(rng, n, with_ghost):
    universe = np.unique(full_range_hashes(rng, 6000, 6000))
    arrays = [universe[rng.random(len(universe)) < 0.25] for _ in range(n)]
    if with_ghost:
        arrays[n // 2] = None
    return [f"s{i}" for i in range(n)], arrays


def assert_same_index(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("n,with_ghost", [(16, False), (9, True)])
def test_build_index_device_matches_jax_and_host(n, with_ghost):
    names, arrays = collection(np.random.default_rng(n), n, with_ghost)
    kmer_counts = [None if a is None else len(a) + 3 for a in arrays]
    got = build_index_device(names, arrays, kmer_counts, ksize=21,
                             params="kSize:21", device="cpu")
    assert_same_index(got, jax_build_device(names, arrays, kmer_counts,
                                            ksize=21, params="kSize:21"))
    assert_same_index(got, build_index_from_hash_sets(
        names, arrays, kmer_counts, ksize=21, params="kSize:21"))


def test_build_index_device_small_ghost():
    a = np.array([1, 2, 3], dtype=np.uint64)
    b = np.array([3, 4, 2**64 - 1], dtype=np.uint64)
    names, arrays = ["a", "b", "ghost"], [a, b, None]
    got = build_index_device(names, arrays, device="cpu")
    assert_same_index(got, jax_build_device(names, arrays))
    assert_same_index(got, build_index_from_hash_sets(names, arrays))


def test_build_index_device_without_hashes():
    names, arrays = ["a", "b"], [None, np.empty(0, dtype=np.uint64)]
    got = build_index_device(names, arrays, device="cpu")
    assert_same_index(got, jax_build_device(names, arrays))


def test_dataset_builders_take_a_device(sig_collection, tmp_path):
    sigs_dir, _, ksize = sig_collection
    host = dataset.index_sigs_dir(sigs_dir, ksize, write_artifacts=False)
    dev = dataset.index_sigs_dir(sigs_dir, ksize, str(tmp_path / "d"),
                                 device=torch.device("cpu"))
    assert_same_index(host, dev)
    assert os.path.exists(str(tmp_path / "d.namesMap"))


def invoke(group, *args):
    return CliRunner().invoke(group, list(args), catch_exceptions=False)


@pytest.fixture(scope="module")
def bins_dir(tmp_path_factory):
    """A .bin collection (phmap hash-set dumps) with shared and private
    hashes over the whole u64 range."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("bins")
    universe = np.unique(full_range_hashes(rng, 20000, 20000))
    for i in range(10):
        core = universe[(i % 2) * 5000:(i % 2) * 5000 + 5000]
        own = universe[10000 + 800 * i:10800 + 800 * i]
        hashes = np.concatenate([core[rng.random(5000) < 0.6], own])
        phmap_io.write_hash_set(str(d / f"b{i:02d}.bin"), hashes)
    return str(d)


@pytest.mark.parametrize("kind", ["sig", "bin"])
def test_index_cli_device_build_matches_jax(sig_collection, bins_dir, kind,
                                            tmp_path):
    sigs_dir, _, ksize = sig_collection
    source = ["--sourmash", "--dir", sigs_dir] if kind == "sig" else \
        ["--bins", "--dir", bins_dir]
    common = ["index", *source, "-k", str(ksize)]
    runs = {
        "port": (cli, ["--device-build", "--device", "cpu"]),
        "jax_host": (jax_cli, []),
        "jax_device": (jax_cli, ["--device-build"]),
    }
    for name, (group, flags) in runs.items():
        result = invoke(group, *common, "-o", str(tmp_path / name), *flags)
        assert result.exit_code == 0, result.output
    for suffix in ARTIFACTS:
        port = str(tmp_path / "port") + suffix
        for ref in ("jax_host", "jax_device"):
            assert filecmp.cmp(port, str(tmp_path / ref) + suffix,
                               shallow=False), (ref, suffix)


def test_index_cli_host_build_matches_jax(bins_dir, tmp_path):
    for name, group in (("port", cli), ("jax", jax_cli)):
        result = invoke(group, "index", "--dir", bins_dir, "-k", "21", "-o",
                        str(tmp_path / name))
        assert result.exit_code == 0, result.output
    for suffix in ARTIFACTS:
        assert filecmp.cmp(str(tmp_path / "port") + suffix,
                           str(tmp_path / "jax") + suffix, shallow=False), suffix


def test_index_cli_device_build_without_card_fails(bins_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    result = invoke(cli, "index", "--bins", "--dir", bins_dir, "-k", "21",
                    "-o", str(tmp_path / "x"), "--device-build")
    assert result.exit_code != 0
    assert "torch.cuda.is_available() is False" in result.output
    assert not os.path.exists(str(tmp_path / "x.namesMap"))
