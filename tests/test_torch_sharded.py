"""kspider_tpu_torch's multi-device engine vs kspider_tpu's sharded engine.

The same seeded CSRs go through kspider_tpu on its virtual 8-device CPU mesh
(``tests/conftest.py``) and through the port on a list of CPU devices,
where every shard takes the Gram kernel's plain version.  Tolerance
everywhere: exact.  The raw summed int32 per-limb accumulators of
``sharded_cooccurrence`` are compared, then the int64 matrices of
``shared_kmer_matrix_sharded``, the engine dispatch of
``ops/pairwise.shared_kmer_matrix`` and the pairwise TSV bytes.
"""

import filecmp

import numpy as np
import pytest
import torch

from kspider_tpu.core import pairwise as jcore_pairwise
from kspider_tpu.ops import pairwise as jpw
from kspider_tpu.parallel import mesh as jmesh
from kspider_tpu.parallel import sharded_pairwise as jsp
from kspider_tpu_torch.core import pairwise as tcore_pairwise
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as tpw
from kspider_tpu_torch.parallel import mesh as tmesh
from kspider_tpu_torch.parallel import sharded_pairwise as tsp
from tests.test_pairwise_ops import random_csr


def csr(seed, n_colors, n, **kw):
    return random_csr(np.random.default_rng(seed), n_colors, n, **kw)


# ---- device lists ------------------------------------------------------------


@pytest.mark.parametrize("spec,want", [
    ("cpu", ["cpu"]),
    ("cpu,cpu", ["cpu", "cpu"]),
    (" cpu , cpu,cpu ", ["cpu"] * 3),
    (["cpu"] * 8, ["cpu"] * 8),
    (torch.device("cpu"), ["cpu"]),
    ([torch.device("cpu"), "cpu"], ["cpu", "cpu"]),
])
def test_make_mesh_parses_device_lists(spec, want):
    got = tmesh.make_mesh(spec)
    assert got == [torch.device(d) for d in want]


@pytest.mark.parametrize("spec", ["", ",", []])
def test_make_mesh_refuses_an_empty_list(spec):
    with pytest.raises(ValueError, match="empty"):
        tmesh.make_mesh(spec)


def test_make_mesh_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tmesh.make_mesh("cpu,cuda:0")


# ---- raw accumulators --------------------------------------------------------


def packed_blocks(seed, n_colors, n, block, n_dev, max_weight):
    """JAX's packing of ``shared_kmer_matrix_sharded``: compacted colors,
    limbs, block count padded to a multiple of the device count."""
    o, m, w = csr(seed, n_colors, n, max_weight=max_weight)
    new_o, new_m, new_w = jsp._compact_multi_colors(
        np.asarray(o, np.int64), np.asarray(m, np.int32),
        np.asarray(w, np.int64))
    from kspider_tpu.ops import bitmask as jbm

    w_limbs = jpw.weight_limbs(new_w)
    bits = jbm.pack_bitmask_blocks(new_o, new_m, n, block)
    nb = bits.shape[0]
    nb_pad = -(-nb // n_dev) * n_dev
    bits = np.concatenate(
        [bits, np.zeros((nb_pad - nb,) + bits.shape[1:], np.uint8)])
    wl = np.zeros((nb_pad * block, w_limbs.shape[1]), np.int8)
    wl[: len(new_w)] = w_limbs
    return bits, wl.reshape(nb_pad, block, -1), bits.shape[2] * 8


@pytest.mark.parametrize("engine", ["xla", "pallas-interpret"])
def test_sharded_cooccurrence_accumulators_match_jax(engine):
    bits, wl, n_pad = packed_blocks(3, 500, 150, 128, 4, 40000)
    n_limbs = wl.shape[2]
    assert n_limbs == 3 and bits.shape[0] % 4 == 0
    want = np.asarray(jsp.sharded_cooccurrence(
        bits, wl, 128, n_pad, n_limbs, jmesh.make_mesh(4), engine))
    got = tsp.sharded_cooccurrence(bits, wl, 128, n_pad, n_limbs, ["cpu"] * 4)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.any()


def test_sharded_cooccurrence_runs_every_shard_on_its_slice(monkeypatch):
    bits, wl, n_pad = packed_blocks(5, 700, 200, 32, 4, 500)
    calls = []
    real = cp.cooccurrence_tiles

    def spy(bits_i, bits_j, wl_t, ti, tj, *, tile, out, **kw):
        calls.append((bits_i.shape[0], bits_j is bits_i, len(ti)))
        return real(bits_i, bits_j, wl_t, ti, tj, tile=tile, out=out, **kw)

    monkeypatch.setattr(cp, "cooccurrence_tiles", spy)
    tsp.sharded_cooccurrence(bits, wl, 32, n_pad, wl.shape[2], "cpu,cpu,cpu,cpu")
    nt = n_pad // cp.TILE
    # four launches of the upper tiles, each over a quarter of the blocks
    # padded from 32 to the kernel's 128-color chunk
    assert calls == [(bits.shape[0] // 4, True, nt * (nt + 1) // 2)] * 4


def test_sharded_cooccurrence_refuses_what_it_cannot_split():
    bits, wl, n_pad = packed_blocks(5, 300, 100, 32, 1, 500)
    nb, n_limbs = bits.shape[0], wl.shape[2]
    with pytest.raises(ValueError, match="split evenly"):
        tsp.sharded_cooccurrence(bits, wl, 32, n_pad, n_limbs, ["cpu"] * (nb + 1))
    with pytest.raises(ValueError, match="w_limbs"):
        tsp.sharded_cooccurrence(bits, wl[:, :, :1], 32, n_pad, 2, ["cpu"])
    with pytest.raises(ValueError, match="bits"):
        tsp.sharded_cooccurrence(bits, wl, 64, n_pad, n_limbs, ["cpu"])


# ---- the int64 matrix --------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 8])
def test_shared_kmer_matrix_sharded_matches_jax(n_dev):
    o, m, w = csr(n_dev, 400, 33, max_weight=5000)
    want = jsp.shared_kmer_matrix_sharded(o, m, w, 33,
                                          mesh=jmesh.make_mesh(n_dev), block=64)
    got = tsp.shared_kmer_matrix_sharded(o, m, w, 33, devices=["cpu"] * n_dev,
                                         block=64)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, 33))


def test_sharded_fewer_blocks_than_devices_matches_jax():
    o, m, w = csr(11, 10, 5, max_degree=3, max_weight=3)
    want = jsp.shared_kmer_matrix_sharded(o, m, w, 5, mesh=jmesh.make_mesh(8),
                                          block=4)
    got = tsp.shared_kmer_matrix_sharded(o, m, w, 5, devices=["cpu"] * 8, block=4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_super_blocks_match_jax(monkeypatch, n_dev):
    """With a small int32 bound the colors span several super-blocks, each
    recombined into the int64 total; kspider_tpu's single call is exact at
    this size, so the two must agree."""
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 200)
    o, m, w = csr(13, 900, 120, max_weight=40000)
    kept = int((np.diff(o) >= 2).sum())
    assert kept > 3 * 200
    calls = []
    real = tsp.sharded_cooccurrence
    monkeypatch.setattr(tsp, "sharded_cooccurrence",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    got = tsp.shared_kmer_matrix_sharded(o, m, w, 120, devices=["cpu"] * n_dev,
                                         block=16)
    want = jsp.shared_kmer_matrix_sharded(o, m, w, 120,
                                          mesh=jmesh.make_mesh(n_dev), block=16)
    assert np.array_equal(got, want)
    # 200 // 16 = 12 blocks per call, cut to a multiple of the device count
    per_call = 12 // n_dev * n_dev
    assert len(calls) == -(-kept // (per_call * 16))
    assert all(nb <= per_call for nb in calls)


def test_sharded_refuses_blocks_beyond_the_int32_bound(monkeypatch):
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 100)
    o, m, w = csr(1, 50, 20, max_weight=10)
    with pytest.raises(ValueError, match="exactly"):
        tsp.shared_kmer_matrix_sharded(o, m, w, 20, devices=["cpu"] * 4,
                                       block=32)


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_compact_multi_colors_matches_jax(seed):
    o, m, w = csr(seed, 300, 40, max_degree=4, max_weight=900)
    args = (np.asarray(o, np.int64), np.asarray(m, np.int32),
            np.asarray(w, np.int64))
    for a, b in zip(jsp._compact_multi_colors(*args),
                    tsp._compact_multi_colors(*args)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    single = np.arange(4, dtype=np.int64)
    assert tsp._compact_multi_colors(single, np.arange(3, dtype=np.int32),
                                     np.ones(3, np.int64)) is None


# ---- engine dispatch -----------------------------------------------------------


@pytest.mark.parametrize("device,engine,sharded", [
    ("cpu,cpu", "auto", True),
    (["cpu"] * 3, "sharded", True),
    ("cpu", "sharded", True),
    ("cpu", "auto", False),
    (["cpu"], "auto", False),
])
def test_shared_kmer_matrix_engine_rule(monkeypatch, device, engine, sharded):
    """A list of more than one device takes the sharded engine under
    "auto", as kspider_tpu does on more than one chip."""
    o, m, w = csr(17, 300, 90, max_weight=3000)
    taken = []
    real = tsp.shared_kmer_matrix_sharded
    monkeypatch.setattr(tsp, "shared_kmer_matrix_sharded",
                        lambda *a, **k: taken.append(k["devices"]) or real(*a, **k))
    got = tpw.shared_kmer_matrix(o, m, w, 90, device=device, engine=engine)
    assert np.array_equal(got, jpw.shared_kmer_matrix(o, m, w, 90,
                                                      engine="sharded"))
    assert bool(taken) == sharded


@pytest.mark.parametrize("engine", ["bitmask", "pallas", "scatter"])
def test_one_device_engines_refuse_a_device_list(engine):
    o, m, w = csr(19, 50, 20, max_weight=30)
    with pytest.raises(ValueError, match="runs on one device, got 2"):
        tpw.shared_kmer_matrix(o, m, w, 20, device=["cpu", "cpu"], engine=engine)


def test_run_pairwise_on_a_device_list_matches_jax(sig_collection, tmp_path):
    from kspider_tpu.core import dataset

    sigs_dir, _, ksize = sig_collection
    index = dataset.index_sigs_dir(sigs_dir, ksize,
                                   output_prefix=str(tmp_path / "idx"))
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jcore_pairwise.run_pairwise(jax_prefix, index, echo_timers=False)
    got = tcore_pairwise.run_pairwise(port_prefix, index, device="cpu,cpu,cpu",
                                      echo_timers=False)
    assert np.array_equal(got, want)
    for suffix in ("_kSpider_pairwise.tsv", "_kSpider_seqToKmersNo.tsv"):
        assert filecmp.cmp(port_prefix + suffix, jax_prefix + suffix,
                           shallow=False), suffix
