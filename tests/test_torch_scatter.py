"""kspider_tpu_torch's scatter engine vs kspider_tpu's.

The same seeded CSR goes through kspider_tpu's ``_pack_blocks`` and jitted
``_cooccurrence_blocks`` (XLA on the CPU) and through the port's numpy
``_pack_blocks`` and torch ``_cooccurrence_blocks`` on the CPU (float64
products).  Tolerance: exact equality of the packed arrays, the raw
per-limb int32 accumulators and the final int64 matrices.  The engine on
the card (``torch._int_mm``) is held against numpy in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from kspider_tpu.ops import pairwise as jpw
from kspider_tpu_torch.ops import pairwise as tpw
from tests.test_pairwise_ops import random_csr

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_colors,n,block,max_weight", [
    (700, 150, 64, 40000),   # 3 limbs, ragged last block
    (700, 150, 512, 300),    # one block, 2 limbs
    (131, 12, 64, 127),      # 1 limb
])
def test_pack_blocks_matches_jax(n_colors, n, block, max_weight):
    rng = np.random.default_rng(n_colors + block)
    o, m, w = random_csr(rng, n_colors, n, max_degree=10, max_weight=max_weight)
    wl = jpw.weight_limbs(w)
    for g, x in zip(tpw._pack_blocks(o, m, wl, block),
                    jpw._pack_blocks(o, m, wl, block)):
        assert g.dtype == x.dtype and np.array_equal(g, x)


@pytest.mark.parametrize("n_colors,n,n_pad,block,max_weight", [
    (700, 150, 256, 64, 40000),
    (400, 300, 384, 128, 16000),
    (50, 20, 128, 512, 127),
])
def test_cooccurrence_blocks_matches_jax(n_colors, n, n_pad, block, max_weight):
    rng = np.random.default_rng(n_colors + n)
    o, m, w = random_csr(rng, n_colors, n, max_degree=10, max_weight=max_weight)
    wl = jpw.weight_limbs(w)
    n_limbs = wl.shape[1]
    rows, cols, wlb = jpw._pack_blocks(o, m, wl, block)
    want = np.asarray(jpw._cooccurrence_blocks(rows, cols, wlb, block, n_pad,
                                               n_limbs))
    got = tpw._cooccurrence_blocks(rows, cols, wlb, block, n_pad, n_limbs,
                                   device=CPU)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_colors,n,max_degree,max_weight,drop", [
    (500, 150, 10, 40000, True),
    (500, 300, 8, 300, True),
    (300, 60, 6, 1000, False),
    (40, 30, 1, 900, True),    # every color a singleton
    (10, 0, 1, 5, True),       # no samples
])
def test_scatter_engine_matches_jax(n_colors, n, max_degree, max_weight, drop):
    rng = np.random.default_rng(n_colors + n)
    if n == 0:
        o, m, w = np.zeros(1, np.int64), np.empty(0, np.int32), np.empty(0, np.int64)
    else:
        o, m, w = random_csr(rng, n_colors, n, max_degree=max_degree,
                             max_weight=max_weight)
    want = jpw.shared_kmer_matrix(o, m, w, n, block=512, engine="scatter",
                                  drop_singletons=drop)
    got = tpw.shared_kmer_matrix(o, m, w, n, device="cpu", engine="scatter",
                                 drop_singletons=drop)
    assert got.dtype == np.int64 and got.shape == (n, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, n))


def test_scatter_engine_super_block_split(monkeypatch):
    rng = np.random.default_rng(7)
    o, m, w = random_csr(rng, 700, 200, max_degree=10, max_weight=40000)
    want = jpw.shared_kmer_matrix_numpy(o, m, w, 200)
    # 300 colors per call -> super-blocks of 256 colors: three of them
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 300)
    got = tpw.shared_kmer_matrix(o, m, w, 200, device="cpu", engine="scatter",
                                 block=64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("engine", tpw.ENGINES)
def test_every_engine_name_matches_numpy(engine):
    rng = np.random.default_rng(11)
    o, m, w = random_csr(rng, 300, 60, max_degree=6, max_weight=1000)
    got = tpw.shared_kmer_matrix(o, m, w, 60, device="cpu", engine=engine)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, 60))


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        tpw.shared_kmer_matrix(np.array([0, 2]), np.array([0, 1], np.int32),
                               np.array([3]), 2, device="cpu", engine="nope")


def test_scatter_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpw.shared_kmer_matrix(np.array([0, 2]), np.array([0, 1], np.int32),
                               np.array([3]), 2, device="cuda", engine="scatter")
