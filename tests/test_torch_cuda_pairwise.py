"""kspider_tpu_torch's dense pairwise engine vs kspider_tpu's Pallas kernels.

The same seeded inputs go through the JAX package (Pallas in interpret
mode, as its own tests run it on the CPU) and through the port (the
kernel's plain torch version on CPU tensors).  Tolerance: exact, integer
equality, on the raw per-limb int32 accumulators and on the final int64
matrices.  The CUDA kernel itself is held against its plain version on the
card in tests/test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch

from kspider_tpu.ops import bitmask as jbm
from kspider_tpu.ops import pairwise as jpw
from kspider_tpu.ops import pallas_pairwise as jpp
from kspider_tpu_torch.ops import bitmask as tbm
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as tpw
from tests.test_pairwise_ops import random_csr

BLOCK = 128
TILE = 128
# max_weight giving 1, 2 and 3 base-128 limbs
WEIGHTS_FOR_LIMBS = {1: 127, 2: 16000, 3: 40000}


def packed(seed, n_colors, n, n_pad, n_limbs, max_degree=10):
    """Seeded CSR -> (JAX-packed inputs, weight limbs)."""
    rng = np.random.default_rng(seed)
    o, m, w = random_csr(rng, n_colors, n, max_degree=max_degree,
                         max_weight=WEIGHTS_FOR_LIMBS[n_limbs])
    w[0] = WEIGHTS_FOR_LIMBS[n_limbs]  # pin the limb count
    wl = jpw.weight_limbs(w)
    assert wl.shape[1] == n_limbs
    bits_t, wl_t = jpp.pack_inputs(o, m, wl, n_pad, BLOCK)
    return bits_t, wl_t


def run_port(bits_i, bits_j, wl, ti, tj, npad_i, npad_j, device="cpu"):
    out = torch.zeros((wl.shape[1], npad_i, npad_j), dtype=torch.int32,
                      device=device)
    bi = torch.from_numpy(bits_i).to(device)
    bj = bi if bits_j is bits_i else torch.from_numpy(bits_j).to(device)
    cp.cooccurrence_tiles(bi, bj, torch.from_numpy(wl).to(device), ti, tj,
                          tile=TILE, out=out)
    return out.cpu().numpy()


# ---- re-homed host helpers ---------------------------------------------


def test_weight_limbs_matches_jax(rng):
    w = rng.integers(0, 2**40, size=1000).astype(np.int64)
    assert np.array_equal(tpw.weight_limbs(w), jpw.weight_limbs(w))
    assert np.array_equal(tpw.weight_limbs(w[:0]), jpw.weight_limbs(w[:0]))
    assert tpw._MAX_COLORS_PER_CALL == jpw._MAX_COLORS_PER_CALL


@pytest.mark.parametrize("n,block", [(9, 64), (200, 128), (256, 256)])
def test_pack_bitmask_blocks_matches_jax(n, block):
    o, m, _ = random_csr(np.random.default_rng(n), 300, n, max_degree=8)
    assert np.array_equal(tbm.pack_bitmask_blocks(o, m, n, block),
                          jbm.pack_bitmask_blocks(o, m, n, block))


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_pack_inputs_matches_jax(n_limbs):
    rng = np.random.default_rng(n_limbs)
    o, m, w = random_csr(rng, 333, 250, max_degree=9,
                         max_weight=WEIGHTS_FOR_LIMBS[n_limbs])
    wl = jpw.weight_limbs(w)
    got = cp.pack_inputs(o, m, wl, 256, BLOCK)
    want = jpp.pack_inputs(o, m, wl, 256, BLOCK)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and np.array_equal(g, x)


@pytest.mark.parametrize("nt", [1, 2, 5])
def test_upper_triangle_tiles_matches_jax(nt):
    for g, x in zip(cp.upper_triangle_tiles(nt), jpp.upper_triangle_tiles(nt)):
        assert g.dtype == x.dtype and np.array_equal(g, x)


def test_unpack_bits_matches_jax(rng):
    bits = rng.integers(0, 256, size=(3, 5, 16), dtype=np.uint8)
    got = tbm.unpack_bits_to_int8(torch.from_numpy(bits)).numpy()
    want = np.asarray(jbm.unpack_bits_to_int8(jax.numpy.asarray(bits)))
    assert got.dtype == np.int8 and np.array_equal(got, want)


@pytest.mark.parametrize("n_limbs", [1, 3])
def test_cooccurrence_bitmask_blocks_matches_jax(n_limbs):
    rng = np.random.default_rng(10 + n_limbs)
    o, m, w = random_csr(rng, 250, 120, max_weight=WEIGHTS_FOR_LIMBS[n_limbs])
    w[0] = WEIGHTS_FOR_LIMBS[n_limbs]
    bits = jbm.pack_bitmask_blocks(o, m, 120, BLOCK)
    wl = np.zeros((bits.shape[0] * BLOCK, n_limbs), dtype=np.int8)
    wl[: len(w)] = jpw.weight_limbs(w)
    wl = wl.reshape(bits.shape[0], BLOCK, n_limbs)
    want = np.asarray(jbm.cooccurrence_bitmask_blocks(bits, wl, BLOCK, 128, n_limbs))
    got = tbm.cooccurrence_bitmask_blocks(
        torch.from_numpy(bits), torch.from_numpy(wl), n_limbs).numpy()
    assert np.array_equal(got, want)


# ---- kernel launch modes vs the four Pallas kernels ----------------------


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_all_tiles_square_matches_pallas(n_limbs):
    bits_t, wl_t = packed(20 + n_limbs, 300, 250, 256, n_limbs)
    want = np.asarray(jpp.cooccurrence_pallas(
        bits_t, wl_t, BLOCK, 256, n_limbs, tile=TILE, interpret=True))
    got = run_port(bits_t, bits_t, wl_t, *cp.all_tiles(2, 2), 256, 256)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_limbs", [1, 2])
def test_all_tiles_rect_matches_pallas_rect(n_limbs):
    bits_i, wl_t = packed(30 + n_limbs, 260, 200, 256, n_limbs)
    bits_j, _ = packed(40 + n_limbs, 260, 320, 384, n_limbs)
    want = np.asarray(jpp.cooccurrence_pallas_rect(
        bits_i, bits_j, wl_t, BLOCK, 256, 384, n_limbs, tile=TILE,
        interpret=True))
    got = run_port(bits_i, bits_j, wl_t, *cp.all_tiles(2, 3), 256, 384)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_limbs", [2, 3])
def test_upper_tiles_match_pallas_tri(n_limbs):
    bits_t, wl_t = packed(50 + n_limbs, 300, 300, 384, n_limbs)
    ti, tj = cp.upper_triangle_tiles(3)
    want = np.asarray(jpp.cooccurrence_pallas_tri(
        bits_t, wl_t, ti, tj, BLOCK, 384, n_limbs, tile=TILE, interpret=True))
    got = run_port(bits_t, bits_t, wl_t, ti, tj, 384, 384)
    # the triangle kernel leaves lower tiles unwritten: compare upper only
    for i, j in zip(ti, tj):
        sl = (slice(None), slice(i * TILE, (i + 1) * TILE),
              slice(j * TILE, (j + 1) * TILE))
        assert np.array_equal(got[sl], want[sl]), (i, j)


@pytest.mark.parametrize("n_limbs", [1, 3])
def test_upper_tiles_mirrored_match_pallas_sym(n_limbs):
    bits_t, wl_t = packed(60 + n_limbs, 300, 310, 384, n_limbs)
    strip = jpp.best_strip(384)
    assert strip == TILE
    sym = np.asarray(jpp.cooccurrence_pallas_sym(
        bits_t, wl_t, BLOCK, 384, n_limbs, strip=strip, interpret=True))
    want = np.stack([jpp.mirror_upper_tiles(s.copy(), strip) for s in sym])
    got = run_port(bits_t, bits_t, wl_t, *cp.upper_triangle_tiles(3), 384, 384)
    got = cp.mirror_upper_tiles(torch.from_numpy(got), TILE).numpy()
    assert np.array_equal(got, want)


def test_mirror_upper_tiles_matches_jax(rng):
    s = rng.integers(0, 1000, size=(384, 384)).astype(np.int64)
    want = jpp.mirror_upper_tiles(s.copy(), 128)
    got = cp.mirror_upper_tiles(torch.from_numpy(s), 128).numpy()
    assert np.array_equal(got, want)


# ---- the whole dense engine ----------------------------------------------


@pytest.mark.parametrize(
    "n_colors,n,max_degree,max_weight",
    [
        (500, 150, 10, 40000),  # n not a multiple of 128, 3 limbs
        (500, 300, 8, 300),     # several tiles, 2 limbs
        (10, 0, 1, 5),          # no samples
        (40, 30, 1, 900),       # every color a singleton
    ],
)
def test_shared_kmer_matrix_matches_jax(n_colors, n, max_degree, max_weight):
    rng = np.random.default_rng(n_colors + n)
    if n == 0:
        o, m, w = np.zeros(1, np.int64), np.empty(0, np.int32), np.empty(0, np.int64)
    else:
        o, m, w = random_csr(rng, n_colors, n, max_degree=max_degree,
                             max_weight=max_weight)
    got = tpw.shared_kmer_matrix(o, m, w, n, device="cpu", block=BLOCK)
    assert got.dtype == np.int64 and got.shape == (n, n)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, n))
    assert np.array_equal(got, jpp.shared_kmer_matrix_pallas(o, m, w, n, block=BLOCK))


def test_shared_kmer_matrix_super_block_split(monkeypatch):
    rng = np.random.default_rng(7)
    o, m, w = random_csr(rng, 700, 200, max_degree=10, max_weight=40000)
    want = jpp.shared_kmer_matrix_pallas(o, m, w, 200, block=BLOCK)
    # 300 colors per call -> super-blocks of 256 colors: three of them
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 300)
    monkeypatch.setattr(cp, "CHUNK_BLOCKS", 1)
    got = tpw.shared_kmer_matrix(o, m, w, 200, device="cpu", block=BLOCK)
    assert np.array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    bits_t, wl_t = packed(3, 200, 100, 128, 2)
    before = cp.LAUNCHES
    got = run_port(bits_t, bits_t, wl_t, *cp.all_tiles(1, 1), 128, 128)
    assert cp.LAUNCHES == before
    want = np.asarray(jpp.cooccurrence_pallas(
        bits_t, wl_t, BLOCK, 128, 2, tile=TILE, interpret=True))
    assert np.array_equal(got, want)


def test_other_devices_raise():
    meta = torch.empty((1, 16, BLOCK), dtype=torch.uint8, device="meta")
    out = torch.empty((1, 128, 128), dtype=torch.int32, device="meta")
    wl = torch.empty((1, 1, BLOCK), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cp.cooccurrence_tiles(meta, meta, wl, [0], [0], tile=TILE, out=out)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpw.shared_kmer_matrix(np.array([0, 2]), np.array([0, 1], np.int32),
                               np.array([3]), 2, device="cuda")


# ---- the bf16 form vs the Pallas kernels' compute_dtype=bfloat16 --------


def run_port_bf16(bits_i, bits_j, wl, ti, tj, npad_i, npad_j):
    out = torch.zeros((wl.shape[1], npad_i, npad_j), dtype=torch.int32)
    bi = torch.from_numpy(bits_i)
    bj = bi if bits_j is bits_i else torch.from_numpy(bits_j)
    cp.cooccurrence_tiles(bi, bj, torch.from_numpy(wl), ti, tj, tile=TILE,
                          out=out, compute_dtype=torch.bfloat16)
    return out.numpy()


@pytest.mark.parametrize("n_limbs", [1, 3])
def test_bf16_all_tiles_square_matches_pallas(n_limbs):
    bits_t, wl_t = packed(70 + n_limbs, 300, 250, 256, n_limbs)
    want = np.asarray(jpp.cooccurrence_pallas(
        bits_t, wl_t, BLOCK, 256, n_limbs, tile=TILE,
        compute_dtype=jax.numpy.bfloat16, interpret=True))
    got = run_port_bf16(bits_t, bits_t, wl_t, *cp.all_tiles(2, 2), 256, 256)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_limbs", [1, 2])
def test_bf16_all_tiles_rect_matches_pallas_rect(n_limbs):
    bits_i, wl_t = packed(80 + n_limbs, 260, 200, 256, n_limbs)
    bits_j, _ = packed(90 + n_limbs, 260, 320, 384, n_limbs)
    want = np.asarray(jpp.cooccurrence_pallas_rect(
        bits_i, bits_j, wl_t, BLOCK, 256, 384, n_limbs, tile=TILE,
        compute_dtype=jax.numpy.bfloat16, interpret=True))
    got = run_port_bf16(bits_i, bits_j, wl_t, *cp.all_tiles(2, 3), 256, 384)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_limbs", [2, 3])
def test_bf16_upper_tiles_match_pallas_tri(n_limbs):
    bits_t, wl_t = packed(100 + n_limbs, 300, 300, 384, n_limbs)
    ti, tj = cp.upper_triangle_tiles(3)
    want = np.asarray(jpp.cooccurrence_pallas_tri(
        bits_t, wl_t, ti, tj, BLOCK, 384, n_limbs, tile=TILE,
        compute_dtype=jax.numpy.bfloat16, interpret=True))
    got = run_port_bf16(bits_t, bits_t, wl_t, ti, tj, 384, 384)
    for i, j in zip(ti, tj):
        sl = (slice(None), slice(i * TILE, (i + 1) * TILE),
              slice(j * TILE, (j + 1) * TILE))
        assert np.array_equal(got[sl], want[sl]), (i, j)


def test_bf16_upper_tiles_mirrored_match_pallas_sym():
    bits_t, wl_t = packed(110, 300, 310, 384, 2)
    sym = np.asarray(jpp.cooccurrence_pallas_sym(
        bits_t, wl_t, BLOCK, 384, 2, strip=TILE,
        compute_dtype=jax.numpy.bfloat16, interpret=True))
    want = np.stack([jpp.mirror_upper_tiles(s.copy(), TILE) for s in sym])
    got = run_port_bf16(bits_t, bits_t, wl_t, *cp.upper_triangle_tiles(3), 384, 384)
    got = cp.mirror_upper_tiles(torch.from_numpy(got), TILE).numpy()
    assert np.array_equal(got, want)


def test_bf16_equals_int8_form():
    bits_t, wl_t = packed(120, 400, 300, 384, 3, max_degree=12)
    tiles = cp.all_tiles(3, 3)
    want = run_port(bits_t, bits_t, wl_t, *tiles, 384, 384)
    assert np.array_equal(run_port_bf16(bits_t, bits_t, wl_t, *tiles, 384, 384), want)


def test_bf16_shared_kmer_matrix_matches_pallas():
    # the shape of tests/test_bitmask_pallas.py::test_pallas_engine_matches_numpy
    rng = np.random.default_rng(130)
    o, m, w = random_csr(rng, 600, 150, max_degree=10, max_weight=40000)
    want = jpp.shared_kmer_matrix_pallas(o, m, w, 150, block=128, tile=128,
                                         compute_dtype=jax.numpy.bfloat16)
    got = cp.shared_kmer_matrix_cuda(o, m, w, 150, device="cpu", block=128,
                                     compute_dtype=torch.bfloat16)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, 150))


def test_bf16_sums_past_two_to_the_24_match_pallas():
    """128 samples, every bit set, limb 127, 2 blocks of 67,072 colors: the
    tile's sum, 17,036,288, passes 2**24 (each block's stays below).  The
    bf16 plain version equals the bf16 Pallas kernel and the int8 form."""
    block = 67072
    bits_t = np.full((2, 16, block), 255, dtype=np.uint8)
    wl_t = np.full((2, 1, block), 127, dtype=np.int8)
    want = np.asarray(jpp.cooccurrence_pallas(
        bits_t, wl_t, block, 128, 1, tile=TILE,
        compute_dtype=jax.numpy.bfloat16, interpret=True))
    assert (want == 127 * 2 * block).all() and 127 * 2 * block > 2**24
    ti, tj = cp.all_tiles(1, 1)
    assert np.array_equal(run_port_bf16(bits_t, bits_t, wl_t, ti, tj, 128, 128),
                          want)
    assert np.array_equal(run_port(bits_t, bits_t, wl_t, ti, tj, 128, 128), want)


def test_bf16_segment_keeps_float32_sums_exact():
    """The bf16 kernel's flush segment: its largest partial sum stays an
    exact float32 integer, one chunk more would not."""
    seg_colors = cp.BF16_SEGMENT_CHUNKS * cp.BF16_CHUNK
    assert 127 * seg_colors <= 2**24 < 127 * (seg_colors + cp.BF16_CHUNK)
    assert cp.BF16_SEGMENT_CHUNKS == 2064


def test_bf16_refuses_blocks_past_float32_exactness():
    assert cp.MAX_BF16_BLOCK * 127 < 2**24 <= (cp.MAX_BF16_BLOCK + 1) * 127
    block = cp.MAX_BF16_BLOCK + 1
    bits = torch.zeros((1, 16, block), dtype=torch.uint8)
    wl = torch.zeros((1, 1, block), dtype=torch.int8)
    out = torch.zeros((1, 128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="exact"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=TILE, out=out,
                              compute_dtype=torch.bfloat16)
    cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=TILE, out=out)
    with pytest.raises(ValueError, match="neither"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=TILE, out=out,
                              compute_dtype=torch.float16)
