"""The hand-written CUDA Gram kernel vs its plain torch version, and the
port's other device paths, on the card.

Every case is marked ``gpu`` and skips without a CUDA card.  The file
imports neither jax nor kspider_tpu, so it also runs on a machine without
jax (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The plain version is held against kspider_tpu's Pallas kernels on the CPU
in tests/test_torch_cuda_pairwise.py, and the panel-streamed engine and the
torch device pack against kspider_tpu's in tests/test_torch_tiled_pairwise.py
and tests/test_torch_device_pack.py; the device index build, the fused
step and the scatter engine in tests/test_torch_{device_build,step,scatter}.py.
Here the same code runs on the card and must equal its CPU run, numpy or
scipy.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from kspider_tpu_torch import gram_bench as gb
from kspider_tpu_torch.ops import bitmask as tbm
from kspider_tpu_torch.ops import cc as tcc
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import device_build
from kspider_tpu_torch.ops import pairwise as tpw
from kspider_tpu_torch.ops import tiled_pairwise as ttp

BLOCK = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_csr(rng, n_colors, n_samples, max_degree, max_weight):
    degrees = rng.integers(1, max_degree + 1, size=n_colors)
    offsets = np.zeros(n_colors + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    members = np.concatenate([
        np.sort(rng.choice(n_samples, size=d, replace=False)) for d in degrees
    ]).astype(np.int32)
    weights = rng.integers(1, max_weight + 1, size=n_colors).astype(np.int64)
    weights[0] = max_weight
    return offsets, members, weights


def packed(seed, n_colors, n, n_pad, max_weight, block=BLOCK):
    rng = np.random.default_rng(seed)
    o, m, w = random_csr(rng, n_colors, n, 12, max_weight)
    return cp.pack_inputs(o, m, tpw.weight_limbs(w), n_pad, block)


def run(bits_i, bits_j, wl, ti, tj, npad_i, npad_j, device,
        compute_dtype=torch.int8, fn=cp.cooccurrence_tiles):
    out = torch.zeros((wl.shape[1], npad_i, npad_j), dtype=torch.int32,
                      device=device)
    bi = torch.from_numpy(bits_i).to(device)
    bj = bi if bits_j is bits_i else torch.from_numpy(bits_j).to(device)
    fn(bi, bj, torch.from_numpy(wl).to(device), ti, tj, tile=cp.TILE, out=out,
       compute_dtype=compute_dtype)
    return out.cpu().numpy()


def mode_args(mode, max_weight, block):
    """Inputs of one launch mode from packed CSR colors: 250 and 380
    samples padded to 256 and 384; "list" is every tile of the rectangle
    in a shuffled order."""
    bits_i, wl_t = packed(max_weight, 1500, 250, 256, max_weight, block)
    bits_j, _ = packed(max_weight + 1, 1500, 380, 384, max_weight, block)
    if mode == "square":
        return (bits_i, bits_i, wl_t, *cp.all_tiles(2, 2), 256, 256)
    if mode in ("rect", "list"):
        ti, tj = cp.all_tiles(2, 3)
        if mode == "list":
            order = np.random.default_rng(max_weight).permutation(len(ti))
            ti, tj = ti[order], tj[order]
        return (bits_i, bits_j, wl_t, ti, tj, 256, 384)
    return (bits_j, bits_j, wl_t, *cp.upper_triangle_tiles(3), 384, 384)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["square", "rect", "upper", "list"])
@pytest.mark.parametrize("max_weight,block", [(127, 128), (16000, 1024), (40000, 256)])
def test_kernel_matches_plain(cuda_device, mode, max_weight, block):
    """L = 1, 2, 3 (max_weight 127, 16000, 40000): one launch each."""
    args = mode_args(mode, max_weight, block)
    assert args[2].shape[1] == {127: 1, 16000: 2, 40000: 3}[max_weight]
    before = cp.LAUNCHES
    got = run(*args, device=cuda_device)
    torch.cuda.synchronize()
    assert cp.LAUNCHES == before + 1
    assert np.array_equal(got, run(*args, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", gb.MODES)
@pytest.mark.parametrize("shape", gb.RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_ragged(cuda_device, shape, mode):
    """gram_bench's ragged shapes, which chip_smoke.py checks too (L = 1-4,
    in place from a random start): one launch each."""
    rng = np.random.default_rng(sum(shape))
    bits_i, bits_j, wl = gb.ragged_inputs(shape, rng, cuda_device)
    bits_i, bits_j, ti, tj = gb.mode_tiles(mode, bits_i, bits_j, rng)
    before = cp.LAUNCHES
    assert gb.max_err(bits_i, bits_j, wl, ti, tj) == 0
    assert cp.LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["square", "rect", "upper"])
@pytest.mark.parametrize("max_weight,block", [(127, 64), (16000, 1024), (40000, 192)])
def test_bf16_kernel_matches_plain(cuda_device, mode, max_weight, block):
    args = mode_args(mode, max_weight, block)
    before = dict(cp.LAUNCHES_BY_DTYPE)
    got = run(*args, device=cuda_device, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cp.LAUNCHES_BY_DTYPE["bfloat16"] == before["bfloat16"] + 1
    assert cp.LAUNCHES_BY_DTYPE["int8"] == before["int8"]
    # the plain version on the card, on the CPU, and the int8 form's
    assert np.array_equal(got, run(*args, device=cuda_device,
                                   compute_dtype=torch.bfloat16,
                                   fn=cp.cooccurrence_tiles_plain))
    assert np.array_equal(got, run(*args, device="cpu", compute_dtype=torch.bfloat16))
    assert np.array_equal(got, run(*args, device="cpu"))


@pytest.mark.gpu
def test_bf16_shared_kmer_matrix_on_card(cuda_device):
    rng = np.random.default_rng(12)
    o, m, w = random_csr(rng, 3000, 700, 12, 40000)
    got = cp.shared_kmer_matrix_cuda(o, m, w, 700, device=cuda_device,
                                     block=BLOCK, compute_dtype=torch.bfloat16)
    assert np.array_equal(got, tpw.shared_kmer_matrix_numpy(o, m, w, 700))


@pytest.mark.gpu
def test_shared_kmer_matrix_on_card(cuda_device):
    rng = np.random.default_rng(11)
    o, m, w = random_csr(rng, 3000, 700, 12, 40000)
    got = tpw.shared_kmer_matrix(o, m, w, 700, device=cuda_device, block=BLOCK)
    assert np.array_equal(got, tpw.shared_kmer_matrix_numpy(o, m, w, 700))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    bits = torch.zeros((1, 16, 96), dtype=torch.uint8, device=cuda_device)
    wl = torch.zeros((1, 1, 96), dtype=torch.int8, device=cuda_device)
    out = torch.zeros((1, 128, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=128, out=out)
    bits = torch.zeros((1, 16, 128), dtype=torch.uint8, device=cuda_device)
    wl = torch.zeros((1, 1, 128), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="tile"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=64, out=out)
    with pytest.raises(ValueError, match="out of range"):
        cp.cooccurrence_tiles(bits, bits, wl, [1], [0], tile=128, out=out)
    with pytest.raises(ValueError, match="int32"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=128,
                              out=out.to(torch.int64))
    bits = torch.zeros((1, 16, 96), dtype=torch.uint8, device=cuda_device)
    wl = torch.zeros((1, 1, 96), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="64-color chunk"):
        cp.cooccurrence_tiles(bits, bits, wl, [0], [0], tile=128, out=out,
                              compute_dtype=torch.bfloat16)


class _Index:
    def __init__(self, offsets, members, weights, n, counts):
        self.color_offsets = offsets
        self.color_members = members
        self.color_counts = weights
        self.num_groups = n
        self.group_kmer_count = counts


@pytest.mark.gpu
@pytest.mark.parametrize("device_pack", ["force", "off"])
def test_tiled_stream_on_card_equals_cpu(cuda_device, tmp_path, device_pack):
    rng = np.random.default_rng(13)
    n = 700
    o, m, w = random_csr(rng, 3000, n, 12, 40000)
    index = _Index(o, m, w, n, rng.integers(1, 100000, size=n))
    before = dict(cp.LAUNCHES_BY_MODE)
    stats = {}
    rows = ttp.stream_pairwise_tsv(
        index, str(tmp_path / "card"), device=cuda_device, panel=256,
        block=BLOCK, device_pack=device_pack, stats=stats)
    ttp.stream_pairwise_tsv(index, str(tmp_path / "cpu"), device="cpu",
                            panel=256, block=BLOCK, device_pack=device_pack)
    assert rows > 0
    with open(str(tmp_path / "card") + "_kSpider_pairwise.tsv", "rb") as a, \
            open(str(tmp_path / "cpu") + "_kSpider_pairwise.tsv", "rb") as b:
        assert a.read() == b.read()
    assert cp.LAUNCHES_BY_MODE["upper"] > before["upper"]
    assert cp.LAUNCHES_BY_MODE["all"] > before["all"]
    assert stats["cache_misses"] > 0  # the 2 GB cache is on for a card


@pytest.mark.gpu
def test_device_pack_on_card_equals_host(cuda_device):
    rng = np.random.default_rng(17)
    n_colors, panel_pad, block = 500, 768, 128
    o, m, _ = random_csr(rng, n_colors, 700, 60, 10)
    n_blocks = -(-n_colors // block)
    host = tbm.pack_bitmask_blocks(
        np.concatenate([o, np.full(n_blocks * block - n_colors, o[-1])]),
        m, panel_pad, block).transpose(0, 2, 1)
    keys = (np.repeat(np.arange(n_colors), np.diff(o)) * panel_pad + m)
    count = len(keys)
    padded = np.concatenate([
        keys, n_blocks * block * panel_pad + np.arange(300)]).astype(np.int32)
    geometry = (n_blocks, block, panel_pad)
    got = [tbm.scatter_pack_device(padded, *geometry, device=cuda_device)]
    first, d8, exc = tbm.delta_encode_keys_u8(padded, count)
    got.append(tbm.scatter_pack_device_delta8(first, d8, exc, count, *geometry,
                                              device=cuda_device))
    enc = tbm.delta_encode_keys(padded, count)
    if enc is not None:
        got.append(tbm.scatter_pack_device_delta(enc[0], enc[1], count,
                                                 *geometry, device=cuda_device))
    for g in got:
        assert g.is_cuda and np.array_equal(g.cpu().numpy(), host)


@pytest.mark.gpu
def test_compact_multi_postings_on_card(cuda_device):
    rng = np.random.default_rng(19)
    pool = rng.integers(0, 2**64 - 1, size=3000, dtype=np.uint64, endpoint=True)
    hashes = pool[rng.integers(0, len(pool), size=200_000)]
    assert (hashes >= np.uint64(2**63)).sum() > 1000
    gids = rng.integers(0, 300, size=len(hashes)).astype(np.int32)
    stats = {}
    got_h, got_g = device_build.compact_multi_postings(
        hashes, gids, device=cuda_device, stats=stats)
    # numpy brute force: unique (hash, gid) pairs in unsigned order, kept
    # where the hash has >= 2 samples
    pairs = np.unique(np.stack([hashes, gids.astype(np.uint64)]), axis=1)
    _, inv, run = np.unique(pairs[0], return_inverse=True, return_counts=True)
    keep = run[inv] >= 2
    assert np.array_equal(got_h, pairs[0][keep])
    assert np.array_equal(got_g, pairs[1][keep].astype(np.int32))
    assert stats["postings_kept"] == int(keep.sum()) and stats["sort_ms"] > 0


@pytest.mark.gpu
def test_build_index_device_on_card_equals_host(cuda_device):
    from kspider_tpu_torch.core.index import (build_index_device,
                                              build_index_from_hash_sets)

    rng = np.random.default_rng(23)
    universe = np.unique(rng.integers(0, 2**64 - 1, size=20000, dtype=np.uint64,
                                      endpoint=True))
    arrays = [universe[rng.random(len(universe)) < 0.2] for _ in range(40)]
    arrays[7] = None
    names = [f"s{i}" for i in range(40)]
    host = build_index_from_hash_sets(names, arrays, ksize=21)
    dev = build_index_device(names, arrays, ksize=21, device=cuda_device)
    for field in ("group_kmer_count", "color_ids", "color_offsets",
                  "color_members", "color_counts"):
        assert np.array_equal(getattr(host, field), getattr(dev, field)), field


@pytest.mark.gpu
@pytest.mark.parametrize("block,cutoff", [(32, 0.01), (8, 0.02), (256, 0.3)])
def test_single_device_step_on_card(cuda_device, block, cutoff):
    from kspider_tpu_torch.parallel import step

    bits, wl, counts, block, n_pad, n_limbs = step.make_example_blocks(
        n_samples=300, n_colors=1200, block=block, seed=block)
    before = cp.LAUNCHES
    shared, labels = step.single_device_step(
        bits, wl, counts, cutoff, block, n_pad, n_limbs, device=cuda_device)
    assert cp.LAUNCHES == before + 1
    assert shared.is_cuda and labels.is_cuda
    cpu_shared, cpu_labels = step.single_device_step(
        bits, wl, counts, cutoff, block, n_pad, n_limbs, device="cpu")
    assert torch.equal(shared.cpu(), cpu_shared)
    s = shared.cpu().numpy()
    denom = np.minimum(counts[:, None], counts[None, :]).astype(np.float32)
    cont = s.astype(np.float32) / np.maximum(denom, np.float32(1.0))
    adj = (cont >= np.float32(cutoff)) & (s > 0)
    want = tcc.connected_components_scipy(*np.nonzero(adj), len(counts))
    assert np.array_equal(labels.cpu().numpy(), want)
    assert torch.equal(labels.cpu(), cpu_labels)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [512, 64])
def test_scatter_engine_on_card(cuda_device, block):
    rng = np.random.default_rng(29)
    o, m, w = random_csr(rng, 3000, 700, 12, 40000)
    got = tpw.shared_kmer_matrix(o, m, w, 700, device=cuda_device,
                                 engine="scatter", block=block)
    assert np.array_equal(got, tpw.shared_kmer_matrix_numpy(o, m, w, 700))


def two_shards():
    """Two shards on one card, or one on each of the first two cards."""
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [torch.device("cuda", 0)] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 1024])
def test_sharded_matrix_on_card_equals_single_device(cuda_device, block):
    from kspider_tpu_torch.parallel import sharded_pairwise as sp

    rng = np.random.default_rng(31)
    o, m, w = random_csr(rng, 3000, 700, 12, 40000)
    before = cp.LAUNCHES
    got = sp.shared_kmer_matrix_sharded(o, m, w, 700,
                                        devices=two_shards(),
                                        block=block)
    assert cp.LAUNCHES == before + 2  # one launch per shard
    want = tpw.shared_kmer_matrix(o, m, w, 700, device=cuda_device, block=block)
    assert np.array_equal(got, want)
    assert np.array_equal(got, tpw.shared_kmer_matrix_numpy(o, m, w, 700))


@pytest.mark.gpu
@pytest.mark.parametrize("block,cutoff", [(32, 0.01), (256, 0.3)])
def test_sharded_step_on_card_equals_single_device(cuda_device, block, cutoff):
    from kspider_tpu_torch.parallel import step

    bits, wl, counts, block, n_pad, n_limbs = step.make_example_blocks(
        n_samples=300, n_colors=2048, block=block, seed=block)
    devices = two_shards()
    before = cp.LAUNCHES
    shared, labels = step.sharded_step(devices, bits, wl, counts, cutoff, block,
                                       n_pad, n_limbs)
    assert cp.LAUNCHES == before + 2
    assert shared.device == devices[0] and labels.device == devices[0]
    one_s, one_l = step.single_device_step(bits, wl, counts, cutoff, block,
                                           n_pad, n_limbs, device=cuda_device)
    assert torch.equal(shared.cpu(), one_s.cpu())
    assert torch.equal(labels.cpu(), one_l.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("panel,pair_parallel", [(128, True), (512, False)])
def test_iter_panel_pairs_two_devices_equals_one(cuda_device, panel,
                                                 pair_parallel):
    rng = np.random.default_rng(37)
    o, m, w = random_csr(rng, 3000, 700, 12, 40000)
    plan = ttp.build_panel_plan(o, m, w, 700, panel)
    want = list(ttp.iter_panel_pairs(plan, device=cuda_device, block=BLOCK))
    stats = {}
    got = list(ttp.iter_panel_pairs(plan, device=two_shards(),
                                    block=BLOCK, stats=stats))
    assert stats["pair_parallel"] == pair_parallel
    assert [(g[0], g[1]) for g in got] == [(x[0], x[1]) for x in want]
    for x, g in zip(want, got):
        for a, b in zip(x[2:], g[2:]):
            assert np.array_equal(a, b)
