"""The hand-written CUDA Gram kernel vs its plain torch version, on the card.

Every case is marked ``gpu`` and skips without a CUDA card.  The file
imports neither jax nor kspider_tpu's jax modules, so it also runs on a
machine without jax (``tests/conftest.py`` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The plain version is held against kspider_tpu's Pallas kernels on the CPU
in tests/test_torch_cuda_pairwise.py, and the panel-streamed engine and the
torch device pack against kspider_tpu's in tests/test_torch_tiled_pairwise.py
and tests/test_torch_device_pack.py.  Here the same code runs on the card
and must equal its CPU run.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from kspider_tpu_torch.ops import bitmask as tbm
from kspider_tpu_torch.ops import cuda_pairwise as cp
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


def run(bits_i, bits_j, wl, ti, tj, npad_i, npad_j, device):
    out = torch.zeros((wl.shape[1], npad_i, npad_j), dtype=torch.int32,
                      device=device)
    bi = torch.from_numpy(bits_i).to(device)
    bj = bi if bits_j is bits_i else torch.from_numpy(bits_j).to(device)
    cp.cooccurrence_tiles(bi, bj, torch.from_numpy(wl).to(device), ti, tj,
                          tile=cp.TILE, out=out)
    return out.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["square", "rect", "upper"])
@pytest.mark.parametrize("max_weight,block", [(127, 128), (16000, 1024), (40000, 256)])
def test_kernel_matches_plain(cuda_device, mode, max_weight, block):
    bits_i, wl_t = packed(max_weight, 1500, 250, 256, max_weight, block)
    bits_j, _ = packed(max_weight + 1, 1500, 380, 384, max_weight, block)
    if mode == "square":
        args = (bits_i, bits_i, wl_t, *cp.all_tiles(2, 2), 256, 256)
    elif mode == "rect":
        args = (bits_i, bits_j, wl_t, *cp.all_tiles(2, 3), 256, 384)
    else:
        args = (bits_j, bits_j, wl_t, *cp.upper_triangle_tiles(3), 384, 384)
    before = cp.LAUNCHES
    got = run(*args, device=cuda_device)
    torch.cuda.synchronize()
    assert cp.LAUNCHES == before + 1
    assert np.array_equal(got, run(*args, device="cpu"))


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
