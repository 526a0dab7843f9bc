"""The hand-written CUDA Gram kernel vs its plain torch version, on the card.

Every case is marked ``gpu`` and skips without a CUDA card.  The file
imports neither jax nor kspider_tpu's jax modules, so it also runs on a
machine without jax (``tests/conftest.py`` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The plain version is held against kspider_tpu's Pallas kernels on the CPU
in tests/test_torch_cuda_pairwise.py.  Tolerance: exact int32 equality.
"""

import numpy as np
import pytest
import torch

from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as tpw

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
