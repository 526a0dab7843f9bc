"""kspider_tpu_torch's fused single-device step and dense CC vs kspider_tpu's.

The same seeded inputs (``make_example_blocks``, random adjacencies) go
through kspider_tpu's jitted step on the CPU and through the port on CPU
tensors, where the Gram product takes the kernel's plain version.
Tolerance: exact equality of ``shared`` and ``labels``.  The step on the
card is held against scipy in tests/test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch

from kspider_tpu.ops import cc as jcc
from kspider_tpu.parallel import step as jstep
from kspider_tpu_torch.ops import cc as tcc
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.parallel import step as tstep


@pytest.mark.parametrize("n,n_edges", [(100, 150), (300, 120), (1, 0), (64, 2000)])
def test_dense_cc_matches_jax_and_scipy(n, n_edges):
    rng = np.random.default_rng(n + n_edges)
    adj = np.zeros((n, n), dtype=bool)
    src = rng.integers(0, n, size=n_edges)
    dst = rng.integers(0, n, size=n_edges)
    adj[src, dst] = True
    adj |= adj.T
    stats = {}
    got = tcc.connected_components_dense(torch.from_numpy(adj), stats)
    assert got.dtype == torch.int32 and stats["rounds"] >= 1
    want = np.asarray(jcc.connected_components_dense(jax.numpy.asarray(adj)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), jcc.connected_components_scipy(src, dst, n))


@pytest.mark.parametrize("kwargs", [
    dict(n_samples=64, n_colors=256, block=32, seed=3),
    dict(n_samples=64, n_colors=512, block=8, seed=5),
    dict(n_samples=256, n_colors=2048, block=256),
    dict(n_samples=300, n_colors=900, block=128, seed=1, max_weight=40000),
])
def test_make_example_blocks_matches_jax(kwargs):
    got = tstep.make_example_blocks(**kwargs)
    want = jstep.make_example_blocks(**kwargs)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3:] == want[3:]


def scipy_labels(shared, counts, cutoff):
    """JAX's thresholding in numpy float32, then scipy's CC."""
    n = len(counts)
    denom = np.minimum(counts[:, None], counts[None, :]).astype(np.float32)
    cont = shared.astype(np.float32) / np.maximum(denom, np.float32(1.0))
    adj = (cont >= np.float32(cutoff)) & (shared > 0)
    return jcc.connected_components_scipy(*np.nonzero(adj), n)


@pytest.mark.parametrize("kwargs,cutoff", [
    (dict(n_samples=64, n_colors=256, block=32, seed=3), 0.01),
    (dict(n_samples=64, n_colors=512, block=8, seed=5), 0.02),
    (dict(n_samples=256, n_colors=2048, block=256), 0.3),
    (dict(n_samples=300, n_colors=900, block=128, seed=1, max_weight=40000), 0.05),
    (dict(n_samples=200, n_colors=400, block=64, seed=9), 0.7),
])
def test_single_device_step_matches_jax(kwargs, cutoff):
    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(**kwargs)
    want_s, want_l = jstep.single_device_step(
        bits, wl, counts, cutoff, block=block, n_pad=n_pad, n_limbs=n_limbs)
    stats = {}
    got_s, got_l = tstep.single_device_step(
        bits, wl, counts, cutoff, block, n_pad, n_limbs, device="cpu",
        stats=stats)
    assert got_s.dtype == torch.int32 and got_l.dtype == torch.int32
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert np.array_equal(got_l.numpy(), scipy_labels(got_s.numpy(), counts, cutoff))
    assert stats["rounds"] >= 1


def test_step_takes_the_plain_version_on_the_cpu():
    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(
        n_samples=64, n_colors=256, block=32, seed=3)
    before = cp.LAUNCHES
    tstep.single_device_step(bits, wl, counts, 0.01, block, n_pad, n_limbs,
                             device="cpu")
    assert cp.LAUNCHES == before


def test_graft_entry_shapes_match_jax():
    import __graft_entry__ as ge  # the repo root is on sys.path (conftest)

    fn, args = ge.entry()
    want_s, want_l = fn(*args)
    bits, wl, counts, cutoff = args
    kw = fn.keywords
    got_s, got_l = tstep.single_device_step(
        bits, wl, counts, cutoff, kw["block"], kw["n_pad"], kw["n_limbs"],
        device="cpu")
    assert got_s.shape == (256, 256)
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))


def test_step_rejects_bad_shapes():
    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(
        n_samples=64, n_colors=256, block=32, seed=3)
    with pytest.raises(ValueError, match="bits"):
        tstep.single_device_step(bits, wl, counts, 0.1, 64, n_pad, n_limbs,
                                 device="cpu")
    with pytest.raises(ValueError, match="w_limbs"):
        tstep.single_device_step(bits, wl, counts, 0.1, block, n_pad,
                                 n_limbs + 1, device="cpu")


def test_step_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(
        n_samples=64, n_colors=256, block=32, seed=3)
    with pytest.raises(RuntimeError, match="cuda"):
        tstep.single_device_step(bits, wl, counts, 0.1, block, n_pad, n_limbs,
                                 device="cuda")


@pytest.mark.parametrize("kwargs,cutoff,n_dev", [
    (dict(n_samples=64, n_colors=512, block=8, seed=5), 0.02, 8),
    (dict(n_samples=256, n_colors=2048, block=256), 0.3, 4),
    (dict(n_samples=300, n_colors=900, block=128, seed=1, max_weight=40000), 0.05, 2),
])
def test_sharded_step_matches_jax_and_single(kwargs, cutoff, n_dev):
    """kspider_tpu's ``sharded_step`` on its virtual CPU mesh, the port's on
    a list of CPU devices and the port's ``single_device_step``: equal
    ``shared`` and ``labels``."""
    from kspider_tpu.parallel import mesh as jmesh

    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(**kwargs)
    pad = -bits.shape[0] % n_dev  # whole blocks per device, as shard_map needs
    bits = np.concatenate([bits, np.zeros((pad,) + bits.shape[1:], np.uint8)])
    wl = np.concatenate([wl, np.zeros((pad,) + wl.shape[1:], np.int8)])
    want_s, want_l = jstep.sharded_step(jmesh.make_mesh(n_dev), bits, wl, counts,
                                        cutoff, block, n_pad, n_limbs)
    stats = {}
    got_s, got_l = tstep.sharded_step(["cpu"] * n_dev, bits, wl, counts, cutoff,
                                      block, n_pad, n_limbs, stats=stats)
    one_s, one_l = tstep.single_device_step(bits, wl, counts, cutoff, block,
                                            n_pad, n_limbs, device="cpu")
    assert got_s.dtype == torch.int32 and got_l.dtype == torch.int32
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert torch.equal(got_s, one_s) and torch.equal(got_l, one_l)
    assert stats["rounds"] >= 1


def test_sharded_step_refuses_uneven_blocks():
    bits, wl, counts, block, n_pad, n_limbs = tstep.make_example_blocks(
        n_samples=64, n_colors=256, block=32, seed=3)
    with pytest.raises(ValueError, match="split evenly"):
        tstep.sharded_step("cpu,cpu,cpu", bits, wl, counts, 0.1, block, n_pad,
                           n_limbs)
