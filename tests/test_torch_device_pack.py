"""kspider_tpu_torch's posting-key codecs and torch device pack vs kspider_tpu.

The encoders are numpy copies and must return what the JAX module returns.
The torch ``scatter_pack_device`` and its ``delta`` / ``delta8`` forms, run
here on CPU tensors, must equal the host packer and the JAX device pack
(XLA on the CPU) byte for byte, escapes included.  The streamed pairs must
be identical under every device-pack policy.  Tolerance: exact.
"""

import numpy as np
import pytest

from kspider_tpu.ops import bitmask as jbm
from kspider_tpu.ops import tiled_pairwise as jtp
from kspider_tpu_torch.ops import bitmask as tbm
from kspider_tpu_torch.ops import tiled_pairwise as ttp
from tests.test_pairwise_ops import random_csr
from tests.test_torch_tiled_pairwise import assert_same_stream, both_plans


def padded_keys(keys, total):
    bucket = jbm.key_bucket(len(keys))
    out = np.empty(bucket, np.int32)
    out[:len(keys)] = keys
    out[len(keys):] = total + np.arange(bucket - len(keys), dtype=np.int32)
    return out


def escaped_keys(rng, total):
    """Short runs of small gaps separated by gaps > 255 (d8 escapes) and
    by gaps > 32767 (no d16 form)."""
    parts, base = [], 0
    for r in range(40):
        parts.append(base + np.cumsum(rng.integers(1, 200, size=20)))
        base = int(parts[-1][-1]) + int(rng.integers(300, 2000)) \
            + (40000 if r % 7 == 6 else 0)
        if base >= total - 5000:
            break
    return np.concatenate(parts).astype(np.int32)


def test_encoders_match_jax():
    rng = np.random.default_rng(3)
    for m in (0, 1, 512, 513, 1000, 4097, 10**6):
        assert tbm.key_bucket(m) == jbm.key_bucket(m)
    total = 2 * 128 * 4096
    dense = padded_keys(np.sort(rng.choice(20000, 700, replace=False)), total)
    sparse = padded_keys(escaped_keys(rng, total), total)
    wide = padded_keys(np.arange(10, dtype=np.int32) * 40000, 10**6)
    for keys, count in ((dense, 700), (sparse, int((sparse < total).sum())),
                        (wide, 10), (dense, 0)):
        for name in ("delta_encode_keys", "delta_encode_keys_u8",
                     "encode_keys_best"):
            want = getattr(jbm, name)(keys, count)
            got = getattr(tbm, name)(keys, count)
            assert (want is None) == (got is None), name
            if want is not None:
                assert len(want) == len(got)
                for a, b in zip(want, got):
                    if isinstance(a, np.ndarray):
                        assert a.dtype == b.dtype and np.array_equal(a, b)
                    else:
                        assert a == b
    assert tbm.encode_keys_best(dense, 700)[0] == "d8"
    assert tbm.delta_encode_keys(sparse, int((sparse < total).sum())) is None


def test_device_pack_policy(monkeypatch):
    monkeypatch.delenv("KSPIDER_DEVICE_PACK", raising=False)
    monkeypatch.delenv("KSPIDER_DEVICE_PACK_RATIO", raising=False)
    assert tbm.device_pack_policy() == jbm.device_pack_policy() == ("auto", 1.25)
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "FORCE")
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", "3")
    assert tbm.device_pack_policy() == jbm.device_pack_policy() == ("force", 3.0)
    # an explicit policy wins over the environment
    assert tbm.device_pack_policy("off") == ("off", 3.0)
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "bogus")
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", "x")
    with pytest.warns(RuntimeWarning):
        assert tbm.device_pack_policy() == ("auto", 1.25)
    with pytest.raises(ValueError):
        tbm.device_pack_policy("bogus")


def _sorted_csr(rng, n_colors, n, max_degree):
    o, m, _ = random_csr(rng, n_colors, n, max_degree=max_degree, max_weight=10)
    return o, m


@pytest.mark.parametrize("n_colors,n,panel_pad,block", [
    (500, 700, 768, 128), (1, 100, 128, 128), (0, 1, 256, 128)])
def test_scatter_pack_matches_host_and_jax(n_colors, n, panel_pad, block):
    rng = np.random.default_rng(n_colors)
    if n_colors:
        o, m = _sorted_csr(rng, n_colors, n, 60)
    else:
        o, m = np.zeros(2, np.int64), np.zeros(0, np.int32)
        n_colors = 1
    n_blocks = -(-n_colors // block)
    total = n_blocks * block * panel_pad
    host = tbm.pack_bitmask_blocks(
        np.concatenate([o, np.full(n_blocks * block - n_colors, o[-1])]),
        m, panel_pad, block).transpose(0, 2, 1)
    seg = np.repeat(np.arange(n_colors), np.diff(o))
    keys = padded_keys(seg * panel_pad + m, total)
    got = tbm.scatter_pack_device(keys, n_blocks, block, panel_pad,
                                  device="cpu").numpy()
    want = np.asarray(jbm.scatter_pack_device(keys, n_blocks, block,
                                              panel_pad, True))
    assert got.dtype == np.uint8
    assert np.array_equal(got, host) and np.array_equal(got, want)


@pytest.mark.parametrize("form", ["d16", "d8"])
def test_delta_forms_match_jax(form):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n_blocks, block, panel_pad = 2, 128, 512
    total = n_blocks * block * panel_pad
    raw = (np.sort(rng.choice(total, 700, replace=False)).astype(np.int32)
           if form == "d16" else escaped_keys(rng, total))
    keys = padded_keys(raw, total)
    m = len(raw)
    ref = tbm.scatter_pack_device(keys, n_blocks, block, panel_pad,
                                  device="cpu").numpy()
    geometry = (n_blocks, block, panel_pad)
    if form == "d16":
        first, d16 = tbm.delta_encode_keys(keys, m)
        got = tbm.scatter_pack_device_delta(first, d16, m, *geometry,
                                            device="cpu")
        want = jbm.scatter_pack_device_delta(
            np.int32(first), jnp.asarray(d16), np.int32(m), *geometry, True)
    else:
        first, d8, exc = tbm.delta_encode_keys_u8(keys, m)
        assert (d8[1:m] == 0).sum() > 0 and (exc[:(d8[1:m] == 0).sum()] > 255).all()
        got = tbm.scatter_pack_device_delta8(first, d8, exc, m, *geometry,
                                             device="cpu")
        want = jbm.scatter_pack_device_delta8(
            np.int32(first), jnp.asarray(d8), jnp.asarray(exc), np.int32(m),
            *geometry, True)
        # the engine ships the exact-length payload: same bits
        cut = tbm.scatter_pack_device_delta8(first, d8[:m], exc, m, *geometry,
                                             device="cpu")
        assert np.array_equal(cut.numpy(), ref)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["force", "auto", "off"])
def test_stream_identical_under_device_pack(monkeypatch, policy):
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", policy)
    # a ratio at which auto ships some sides as keys and some as bits
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", "3")
    n = 1100
    o, m, w = random_csr(np.random.default_rng(7), 900, n, max_degree=12,
                         max_weight=40000)
    jplan, tplan = both_plans(o, m, w, n, 256)
    want = list(jtp.iter_panel_pairs(jplan, engine="xla", block=128, tile=128))
    for device_pack in (None, policy):  # environment, then explicit argument
        stats = {}
        assert_same_stream(iter(want), ttp.iter_panel_pairs(
            tplan, device="cpu", block=128, stats=stats,
            device_pack=device_pack))
        if policy == "force":
            assert stats["keys_sides"] > 0 and stats["bits_sides"] == 0
        elif policy == "off":
            assert stats["keys_sides"] == 0 and stats["bits_sides"] > 0
        else:
            assert stats["keys_sides"] > 0 and stats["bits_sides"] > 0


def test_device_pack_composes_with_big_weights_escapes_and_cache():
    rng = np.random.default_rng(11)
    n = 1600
    o, m, w = random_csr(rng, 300, n, max_degree=5, max_weight=1000)
    w = w * 30_000_000
    jplan, tplan = both_plans(o, m, w, n, 512)
    assert tplan.max_weight_sum >= 2**31
    want = list(jtp.iter_panel_pairs(jplan, engine="xla", block=128, tile=128))
    stats = {}
    assert_same_stream(iter(want), ttp.iter_panel_pairs(
        tplan, device="cpu", block=128, device_pack="force", stats=stats))
    # every side ships as posting keys, off-diagonal and diagonal alike: one
    # side a diagonal pair, two an off-diagonal one (each pair one chunk)
    pi, pj = divmod(tplan.pair_keys, tplan.n_panels)
    assert (pi == pj).any() and (pi != pj).any()
    assert stats["keys_sides"] == int((pi == pj).sum() + 2 * (pi != pj).sum())
    assert stats["bits_sides"] == 0
