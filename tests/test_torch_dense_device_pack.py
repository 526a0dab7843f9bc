"""The dense engine's chunk stream vs kspider_tpu's: posting keys packed on
the device under ``KSPIDER_DEVICE_PACK``.

The same seeded inputs go through the JAX package (``build_scatter_keys``,
``pack_inputs``, the XLA ``scatter_pack_device`` and
``shared_kmer_matrix_pallas`` in interpret mode, as its own tests run them
on the CPU) and through the port on CPU tensors.  Per chunk, the port must
choose the form kspider_tpu's formula chooses, and count it in
``cuda_pairwise.DENSE_CHUNKS``.  Every comparison is exact: equal arrays,
equal matrices, byte-equal TSVs.  The same stream on the card is held in
tests/test_torch_gpu.py.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from kspider_tpu.cli.main import cli as jcli
from kspider_tpu.ops import bitmask as jbm
from kspider_tpu.ops import pairwise as jpw
from kspider_tpu.ops import pallas_pairwise as jpp
from kspider_tpu_torch.cli.main import cli as tcli
from kspider_tpu_torch.core import pairwise as tcore
from kspider_tpu_torch.ops import bitmask as tbm
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as tpw
from kspider_tpu_torch.parallel import multiprocess as tmulti
from tests.test_pairwise_ops import random_csr

BLOCK = 128
OUTPUTS = ("_kSpider_seqToKmersNo.tsv", "_kSpider_pairwise.tsv")
ARTIFACTS = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
             "_color_count.bin", ".namesMap", ".extra")


@pytest.fixture
def counts(monkeypatch):
    """Fresh chunk counters for one test."""
    monkeypatch.setattr(cp, "DENSE_CHUNKS", {"keys": 0, "host": 0})
    monkeypatch.setattr(cp, "DENSE_H2D_BYTES", 0)
    return cp.DENSE_CHUNKS


def pin_policy(monkeypatch, policy, ratio="1"):
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", policy)
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", ratio)


def sorted_csr(seed, n_colors, n, max_degree, max_weight=500):
    return random_csr(np.random.default_rng(seed), n_colors, n,
                      max_degree=max_degree, max_weight=max_weight)


def invert_one_color(o, m, n):
    """Swap the first two members of the first color of degree >= 2."""
    c = int(np.flatnonzero(np.diff(o) >= 2)[0])
    m[o[c]], m[o[c] + 1] = m[o[c] + 1].copy(), m[o[c]].copy()
    if m[o[c]] == m[o[c] + 1]:
        m[o[c] + 1] = (m[o[c] + 1] + 1) % n
    return m


def mixed_csr(seed, n):
    """Colors in runs of 128: dense runs (degree 10-15, about 1,600
    postings a run) alternate with sparse ones (degree 2-3)."""
    rng = np.random.default_rng(seed)
    degrees = np.concatenate([
        rng.integers(10, 16, size=128) if r % 3 == 0 else
        rng.integers(2, 4, size=128) for r in range(7)])[:850]
    o = np.zeros(len(degrees) + 1, dtype=np.int64)
    np.cumsum(degrees, out=o[1:])
    m = np.concatenate([np.sort(rng.choice(n, size=d, replace=False))
                        for d in degrees]).astype(np.int32)
    w = rng.integers(1, 40000, size=len(degrees)).astype(np.int64)
    return o, m, w


# ---- build_scatter_keys ----------------------------------------------------


@pytest.mark.parametrize("case", ["bucket_pad", "exact_bucket", "one_posting",
                                  "no_colors", "int32_overflow", "unsorted",
                                  "duplicate_member"])
def test_build_scatter_keys_matches_jax(case):
    n, n_pad, nb = 300, 384, 3
    o, m, _ = sorted_csr(5, 300, n, 8)
    if case == "exact_bucket":  # 512 postings: a bucket with no pad
        n_pad = 512
        o, m = np.array([0, 512]), np.arange(512, dtype=np.int32)
    elif case == "one_posting":
        o, m = np.array([0, 1]), np.array([7], dtype=np.int32)
    elif case == "no_colors":
        o, m = np.zeros(1, np.int64), np.empty(0, np.int32)
    elif case == "int32_overflow":
        nb = 2**31 // (BLOCK * n_pad) + 1
    elif case == "unsorted":
        m = invert_one_color(o, m.copy(), n)
    elif case == "duplicate_member":
        c = int(np.flatnonzero(np.diff(o) >= 2)[0])
        m = m.copy()
        m[o[c] + 1] = m[o[c]]
    want = jbm.build_scatter_keys(o, m, n_pad, nb, BLOCK)
    got = tbm.build_scatter_keys(o, m, n_pad, nb, BLOCK)
    if case in ("int32_overflow", "unsorted", "duplicate_member"):
        assert want is None and got is None
        return
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    count = int(np.diff(o).sum())
    assert len(got) == tbm.key_bucket(count)
    tail = got[count:]
    assert (tail >= nb * BLOCK * n_pad).all() and (np.diff(tail) == 1).all()


# ---- the transposed host pack and pack_inputs -----------------------------


@pytest.mark.parametrize("n,block", [(9, 64), (200, 128), (300, 256)])
def test_pack_bitmask_blocks_t_is_the_transposed_host_pack(n, block):
    o, m, _ = sorted_csr(n, 500, n, min(n, 10))
    want = jbm.pack_bitmask_blocks(o, m, n, block).transpose(0, 2, 1)
    assert np.array_equal(tbm.pack_bitmask_blocks_t(o, m, n, block), want)
    out = np.full(want.shape, 0xA5, dtype=np.uint8)  # stale bytes are cleared
    assert tbm.pack_bitmask_blocks_t(o, m, n, block, out=out) is out
    assert np.array_equal(out, want)


@pytest.mark.parametrize("device_pack", [False, True])
@pytest.mark.parametrize("case", ["sorted", "unsorted"])
def test_pack_inputs_matches_jax(device_pack, case):
    n = 300
    o, m, w = sorted_csr(11, 400, n, 9, max_weight=40000)
    n_pad = 384
    if case == "unsorted":
        m = invert_one_color(o, m.copy(), n)
    wl = tpw.weight_limbs(w)
    want = jpp.pack_inputs(o, m, wl, n_pad, BLOCK, device_pack=device_pack)
    got = cp.pack_inputs(o, m, wl, n_pad, BLOCK, device_pack=device_pack)
    assert got[1].dtype == np.int8 and np.array_equal(got[1], want[1])
    keyed = device_pack and case == "sorted"
    assert isinstance(got[0], tuple) == isinstance(want[0], tuple) == keyed
    if keyed:
        assert got[0][0] == want[0][0] == "keys" and got[0][2] == want[0][2]
        assert np.array_equal(got[0][1], want[0][1])
    else:
        assert got[0].dtype == np.uint8 and np.array_equal(got[0], want[0])


def test_pack_inputs_fills_the_arrays_it_is_given():
    """``empty`` makes both arrays (the engine's pinned tensors on a card;
    plain CPU tensors here); they are filled in place and returned."""
    o, m, w = sorted_csr(13, 500, 250, 10, max_weight=40000)
    wl = tpw.weight_limbs(w)
    made = []

    def empty(shape, dtype):
        t = torch.full(shape, 7, dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
        made.append(t)
        return t

    want = jpp.pack_inputs(o, m, wl, 256, BLOCK)
    bits, wl_t = cp.pack_inputs(o, m, wl, 256, BLOCK, empty=empty)
    assert bits is made[1] and wl_t is made[0]
    assert np.array_equal(bits.numpy(), want[0])
    assert np.array_equal(wl_t.numpy(), want[1])


@pytest.mark.parametrize("n,n_pad,block", [(200, 256, 128), (700, 768, 256)])
def test_scatter_pack_of_chunk_keys_matches_jax_and_host(n, n_pad, block):
    o, m, _ = sorted_csr(n + block, 600, n, 12)
    nb = -(-600 // block)
    keys = tbm.build_scatter_keys(o, m, n_pad, nb, block)
    host = tbm.pack_bitmask_blocks(o, m, n_pad, block).transpose(0, 2, 1)
    jax_bits = np.asarray(jbm.scatter_pack_device(keys, nb, block, n_pad, True))
    for arg in (keys, keys[: len(m)]):  # bucket-padded, and the exact keys
        got = tbm.scatter_pack_device(arg, nb, block, n_pad, device="cpu")
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), jax_bits)
        assert np.array_equal(got.numpy(), host)


# ---- the whole dense engine ------------------------------------------------


@pytest.mark.parametrize("policy", ["force", "auto", "off"])
def test_dense_matrix_under_policy_matches_pallas(monkeypatch, counts, policy):
    pin_policy(monkeypatch, policy)
    n = 800
    o, m, w = sorted_csr(17, 1200, n, 15, max_weight=40000)
    want = jpp.shared_kmer_matrix_pallas(o, m, w, n, block=256, interpret=True)
    assert np.array_equal(want, jpw.shared_kmer_matrix_numpy(o, m, w, n))
    # the environment, then the same policy as an argument
    for device_pack in (None, policy):
        got = cp.shared_kmer_matrix_cuda(o, m, w, n, device="cpu", block=256,
                                         device_pack=device_pack)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    keyed = policy != "off"  # 1,200 colors of <= 15 members: auto keys them
    assert counts == {"keys": 2 if keyed else 0, "host": 0 if keyed else 2}
    assert cp.DENSE_H2D_BYTES > 0


@pytest.mark.parametrize("policy", ["auto", "force"])
def test_ragged_chunks_choose_by_kspider_tpus_formula(monkeypatch, counts,
                                                      policy):
    """One-block chunks over three super-blocks, dense and sparse runs of
    colors: each chunk's form is the one kspider_tpu's formula gives for
    that chunk, auto mixes both forms, and the matrix stays exact."""
    pin_policy(monkeypatch, policy)
    n = 300
    o, m, w = mixed_csr(19, n)
    want = jpp.shared_kmer_matrix_pallas(o, m, w, n, block=BLOCK, interpret=True)
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 300)  # 256-color supers
    monkeypatch.setattr(cp, "CHUNK_BLOCKS", 1)
    chosen, real = [], cp.pack_inputs

    def recorded(off, mem, wl, n_pad, block, device_pack=False, **kw):
        out = real(off, mem, wl, n_pad, block, device_pack=device_pack, **kw)
        nb = max(1, -(-(len(off) - 1) // block))
        formula = policy == "force" or (
            4 * jbm.key_bucket(len(mem)) * 1.0 <= nb * block * n_pad // 8)
        chosen.append((device_pack, formula, isinstance(out[0], tuple)))
        return out

    monkeypatch.setattr(cp, "pack_inputs", recorded)
    got = cp.shared_kmer_matrix_cuda(o, m, w, n, device="cpu", block=BLOCK)
    assert np.array_equal(got, want)
    assert len(chosen) == 7 == counts["keys"] + counts["host"]
    assert all(dp == formula == keyed for dp, formula, keyed in chosen)
    if policy == "auto":
        assert counts["keys"] > 0 and counts["host"] > 0
    else:
        assert counts == {"keys": 7, "host": 0}


def test_dense_unsorted_members_fall_back(monkeypatch, counts):
    """Unsorted members within a color disqualify the chunk's keys: it is
    packed on the host, counted as such, and stays exact."""
    pin_policy(monkeypatch, "force", "1.25")
    n = 400
    o, m, w = random_csr(np.random.default_rng(23), 500, n, max_degree=10,
                         max_weight=500)
    m = invert_one_color(o, m, n)
    assert tbm.build_scatter_keys(o, m, 512, 4, 128) is None
    want = jpp.shared_kmer_matrix_pallas(o, m, w, n, block=BLOCK, interpret=True)
    got = cp.shared_kmer_matrix_cuda(o, m, w, n, device="cpu", block=BLOCK)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, n))
    assert counts == {"keys": 0, "host": 1}


@pytest.mark.parametrize("engine,want", [("auto", "force"), ("pallas", "force"),
                                         ("bitmask", "off")])
def test_engine_names_hand_the_policy_on(monkeypatch, counts, engine, want):
    """"auto" (one device) and "pallas" follow the policy, as they reach
    kspider_tpu's Pallas engine; "bitmask" packs on the host, as
    kspider_tpu's bitmask engine does."""
    o, m, w = sorted_csr(29, 300, 200, 8)
    got = tpw.shared_kmer_matrix(o, m, w, 200, device="cpu", block=BLOCK,
                                 engine=engine, device_pack="force")
    assert np.array_equal(got, jpw.shared_kmer_matrix_numpy(o, m, w, 200))
    assert counts == ({"keys": 1, "host": 0} if want == "force"
                      else {"keys": 0, "host": 1})


def test_compute_shared_matrix_and_color_slices_hand_the_policy_on(
        monkeypatch, counts):
    """The policy reaches the dense engine from ``compute_shared_matrix``
    and from each color slice of a multi-process run, and the slices sum
    to the single-process matrix."""
    from tests.test_torch_multiprocess import _index

    index = _index()
    seen, real = [], cp.shared_kmer_matrix_cuda

    def recorded(*args, device_pack=None, **kw):
        seen.append(device_pack)
        return real(*args, device_pack=device_pack, **kw)

    monkeypatch.setattr(cp, "shared_kmer_matrix_cuda", recorded)
    whole = tcore.compute_shared_matrix(index, device="cpu", device_pack="force")
    lo_hi = [tmulti.color_slice(index.num_colors, r, 2) for r in range(2)]
    parts = [tmulti._local_partial_from_slice(index, lo, hi, "cpu", "auto",
                                              "off") for lo, hi in lo_hi]
    assert seen == ["force", "off", "off"]
    assert np.array_equal(parts[0] + parts[1], whole)
    assert counts["keys"] > 0 and counts["host"] > 0


# ---- through the CLI -------------------------------------------------------


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    """One index written by the port, run once by kspider_tpu's CLI per
    policy with ``--engine pallas`` (its dense engine that follows the
    policy, in interpret mode on the CPU)."""
    from kspider_tpu_torch.io import artifacts
    from tests.test_torch_multiprocess import _index

    root = tmp_path_factory.mktemp("dense_device_pack")
    prefix = str(root / "idx")
    artifacts.write_index_artifacts(prefix, _index())
    return prefix


def copy_index(src, dst):
    for suffix in ARTIFACTS:
        shutil.copy(src + suffix, dst + suffix)


def run_jax_cli(prefix, policy):
    result = CliRunner().invoke(
        jcli, ["pairwise", "-i", prefix, "--engine", "pallas",
               "--device-pack", policy], catch_exceptions=False)
    assert result.exit_code == 0, result.output


@pytest.mark.parametrize("engine", ["auto", "pallas"])
@pytest.mark.parametrize("policy", ["force", "off"])
def test_cli_device_pack_byte_identical(monkeypatch, counts, small_index,
                                        tmp_path, policy, engine):
    # kspider_tpu's CLI scopes the variable to its call; pin it anyway
    monkeypatch.delenv("KSPIDER_DEVICE_PACK", raising=False)
    monkeypatch.delenv("KSPIDER_DEVICE_PACK_RATIO", raising=False)
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    copy_index(small_index, jax_prefix)
    copy_index(small_index, port_prefix)
    run_jax_cli(jax_prefix, policy)
    assert "KSPIDER_DEVICE_PACK" not in os.environ
    result = CliRunner().invoke(
        tcli, ["pairwise", "-i", port_prefix, "--device", "cpu", "--engine",
               engine, "--device-pack", policy], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    for suffix in OUTPUTS:
        assert filecmp.cmp(port_prefix + suffix, jax_prefix + suffix,
                           shallow=False), suffix
    assert counts["keys" if policy == "force" else "host"] > 0
    assert counts["host" if policy == "force" else "keys"] == 0


def test_run_pairwise_passes_the_policy_to_the_dense_engine(
        monkeypatch, counts, small_index, tmp_path):
    monkeypatch.delenv("KSPIDER_DEVICE_PACK", raising=False)
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    copy_index(small_index, jax_prefix)
    copy_index(small_index, port_prefix)
    run_jax_cli(jax_prefix, "force")
    shared = tcore.run_pairwise(port_prefix, device="cpu", engine="auto",
                                device_pack="force", echo_timers=False)
    assert shared.dtype == np.int64
    assert counts["keys"] > 0 and counts["host"] == 0
    for suffix in OUTPUTS:
        assert filecmp.cmp(port_prefix + suffix, jax_prefix + suffix,
                           shallow=False), suffix


@pytest.mark.parametrize("policy", ["force", "off"])
def test_color_slice_processes_with_a_policy_match_single(tmp_path, policy):
    """Two coordinated CLI processes over color slices with
    ``--device-pack``: the TSV equals the single-process one."""
    from kspider_tpu_torch.io import artifacts
    from tests.test_torch_multiprocess import (_assert_same, _golden_dense,
                                               _index, _spawn_workers)

    index = _index()
    golden = _golden_dense(tmp_path, index)
    prefix = str(tmp_path / "dist")
    artifacts.write_index_artifacts(prefix, index)
    _spawn_workers(tmp_path, "cli", prefix, extra=["--device-pack", policy])
    _assert_same(prefix, golden, tmp_path)
