"""kspider_tpu_torch's panel-streamed engine vs kspider_tpu's.

The same seeded CSRs go through the JAX package's tiled engine (Pallas in
interpret mode, or its XLA engine, as its own tests run them on the CPU)
and through the port on the CPU (the Gram kernel's plain torch version).
Tolerance everywhere: exact.  The plan fields, the re-homed host packers,
each chunk's raw int32 limb accumulators, the yielded
``(pi, pj, gi, gj, shared)`` sequence, the streamed TSV bytes and the
clusters of ``cluster_from_index`` must all be equal.  The plan is also
held against the port's own numpy plan (``KSPIDER_NATIVE=off``, a library
that cannot load, more panel pairs than the native plan's key table).
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kspider_tpu.core import cluster as jcluster
from kspider_tpu.ops import pairwise as jpw
from kspider_tpu.ops import pallas_pairwise as jpp
from kspider_tpu.ops import tiled_pairwise as jtp
from kspider_tpu_torch.core import cluster as tcluster
from kspider_tpu_torch.core import pairwise as tpairwise
from kspider_tpu_torch.io import native as t_native
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as tpw
from kspider_tpu_torch.ops import tiled_pairwise as ttp
from tests.test_pairwise_ops import random_csr
from tests.test_tiled_pairwise import _FakeIndex, _global_color_csr

BLOCK = 128
TILE = 128
PLAN_FIELDS = ("n", "panel", "n_panels", "mem_s", "seg_start", "seg_count",
               "seg_color", "w_limbs", "pair_keys", "pair_off", "ent_sega",
               "ent_segb", "max_weight_sum", "src_shape")


def csr(seed, n_colors=500, n=700, max_degree=12, max_weight=40000):
    return random_csr(np.random.default_rng(seed), n_colors, n,
                      max_degree=max_degree, max_weight=max_weight)


def both_plans(o, m, w, n, panel):
    return (jtp.build_panel_plan(o, m, w, n, panel),
            ttp.build_panel_plan(o, m, w, n, panel))


def assert_same_stream(jax_iter, port_iter):
    want, got = list(jax_iter), list(port_iter)
    assert [(g[0], g[1]) for g in got] == [(x[0], x[1]) for x in want]
    for x, g in zip(want, got):
        for a, b in zip(x[2:], g[2:]):
            assert b.dtype == np.int64
            assert np.array_equal(np.asarray(a), b)
    return got


# ---- plan and host packing ------------------------------------------------


def _unsorted(o, m, w):
    m = m.copy()
    for c in range(len(o) - 1):
        m[o[c]:o[c + 1]] = m[o[c]:o[c + 1]][::-1]
    return o, m, w


def _with_colors(o, m, w, extra):
    """The CSR with the colors ``extra`` (member lists) appended."""
    deg = np.array([len(x) for x in extra], np.int64)
    o = np.concatenate([o, o[-1] + np.cumsum(deg)])
    m = np.concatenate([m] + [np.asarray(x, m.dtype) for x in extra])
    return o, m, np.concatenate([w, np.arange(1, len(extra) + 1)])


def _with_duplicates(o, m, w):
    """Every seventh color holds its first member twice, and two colors are
    one member twice: duplicate (color, member) postings."""
    cols = [m[o[c]:o[c + 1]] for c in range(len(o) - 1)]
    cols = [np.insert(x, 0, x[0]) if c % 7 == 0 else x
            for c, x in enumerate(cols)]
    o = np.zeros(len(cols) + 1, np.int64)
    np.cumsum([len(x) for x in cols], out=o[1:])
    return _with_colors(o, np.concatenate(cols), w, [[5, 5], [699, 699]])


def _spanning(o, m, w, n, panel):
    """Colors whose members lie in every panel (two in some panels)."""
    rng = np.random.default_rng(panel)
    extra = []
    for _ in range(40):
        per = [lo + rng.choice(min(panel, n - lo), size=rng.integers(1, 3),
                               replace=False) for lo in range(0, n, panel)]
        extra.append(np.unique(np.concatenate(per)))
    return _with_colors(o, m, w, extra)


def _datagen_csr(seed, genomes=4096):
    """``gpubench.datagen``'s collection at a reduced N: species of 8
    scattered over the ids, so a color spans up to 8 panels of 512."""
    from gpubench import datagen

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "gpubench", "configs", "gtdb-derep-32k.json")) as f:
        config = dict(json.load(f), genomes=genomes)
    col = datagen.generate(config, seed)
    return col.offsets, col.members, col.counts, genomes


def plan_case(case, panel, seed=None):
    """(offsets, members, weights, n) of one named CSR case."""
    n = 700
    seed = panel if seed is None else seed
    if case == "singletons":
        return np.arange(6, dtype=np.int64), np.arange(5), np.ones(5, np.int64), n
    if case == "no_samples":
        return np.zeros(1, np.int64), np.zeros(0, np.int32), \
            np.zeros(0, np.int64), 0
    if case == "datagen":
        return _datagen_csr(2147491711 + seed)
    o, m, w = csr(seed)
    if case == "unsorted":
        o, m, w = _unsorted(o, m, w)
    elif case == "duplicates":
        o, m, w = _with_duplicates(o, m, w)
    elif case == "spanning":
        o, m, w = _spanning(o, m, w, n, panel)
    return o, m, w, n


def assert_same_plan(want, got):
    for field in PLAN_FIELDS:
        a, b = getattr(want, field), getattr(got, field)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        else:
            assert a == b, field


def plan_with_ranges(*args):
    """build_panel_plan(*args) under a CPU profiler: the plan and the names
    of the ranges it opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = ttp.build_panel_plan(*args)
    return plan, {e.name for e in prof.events()}


@pytest.mark.parametrize("panel,case", [
    (p, c) for p in (128, 300)
    for c in ("sorted", "unsorted", "singletons", "no_samples")
] + [
    (1024, "sorted"),  # one panel
    (2, "sorted"),  # 350 panels: pair keys beyond uint16
    (2, "unsorted"),
    (128, "duplicates"),
    (300, "duplicates"),
    (128, "spanning"),
    (512, "datagen"),
])
def test_build_panel_plan_matches_jax(case, panel):
    o, m, w, n = plan_case(case, panel)
    want, got = both_plans(o, m, w, n, panel)
    assert_same_plan(want, got)
    if case == "datagen":
        assert np.bincount(got.seg_color).max() == 8
    if case == "spanning":
        assert np.bincount(got.seg_color).max() == got.n_panels


@pytest.mark.parametrize("native_mode", ["auto", "off"])
@pytest.mark.parametrize("case", ["sorted", "unsorted"])
@pytest.mark.parametrize("seed", [3, 17, 29])
def test_native_plan_matches_numpy_plan(monkeypatch, native_mode, case, seed):
    """The plan under ``KSPIDER_NATIVE=native_mode`` equals the numpy
    plan, field by field; only the numpy plan opens ``kspider.plan_numpy``."""
    rng = np.random.default_rng(seed)
    panel = int(rng.choice([1, 7, 64, 128, 300, 1000]))
    o, m, w = csr(seed, max_degree=int(rng.integers(2, 30)))
    if case == "unsorted":
        o, m, w = _unsorted(o, m, w)
    monkeypatch.setenv("KSPIDER_NATIVE", "off")
    want, numpy_ranges = plan_with_ranges(o, m, w, 700, panel)
    monkeypatch.setenv("KSPIDER_NATIVE", native_mode)
    got, ranges = plan_with_ranges(o, m, w, 700, panel)
    assert_same_plan(want, got)
    assert "kspider.plan_numpy" in numpy_ranges
    assert ("kspider.plan_numpy" in ranges) == (native_mode == "off")
    if case == "sorted":  # the postings are the caller's
        assert np.shares_memory(got.mem_s, m)


def test_plan_falls_back_to_numpy_where_the_library_cannot_load(monkeypatch):
    o, m, w = csr(11)
    want = ttp.build_panel_plan(o, m, w, 700, 128)
    monkeypatch.setattr(t_native, "_warned_fallbacks", set())
    monkeypatch.setattr(ttp, "_load_plan_library",
                        lambda: (None, RuntimeError("no host compiler")))
    with pytest.warns(RuntimeWarning, match="'panel_plan'.*no host compiler"):
        got, ranges = plan_with_ranges(o, m, w, 700, 128)
    assert_same_plan(want, got)
    assert "kspider.plan_numpy" in ranges
    monkeypatch.setenv("KSPIDER_NATIVE", "force")
    with pytest.raises(t_native.NativeRequiredError, match="panel_plan"):
        ttp.build_panel_plan(o, m, w, 700, 128)


def test_plan_takes_numpy_above_the_key_table_guard(monkeypatch):
    """More than ``PLAN_TABLE_KEYS`` panel pairs: the numpy plan, with no
    fallback reported (so none under ``KSPIDER_NATIVE=force`` either)."""
    o, m, w = csr(13)
    want, ranges = plan_with_ranges(o, m, w, 700, 128)  # 6 panels, 36 keys
    assert "kspider.plan_numpy" not in ranges
    monkeypatch.setattr(ttp, "PLAN_TABLE_KEYS", 35)
    monkeypatch.setenv("KSPIDER_NATIVE", "force")
    got, ranges = plan_with_ranges(o, m, w, 700, 128)
    assert_same_plan(want, got)
    assert "kspider.plan_numpy" in ranges


@pytest.mark.parametrize("fault", ["member_at_n", "negative_member",
                                   "offsets_short", "offsets_from_1"])
def test_plan_refuses_a_malformed_csr(fault):
    o, m, w = csr(19)
    if fault == "member_at_n":
        m = m.copy()
        m[o[3] + 1] = 700
    elif fault == "negative_member":
        m = m.copy()
        m[o[3]] = -1
    elif fault == "offsets_short":
        o = o.copy()
        o[-1] -= 1
    else:
        o = o.copy()
        o[0] = 1
    with pytest.raises(ValueError):
        ttp.build_panel_plan(o, m, w, 700, 128)


@pytest.mark.parametrize("native_mode", ["auto", "off"])
def test_host_side_packers_match_jax(monkeypatch, native_mode):
    monkeypatch.setenv("KSPIDER_NATIVE", native_mode)
    o, m, w = csr(5)
    jplan, tplan = both_plans(o, m, w, 700, 300)
    panel_pad = 384
    for p in range(len(tplan.pair_keys)):
        pk = int(tplan.pair_keys[p])
        pi = pk // tplan.n_panels
        segs = tplan.ent_sega[tplan.pair_off[p]:tplan.pair_off[p + 1]]
        nb = -(-len(segs) // BLOCK)
        for a, b in zip(jtp._gather_side(jplan, segs), ttp._gather_side(tplan, segs)):
            assert np.array_equal(a, b)
        want = jtp._pack_panel_side(jplan, pi, segs, nb, BLOCK, panel_pad, True)
        got = ttp._pack_panel_side(tplan, pi, segs, nb, BLOCK, panel_pad)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        colors = tplan.seg_color[segs]
        assert np.array_equal(
            ttp._pad_limbs(tplan.w_limbs[colors], nb, BLOCK),
            jtp._pad_limbs(jplan.w_limbs[colors], nb, BLOCK, True))
        assert np.array_equal(
            ttp._postings_keys(tplan, pi, segs, panel_pad, nb, BLOCK),
            jtp._postings_keys(jplan, pi, segs, panel_pad, nb, BLOCK))


def test_postings_keys_guards():
    fields = dict(
        n=8, panel=8, n_panels=1, mem_s=np.arange(4, dtype=np.int32),
        seg_start=np.array([0], np.int64), seg_count=np.array([4], np.int64),
        seg_color=np.array([0], np.int64), w_limbs=np.ones((1, 1), np.int8),
        pair_keys=np.array([0], np.int64), pair_off=np.array([0, 1], np.int64),
        ent_sega=np.array([0], np.int64), ent_segb=np.array([0], np.int64),
        max_weight_sum=4,
    )
    plan = ttp.PanelPlan(**fields)
    # bit-position space too large for int32 -> host pack
    assert ttp._postings_keys(plan, 0, np.array([0]), panel_pad=2**20,
                              n_blocks=2**10, block=2**10) is None
    # a duplicate (color, member) posting breaks strict increase -> host pack
    dup = ttp.PanelPlan(**dict(fields, mem_s=np.array([0, 1, 1, 2], np.int32)))
    assert ttp._postings_keys(dup, 0, np.array([0]), 128, 1, 128) is None
    jdup = jtp.PanelPlan(**dict(fields, mem_s=np.array([0, 1, 1, 2], np.int32)))
    assert jtp._postings_keys(jdup, 0, np.array([0]), 128, 1, 128) is None
    keys = ttp._postings_keys(plan, 0, np.array([0]), 128, 1, 128)
    assert np.array_equal(keys[:4], np.arange(4)) and (keys[4:] >= 128).all()


# ---- per-chunk limb accumulators vs the Pallas kernels --------------------


def test_chunk_accumulators_match_pallas_tri_and_rect():
    o, m, w = csr(9)
    jplan, tplan = both_plans(o, m, w, 700, 256)
    panel_pad, n_limbs = 256, tplan.n_limbs
    assert n_limbs == 3
    keys = tplan.pair_keys.tolist()
    diag = keys.index(1 * tplan.n_panels + 1)
    off = keys.index(0 * tplan.n_panels + 2)
    for p, is_diag in ((diag, True), (off, False)):
        pk = keys[p]
        pi, pj = pk // tplan.n_panels, pk % tplan.n_panels
        e0, e1 = tplan.pair_off[p], tplan.pair_off[p + 1]
        sa, sb = tplan.ent_sega[e0:e1], tplan.ent_segb[e0:e1]
        nb = -(-len(sa) // BLOCK)
        bits_a = ttp._pack_panel_side(tplan, pi, sa, nb, BLOCK, panel_pad)
        bits_b = ttp._pack_panel_side(tplan, pj, sb, nb, BLOCK, panel_pad)
        wl = ttp._pad_limbs(tplan.w_limbs[tplan.seg_color[sa]], nb, BLOCK)
        ta = torch.from_numpy(bits_a)
        tb = ta if is_diag else torch.from_numpy(bits_b)
        got = ttp._chunk_acc(ta, tb, torch.from_numpy(wl), is_diag,
                             panel_pad).numpy()
        if is_diag:
            ti, tj = cp.upper_triangle_tiles(panel_pad // TILE)
            want = np.asarray(jpp.cooccurrence_pallas_tri(
                bits_a, wl, ti, tj, BLOCK, panel_pad, n_limbs, tile=TILE,
                interpret=True))
            for i, j in zip(ti, tj):
                blk = np.s_[:, i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE]
                assert np.array_equal(got[blk], want[blk])
        else:
            want = np.asarray(jpp.cooccurrence_pallas_rect(
                bits_a, bits_b, wl, BLOCK, panel_pad, panel_pad, n_limbs,
                tile=TILE, interpret=True))
            assert np.array_equal(got, want)
        assert got.any()


# ---- yielded streams --------------------------------------------------------


@pytest.mark.parametrize("engine,panel,min_shared", [
    ("pallas", 256, 1),
    ("xla", 128, 1),
    ("xla", 300, 60000),
])
def test_iter_panel_pairs_matches_jax(engine, panel, min_shared):
    o, m, w = csr(panel)
    jplan, tplan = both_plans(o, m, w, 700, panel)
    got = assert_same_stream(
        jtp.iter_panel_pairs(jplan, engine=engine, block=BLOCK, tile=TILE,
                             min_shared=min_shared,
                             interpret=True if engine == "pallas" else None),
        ttp.iter_panel_pairs(tplan, device="cpu", block=BLOCK,
                             min_shared=min_shared),
    )
    assert any(g[0] == g[1] for g in got) and any(g[0] != g[1] for g in got)
    assert all((g[4] >= max(1, min_shared)).all() for g in got)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_iter_panel_pairs_big_weights_match_jax(engine):
    o, m, w = csr(17, n_colors=60, max_weight=50)
    w = w * (1 << 27)
    jplan, tplan = both_plans(o, m, w, 700, 256)
    assert tplan.max_weight_sum >= 2**31
    got = assert_same_stream(
        jtp.iter_panel_pairs(jplan, engine=engine, block=BLOCK, tile=TILE,
                             interpret=True if engine == "pallas" else None),
        ttp.iter_panel_pairs(tplan, device="cpu", block=BLOCK),
    )
    assert max(int(g[4].max()) for g in got) >= 2**31


def test_iter_panel_pairs_big_weights_multichunk_match_jax(monkeypatch):
    """Pairs spanning several super-block chunks: JAX accumulates them in a
    host int64 tile, the port adds each chunk's limbs into its int64 device
    tile."""
    monkeypatch.setattr(jpw, "_MAX_COLORS_PER_CALL", 256)
    monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 256)
    o, m, w = random_csr(np.random.default_rng(23), 600, 100, max_degree=6,
                         max_weight=30)
    w = w * (1 << 23)
    jplan, tplan = both_plans(o, m, w, 100, 256)
    assert tplan.max_weight_sum >= 2**31 and len(tplan.ent_sega) > 256
    assert_same_stream(
        jtp.iter_panel_pairs(jplan, engine="xla", block=BLOCK, tile=TILE),
        ttp.iter_panel_pairs(tplan, device="cpu", block=BLOCK),
    )


# ---- streamed TSV --------------------------------------------------------------


def _tsv(prefix):
    with open(prefix + "_kSpider_pairwise.tsv", "rb") as f:
        return f.read()


def test_stream_tsv_matches_jax_and_dense(tmp_path):
    rng = np.random.default_rng(31)
    n = 700
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=30000)
    idx = _FakeIndex(o, m, w, n, rng.integers(1, 100000, size=n))
    jax_prefix = str(tmp_path / "jax")
    n_jax = jtp.stream_pairwise_tsv(idx, jax_prefix, panel=256, engine="xla",
                                    block=BLOCK)
    port_prefix = str(tmp_path / "port")
    stats = {}
    n_port = ttp.stream_pairwise_tsv(idx, port_prefix, device="cpu", panel=256,
                                     block=BLOCK, stats=stats)
    dense_prefix = str(tmp_path / "dense")
    tpairwise.write_pairwise_tsv(
        dense_prefix, idx, tpw.shared_kmer_matrix(o, m, w, n, device="cpu",
                                                  block=BLOCK))
    assert n_port == n_jax > 0
    assert _tsv(port_prefix) == _tsv(jax_prefix) == _tsv(dense_prefix)
    assert stats["t_tsv"] >= 0
    assert stats["bits_sides"] + stats["keys_sides"] > 0


def test_stream_tsv_empty_is_header_only(tmp_path):
    o, m = np.arange(6, dtype=np.int64), np.arange(5, dtype=np.int64)
    idx = _FakeIndex(o, m, np.ones(5, np.int64), 5, np.ones(5, np.int64))
    jtp.stream_pairwise_tsv(idx, str(tmp_path / "jax"), panel=256, engine="xla")
    assert ttp.stream_pairwise_tsv(idx, str(tmp_path / "port"), device="cpu",
                                   panel=256) == 0
    assert _tsv(str(tmp_path / "port")) == _tsv(str(tmp_path / "jax"))
    assert _tsv(str(tmp_path / "port")).count(b"\n") == 1


def test_stream_and_from_index_ship_sides_alike(tmp_path, monkeypatch):
    """``pairwise`` on the tiled engine (``stream_pairwise_tsv``) and
    ``cluster --from-index`` (``iter_panel_pairs`` straight) ship every side
    of one plan in the same form: posting keys or host-packed bits, by
    ``bitmask.prefer_keys`` alone."""
    # a ratio at which auto ships some sides as keys and some as bits
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", "3")
    rng = np.random.default_rng(37)
    n = 1100
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=40000)
    idx = _FakeIndex(o, m, w, n, rng.integers(1, 100000, size=n))
    plan = ttp.build_panel_plan(o, m, w, n, 256)
    streamed, direct = {}, {}
    ttp.stream_pairwise_tsv(idx, str(tmp_path / "port"), device="cpu",
                            panel=256, block=BLOCK, plan=plan, stats=streamed,
                            device_pack="auto")
    for _ in ttp.iter_panel_pairs(plan, device="cpu", block=BLOCK,
                                  stats=direct, device_pack="auto"):
        pass
    forms = ("keys_sides", "bits_sides", "keys_bytes", "bits_bytes")
    assert {k: streamed[k] for k in forms} == {k: direct[k] for k in forms}
    assert direct["keys_sides"] > 0 and direct["bits_sides"] > 0
    # off-diagonal pairs as well as diagonal ones
    pi, pj = divmod(plan.pair_keys, plan.n_panels)
    assert (pi != pj).any()


def _family_index(seed, n_families=12, per_family=8):
    """Seeded families: members share most of a family core, plus a few
    hashes shared across families."""
    from kspider_tpu.core.index import build_index_from_hash_sets

    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**62, size=60000, dtype=np.uint64))
    rng.shuffle(pool)
    cross = pool[:300]
    names, arrays = [], []
    for f in range(n_families):
        core = pool[300 + 3000 * f: 300 + 3000 * f + 2000]
        for i in range(per_family):
            own = pool[300 + 3000 * f + 2000 + 100 * i:][:100]
            names.append(f"f{f:02d}_s{i}")
            arrays.append(np.unique(np.concatenate([
                core[rng.random(len(core)) < rng.uniform(0.5, 0.95)], own,
                cross[rng.random(len(cross)) < 0.05]])))
    return build_index_from_hash_sets(names, arrays, ksize=21,
                                      params="kSize:21")


def test_stream_tsv_plan_reuse_and_mismatch(tmp_path):
    index = _family_index(37)
    plan = ttp.build_panel_plan(index.color_offsets, index.color_members,
                                index.color_counts, index.num_groups, 32)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttp.stream_pairwise_tsv(index, a, device="cpu", panel=32, block=BLOCK)
    ttp.stream_pairwise_tsv(index, b, device="cpu", panel=32, block=BLOCK,
                            plan=plan)
    assert _tsv(a) == _tsv(b)
    with pytest.raises(ValueError, match="panel=32"):
        ttp.stream_pairwise_tsv(index, b, device="cpu", panel=64, plan=plan)
    for other in (_family_index(41, n_families=11), _family_index(43)):
        other_plan = ttp.build_panel_plan(
            other.color_offsets, other.color_members, other.color_counts,
            other.num_groups, 32)
        with pytest.raises(ValueError, match="different index"):
            ttp.stream_pairwise_tsv(index, b, device="cpu", panel=32,
                                    plan=other_plan)


# ---- cluster --from-index ----------------------------------------------------


def _cluster_both(index, prefix_dir, cutoff, dist_type, panel, device):
    os.makedirs(prefix_dir, exist_ok=True)
    jax_out = jcluster.cluster_from_index(
        index, os.path.join(prefix_dir, "jax"), cutoff, dist_type=dist_type,
        use_tpu=device is not None, panel=panel)
    port_out = tcluster.cluster_from_index(
        index, os.path.join(prefix_dir, "port"), cutoff, dist_type=dist_type,
        device=device, panel=panel)
    assert filecmp.cmp(jax_out, port_out, shallow=False)
    with open(port_out) as f:
        return [line.strip().split(",") for line in f]


@pytest.mark.parametrize("dist_type,device", [("max_cont", "cpu"),
                                              ("min_cont", None)])
def test_cluster_from_index_matches_jax_on_families(tmp_path, dist_type, device):
    index = _family_index(47)
    clusters = _cluster_both(index, str(tmp_path), 0.3, dist_type, 32, device)
    assert len(clusters) == 12
    assert all(len({s.split("_")[0] for s in c}) == 1 for c in clusters)


def test_cluster_from_index_matches_jax_on_sigs(sig_collection, tmp_path):
    from kspider_tpu.core import dataset

    sigs_dir, _, ksize = sig_collection
    index = dataset.index_sigs_dir(sigs_dir, ksize,
                                   output_prefix=str(tmp_path / "sigs"))
    clusters = _cluster_both(index, str(tmp_path), 0.55, "avg_cont", 8, "cpu")
    assert len(clusters) >= 4


def test_cluster_from_index_refuses_ani(tmp_path, capsys):
    index = _FakeIndex(*csr(1), 700, None)
    # Logger.ERROR exits 1, as in kspider_tpu
    with pytest.raises(SystemExit):
        jcluster.cluster_from_index(index, str(tmp_path / "j"), 0.5, "ani")
    with pytest.raises(SystemExit):
        tcluster.cluster_from_index(index, str(tmp_path / "t"), 0.5, "ani",
                                    device="cpu")
    assert capsys.readouterr().err.count("does not support the ani") == 2


# ---- several devices -----------------------------------------------------------


@pytest.mark.parametrize("panel", [64, 128, 300])
def test_panel_row_work_and_filter_plan_rows_match_jax(panel):
    o, m, w = csr(panel + 1)
    jplan, tplan = both_plans(o, m, w, 700, panel)
    work = ttp.panel_row_work(tplan)
    assert work.dtype == np.int64
    assert np.array_equal(work, jtp.panel_row_work(jplan))
    rows_seen = []
    for rows in (np.arange(0, tplan.n_panels, 2), [1], [tplan.n_panels - 1, 0]):
        want = jtp.filter_plan_rows(jplan, rows)
        got = ttp.filter_plan_rows(tplan, rows)
        for field in PLAN_FIELDS:
            a, b = getattr(want, field), getattr(got, field)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field
            else:
                assert a == b, field
        rows_seen.extend(got.pair_keys.tolist())
    odd = ttp.filter_plan_rows(tplan, np.arange(1, tplan.n_panels, 2))
    even = ttp.filter_plan_rows(tplan, np.arange(0, tplan.n_panels, 2))
    assert sorted(odd.pair_keys.tolist() + even.pair_keys.tolist()) == \
        tplan.pair_keys.tolist()
    assert int(odd.pair_off[-1] + even.pair_off[-1]) == int(tplan.pair_off[-1])


@pytest.mark.parametrize("panel,devices,pair_parallel", [
    (128, ["cpu", "cpu"], True),    # 21 pairs >= 2 per device: round-robin
    (128, ["cpu"] * 3, True),
    (512, ["cpu", "cpu"], False),   # 3 pairs: each pair's blocks split
    (256, "cpu,cpu,cpu,cpu", False),
])
def test_stream_tsv_on_a_device_list_matches_jax(tmp_path, panel, devices,
                                                 pair_parallel):
    """kspider_tpu's stream on its 8-device CPU mesh (pair-parallel or
    mesh-sharded by its own rule) and the port's on a list of CPU devices
    write the same TSV bytes as the one-device stream."""
    rng = np.random.default_rng(53)
    n = 700
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=30000)
    idx = _FakeIndex(o, m, w, n, rng.integers(1, 100000, size=n))
    jax_prefix = str(tmp_path / "jax")
    jtp.stream_pairwise_tsv(idx, jax_prefix, panel=panel, engine="auto",
                            block=BLOCK)
    one_prefix = str(tmp_path / "one")
    ttp.stream_pairwise_tsv(idx, one_prefix, device="cpu", panel=panel,
                            block=BLOCK)
    port_prefix = str(tmp_path / "port")
    stats = {}
    rows = ttp.stream_pairwise_tsv(idx, port_prefix, device=devices,
                                   panel=panel, block=BLOCK, stats=stats)
    assert rows > 0
    assert stats["pair_parallel"] == pair_parallel
    assert stats["devices"] == len(ttp.make_mesh(devices))
    assert _tsv(port_prefix) == _tsv(jax_prefix) == _tsv(one_prefix)


@pytest.mark.parametrize("big", [False, True])
def test_iter_panel_pairs_sharded_matches_jax_mesh(big):
    """Per-pair sharding against kspider_tpu's ``mesh=`` engine, also with
    weights whose sums pass 2**31: panels of 512 give 3 pairs, fewer than
    two per device, so each pair's color blocks are split."""
    from kspider_tpu.parallel.mesh import make_mesh

    o, m, w = csr(59, n_colors=300 if big else 500,
                  max_weight=50 if big else 40000)
    if big:
        w = w * (1 << 27)
    jplan, tplan = both_plans(o, m, w, 700, 512)
    assert (tplan.max_weight_sum >= 2**31) == big
    assert len(tplan.pair_keys) == 3
    calls = []
    real = cp.cooccurrence_tiles

    def spy(bits_i, *a, **k):
        calls.append(bits_i.shape[0])
        return real(bits_i, *a, **k)

    stats = {}
    try:
        cp.cooccurrence_tiles = spy
        got = assert_same_stream(
            jtp.iter_panel_pairs(jplan, block=BLOCK, tile=TILE,
                                 mesh=make_mesh(2)),
            ttp.iter_panel_pairs(tplan, device=["cpu", "cpu"], block=BLOCK,
                                 stats=stats),
        )
    finally:
        cp.cooccurrence_tiles = real
    assert not stats["pair_parallel"]
    # two launches per chunk, one per device, each on half the blocks
    assert len(calls) % 2 == 0 and len(calls) >= 2 * len(got)
    assert any(g[0] == g[1] for g in got) and any(g[0] != g[1] for g in got)


def test_cluster_from_index_on_a_device_list_matches_jax(tmp_path):
    index = _family_index(61)
    clusters = _cluster_both(index, str(tmp_path), 0.3, "max_cont", 16,
                             ["cpu", "cpu"])
    assert len(clusters) == 12
