"""The panel-streamed engine's asynchronous pipeline, on the CPU.

On a CUDA device the port's ``iter_panel_pairs`` stages host arrays in a
ring of pinned buffers, copies them on a side stream, compacts each pair's
kept entries on the device and fetches them behind the pair's own event
(``ops/tiled_pairwise``: ``_HostSlots``, ``_Lane``, ``compact_kept``).  The
same functions run here on the CPU, where they must give what
``torch.nonzero`` and kspider_tpu's engine give: the compaction against
``nonzero`` plus a gather over random masks, the staging ring's layout and
reuse, the trace readers of ``utils.timing``, and the streamed TSV
bytes against kspider_tpu's ``stream_pairwise_tsv`` (XLA engine) in every
configuration the pipeline serves.  Tolerance everywhere: exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kspider_tpu.ops import pairwise as jpw
from kspider_tpu.ops import tiled_pairwise as jtp
from kspider_tpu_torch.io import native as t_native
from kspider_tpu_torch.ops import pairwise as tpw
from kspider_tpu_torch.ops import tiled_pairwise as ttp
from kspider_tpu_torch.utils import timing
from tests.test_pairwise_ops import random_csr
from tests.test_tiled_pairwise import _FakeIndex, _global_color_csr

BLOCK = 128


# ---- the device compaction ---------------------------------------------------


def _mask(kind, n, rng):
    if kind == "empty":
        return np.zeros((n, n), bool)
    if kind == "full":
        return np.ones((n, n), bool)
    if kind == "diagonal_triu":
        return np.triu(rng.random((n, n)) < 0.5, 1)
    if kind == "single":
        m = np.zeros((n, n), bool)
        m[rng.integers(n), rng.integers(n)] = True
        return m
    return rng.random((n, n)) < rng.random()


@pytest.mark.parametrize("kind", ["empty", "full", "diagonal_triu", "single",
                                  "random"])
@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 48), seed=st.integers(0, 2**32 - 1))
def test_compact_kept_equals_nonzero_and_gather(kind, n, seed):
    rng = np.random.default_rng(seed)
    total = torch.from_numpy(rng.integers(-2**62, 2**62, size=(n, n)))
    keep = torch.from_numpy(_mask(kind, n, rng))
    if kind == "diagonal_triu":
        keep = torch.triu(keep, diagonal=1)
    idx, vals, count = ttp.compact_kept(total, keep)
    want = torch.nonzero(keep.view(-1)).squeeze(1)
    c = int(count)
    assert count.shape == (1,) and c == len(want)
    assert idx.shape == vals.shape == (n * n,)
    assert torch.equal(idx[:c], want)
    assert torch.equal(vals[:c], total.view(-1)[want])


# ---- host staging ---------------------------------------------------------------


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_staging_slot_layout_growth_and_reuse(monkeypatch):
    """A pinned slot (pages made plain here) hands out 64-byte aligned,
    disjoint views; a pair that overflows its page gets a bigger one, and
    the reset that waits on the slot's copy event merges the pages."""
    pages = []

    def page(nbytes):
        pages.append(torch.zeros(nbytes, dtype=torch.uint8))
        return pages[-1]

    monkeypatch.setattr(ttp, "_pinned_page", page)
    ring = ttp._HostSlots(3, pinned=True)
    slot = ring.begin(0)
    shapes = [((5, 7), np.int8), ((3, 64, 128), np.uint8), ((1000,), np.int32),
              ((1 << 20,), np.int16), ((9,), np.uint8)]
    views = [slot.empty(*s) for s in shapes]
    sizes = [page.numel() for page in slot.pages]
    assert len(sizes) >= 2 and sizes[-1] >= 2 << 20
    assert all(b >= 2 * a and b & (b - 1) == 0 for a, b in zip(sizes, sizes[1:]))
    spans = []
    for v, (shape, dtype) in zip(views, shapes):
        assert v.shape == shape and v.dtype == dtype
        assert v.ctypes.data % ttp._ALIGN == 0
        spans.append((v.ctypes.data, v.ctypes.data + v.nbytes))
        v[...] = 1
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    staged = slot.put(np.arange(10, dtype=np.int64))
    assert np.array_equal(staged, np.arange(10))
    event = _Event()
    slot.event = event
    assert ring.begin(1) is not slot and event.waited == 0
    assert ring.begin(3) is slot and event.waited == 1 and slot.event is None
    assert len(slot.pages) == 1 and slot.pages[0].numel() >= slot_bytes(shapes)
    plain = ttp._HostSlots(2, pinned=False).begin(0)
    assert plain.put(staged) is staged and not plain.pages


def slot_bytes(shapes):
    return sum(-(-int(np.prod(s)) * np.dtype(d).itemsize // 64) * 64
               for s, d in shapes)


def test_stream_through_a_reused_staging_ring_matches_jax(monkeypatch):
    """Every host array staged in a reused ring, as on a card (pages made
    plain here): 21 pairs wrap the 6-slot ring several times, the CPU lane
    copies what it keeps, and the stream equals kspider_tpu's under every
    device pack policy."""
    monkeypatch.setattr(ttp, "_pinned_page",
                        lambda nbytes: torch.zeros(nbytes, dtype=torch.uint8))
    real = ttp._HostSlots
    monkeypatch.setattr(ttp, "_HostSlots",
                        lambda depth, pinned: real(depth, True))
    n = 700
    o, m, w = _global_color_csr(np.random.default_rng(3), n, 128, 40)
    # colors inside one panel each: diagonal pairs, and the off-diagonal
    # side selections stay those of the panel-spanning colors
    eo, em, ew = random_csr(np.random.default_rng(4), 300, 128, max_degree=10,
                            max_weight=30000)
    em = em + 128 * np.repeat(np.arange(300) % 5, np.diff(eo))
    o = np.concatenate([o, eo[1:] + o[-1]])
    m = np.concatenate([m, em])
    w = np.concatenate([w, ew])
    jplan = jtp.build_panel_plan(o, m, w, n, 128)
    tplan = ttp.build_panel_plan(o, m, w, n, 128)
    assert len(tplan.pair_keys) >= 10
    want = list(jtp.iter_panel_pairs(jplan, engine="xla", block=BLOCK,
                                     tile=128))
    for pack in ("off", "force", "auto"):
        stats = {}
        got = list(ttp.iter_panel_pairs(tplan, device="cpu", block=BLOCK,
                                        stats=stats, device_pack=pack))
        assert [(g[0], g[1]) for g in got] == [(x[0], x[1]) for x in want]
        for x, g in zip(want, got):
            for a, b in zip(x[2:], g[2:]):
                assert np.array_equal(np.asarray(a), b)
        if pack == "force":
            assert stats["keys_sides"] > 0


# ---- the trace reader -------------------------------------------------------------


def test_host_waits_counts_calls_inside_each_range_on_its_thread():
    def span(name, ts, dur, tid=1, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7, "tid": tid}

    events = [
        span("kspider.dispatch", 0, 100), span("kspider.extract", 200, 100),
        span("kspider.dispatch", 400, 100), span("kspider.tsv", 600, 50),
        span("cudaEventSynchronize", 210, 5, cat="cuda_runtime"),
        span("cudaEventSynchronize", 250, 5, cat="cuda_runtime"),
        span("cudaStreamSynchronize", 450, 5, cat="cuda_runtime"),
        # another thread, and outside every range: not counted
        span("cudaStreamSynchronize", 20, 5, tid=2, cat="cuda_runtime"),
        span("cudaDeviceSynchronize", 150, 5, cat="cuda_runtime"),
        span("cudaLaunchKernel", 30, 5, cat="cuda_runtime"),
    ]
    got = timing.host_waits(events, ("kspider.dispatch", "kspider.extract"))
    zero = dict.fromkeys(timing.HOST_WAITS, 0)
    assert got["kspider.dispatch"] == [
        zero, dict(zero, cudaStreamSynchronize=1)]
    assert got["kspider.extract"] == [dict(zero, cudaEventSynchronize=2)]


def test_pipeline_numbers_read_copies_kernels_and_their_overlap():
    def span(name, ts, dur, cat, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7, "tid": 1, "args": args}

    events = [
        span("kspider.extract", 0, 400, "user_annotation"),
        span("cudaEventSynchronize", 10, 5, "cuda_runtime"),
        span("gram_int8_wgmma_kernel", 100, 100, "kernel"),
        span("gram_int8_wgmma_kernel", 150, 100, "kernel"),
        span("other_kernel", 500, 50, "kernel"),
        span("Memcpy HtoD (Pinned -> Device)", 180, 40, "gpu_memcpy", bytes=64),
        span("Memcpy HtoD (Pageable -> Device)", 300, 20, "gpu_memcpy",
             bytes=8),
        span("Memcpy DtoH (Device -> Pinned)", 600, 10, "gpu_memcpy", bytes=4),
    ]
    assert timing.union_ms([(0, 10), (5, 10), (30, 5)]) == 0.02
    got = timing.pipeline_numbers(events, "gram_int8", ["kspider.extract"])
    assert got["busy_ms"] == (150 + 20 + 50 + 10) / 1000
    assert got["kernel_ms"] == 0.2 and got["kernel_events"] == 2
    assert got["h2d_pinned_bytes"] == 64 and got["h2d_pageable_bytes"] == 8
    assert got["h2d_ms"] == 0.06
    assert abs(got["h2d_under_kernels_ms"] - 0.04) < 1e-12
    assert got["waits"]["kspider.extract"][0]["cudaEventSynchronize"] == 1


# ---- streamed TSV bytes against kspider_tpu ---------------------------------------


def _tsv(prefix):
    with open(prefix + "_kSpider_pairwise.tsv", "rb") as f:
        return f.read()


def _no_pairs_in_panel(o, m, w, lo, hi):
    """Drop the members in [lo, hi) from every color, so that panel row
    lo // panel has no pairs at all."""
    keep = (m < lo) | (m >= hi)
    color = np.repeat(np.arange(len(o) - 1), np.diff(o))
    counts = np.bincount(color[keep], minlength=len(o) - 1)
    off = np.zeros(len(o), np.int64)
    np.cumsum(counts, out=off[1:])
    return off, m[keep], w


@pytest.mark.parametrize("case", [
    "host_packed", "posting_keys", "min_shared", "empty_panel_row",
    "global_colors", "cpu_cpu", "python_rows", "big_weights_chunks",
])
def test_stream_tsv_matches_jax(tmp_path, monkeypatch, case):
    rng = np.random.default_rng(53)
    n, panel = 700, 128
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=30000)
    kw = dict(device="cpu", panel=panel, block=BLOCK)
    jkw = dict(panel=panel, engine="xla", block=BLOCK)
    if case == "host_packed":
        kw["device_pack"] = "off"
    elif case == "posting_keys":
        kw["device_pack"] = "force"
    elif case == "min_shared":
        jkw["min_shared"] = kw["min_shared"] = 20000
    elif case == "empty_panel_row":
        o, m, w = _no_pairs_in_panel(o, m, w, panel, 2 * panel)
    elif case == "global_colors":
        o, m, w = _global_color_csr(rng, n, panel, 60)
        jkw["cache_bytes"] = 0
    elif case == "cpu_cpu":
        kw["device"] = "cpu,cpu"
    elif case == "python_rows":
        # the port's rows formatted in Python, kspider_tpu's by native/
        monkeypatch.setattr(t_native, "enabled", lambda: False)
    else:
        monkeypatch.setattr(jpw, "_MAX_COLORS_PER_CALL", 256)
        monkeypatch.setattr(tpw, "_MAX_COLORS_PER_CALL", 256)
        o, m, w = random_csr(rng, 600, 300, max_degree=6, max_weight=30)
        w = w * (1 << 23)
        n = 300
    idx = _FakeIndex(o, m, w, n, rng.integers(1, 100000, size=n))
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    n_jax = jtp.stream_pairwise_tsv(idx, jax_prefix, **jkw)
    stats = {}
    n_port = ttp.stream_pairwise_tsv(idx, port_prefix, stats=stats, **kw)
    assert n_port == n_jax > 0
    assert _tsv(port_prefix) == _tsv(jax_prefix)
    plan = ttp.build_panel_plan(o, m, w, n, panel)
    rows = set((plan.pair_keys // plan.n_panels).tolist())
    if case == "host_packed":
        assert stats["bits_sides"] > 0 and stats["keys_sides"] == 0
    elif case == "posting_keys":
        assert stats["keys_sides"] > 0
    elif case == "min_shared":
        assert n_port < ttp.stream_pairwise_tsv(idx, str(tmp_path / "all"),
                                                device="cpu", panel=panel,
                                                block=BLOCK)
    elif case == "empty_panel_row":
        assert 1 not in rows and {0, 2} <= rows
    elif case == "global_colors":
        # one member of each color in every panel: every off-diagonal panel
        # pair has work, no diagonal one
        pi, pj = divmod(plan.pair_keys, plan.n_panels)
        assert (pi < pj).all()
        assert len(plan.pair_keys) == plan.n_panels * (plan.n_panels - 1) // 2
    elif case == "cpu_cpu":
        assert stats["devices"] == 2 and stats["pair_parallel"]
    elif case == "python_rows":
        assert len(rows) > 1  # header, then rows appended row by row
    else:
        assert plan.max_weight_sum >= 2**31
        assert int(np.diff(plan.pair_off).max()) > 256
