"""Each per-layer metric reader on a small recorded trace, read by hand."""

import json
import os

import pytest

from gpubench import roofline, run
from gpubench import trace as tr

CARD = "NVIDIA H100 80GB HBM3"


def ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    ev("window", 0, 10000),
    # two pipeline jobs: pairwise then cluster
    ev("gpubench.pairwise", 100, 4000), ev("gpubench.cluster", 4200, 800),
    ev("gpubench.pairwise", 5100, 4000), ev("gpubench.cluster", 9200, 700),
    ev("kspider.pack", 200, 50), ev("kspider.gram", 260, 10),
    ev("kspider.recombine", 280, 400),
    ev("kspider.pack", 5200, 50), ev("kspider.recombine", 5300, 500),
    ev("kspider.dispatch", 4300, 100), ev("kspider.extract", 4450, 50),
    ev("kspider.dispatch", 9300, 120),
    ev("void (anonymous namespace)::gram_int8_wgmma_kernel<true>(gram::Args)",
       300, 100, "kernel", 7),
    ev("void (anonymous namespace)::gram_int8_wgmma_kernel<true>(gram::Args)",
       5400, 100, "kernel", 7),
    ev("Memcpy DtoH (Device -> Pageable)", 600, 80, "gpu_memcpy", 7),
    ev("Memcpy DtoH (Device -> Pageable)", 5700, 80, "gpu_memcpy", 7),
    ev("void (anonymous namespace)::gram_int8_wgmma_kernel<false>(gram::Args)",
       4600, 40, "kernel", 7),
    ev("void (anonymous namespace)::gram_int8_wgmma_kernel<false>(gram::Args)",
       9600, 60, "kernel", 7),
    ev("scatter_kernel", 4500, 50, "kernel", 7),
    ev("scatter_kernel", 9500, 50, "kernel", 7),
    # outside the window: never read
    ev("gpubench.pairwise", 20000, 50),
    ev("void (anonymous namespace)::gram_int8_wgmma_kernel<true>(gram::Args)",
       20010, 30, "kernel", 7),
]


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS + [{"ph": "M", "name": "meta"}]}))
    peak = roofline.PEAKS[CARD]["int8_ops"]
    context = {"kind": CARD,
               "work": {"pairwise": roofline.Work(ops=peak * 50e-6, bytes=0.0),
                        "cluster": roofline.Work(ops=peak * 25e-6, bytes=0.0)}}
    return tr.Window(tr.load_events(str(path)), 0, 10000, context)


def read(name, window):
    bench = run.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    return run.load_metric(name, entry).read(window)


@pytest.mark.parametrize("name, want", [
    ("gram_roofline.pairwise", 50.0),  # 50 us least time, 100 us of kernel a job
    ("gram_roofline.cluster", 50.0),  # 25 us least time, (40 + 60) / 2 us
    ("device.idle.pairwise", 100.0 * (1 - 360 / 8000)),
    ("device.idle.cluster", 100.0 * (1 - (90 + 110) / 1500)),
    ("dense.construct_ms", (480 + 600) / 2 / 1000),
    ("tsv.write_ms", (3420 + 3300) / 2 / 1000),
    ("tiled.host_ms", (100 + 50 + 120) / 2 / 1000),
])
def test_reader(name, want, window):
    assert read(name, window) == pytest.approx(want)


def test_every_per_layer_metric_has_a_reader():
    bench = run.load_benchmark()
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics", m["name"] + ".py"))
        run.load_metric(m["name"], m)


def test_readers_find_nothing_in_an_empty_trace():
    empty = tr.Window([ev("window", 0, 100)], 0, 100, {})
    bench = run.load_benchmark()
    for m in bench["per_layer"]:
        assert run.load_metric(m["name"], m).read(empty) is None


def test_breakdown(window):
    ops = dict(tr.device_ops(window))
    assert ops["scatter_kernel"] == pytest.approx(100e-6)
    assert len(ops) == 4
    gaps = dict(tr.idle_gaps(window))
    assert sum(gaps.values()) == pytest.approx((10000 - window.busy_ms() * 1000) / 1e6)
    assert gaps["gpubench.pairwise"] > gaps["kspider.recombine"]


def test_innermost_ranges():
    marks = [ev("w", 0, 100), ev("a", 10, 50), ev("b", 20, 10), ev("c", 70, 10)]
    assert tr.innermost(marks) == [(0, 10, "w"), (10, 20, "a"), (20, 30, "b"),
                                   (30, 60, "a"), (60, 70, "w"), (70, 80, "c"),
                                   (80, 100, "w")]
