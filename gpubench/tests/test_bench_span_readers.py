"""The readers of the program's host-step ranges on a small recorded trace,
read by hand: two pipeline jobs, the first ``cluster`` reading the TSV back
(two chunks, two folds), the second clustering from the index."""

import json

import pytest

from gpubench import run
from gpubench import trace as tr


def ev(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


EVENTS = [
    ev("window", 0, 20000),
    ev("gpubench.pairwise", 100, 4000), ev("gpubench.cluster", 4200, 1000),
    ev("gpubench.pairwise", 6000, 3000), ev("gpubench.cluster", 9100, 800),
    # pairwise: the dense writer
    ev("kspider.tsv", 1000, 2500), ev("kspider.tsv", 7000, 1800),
    # cluster from the TSV
    ev("kspider.load", 4210, 10),
    ev("kspider.tsv_read", 4230, 300), ev("kspider.cc", 4540, 20),
    ev("kspider.tsv_read", 4570, 200), ev("kspider.cc", 4780, 30),
    ev("kspider.clusters", 4820, 50),
    # cluster from the index
    ev("kspider.load", 9110, 40), ev("kspider.plan", 9160, 60),
    ev("kspider.pack_wait", 9230, 100), ev("kspider.containment", 9340, 70),
    ev("kspider.pack_wait", 9420, 50), ev("kspider.containment", 9480, 80),
    ev("kspider.cc", 9570, 25), ev("kspider.clusters", 9600, 90),
    # ranges that start outside every stage: never counted
    ev("kspider.cc", 4150, 100), ev("kspider.tsv", 5300, 100),
    ev("kspider.pack_wait", 5900, 200),
    # the pack thread's own range on another thread: not read
    ev("kspider.pack", 9200, 300, tid=2),
    # outside the window: never read
    ev("gpubench.cluster", 25000, 500), ev("kspider.cc", 25100, 100),
]


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tr.Window(tr.load_events(str(path)), 0, 20000, {})


def read(name, window):
    bench = run.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    return run.load_metric(name, entry).read(window)


@pytest.mark.parametrize("name, want", [
    ("tsv.write_range_ms", (2500 + 1800) / 2 / 1000),
    ("tsv.read_ms", (300 + 200) / 2 / 1000),
    ("cc.fold_ms", (20 + 30 + 25) / 2 / 1000),  # two folds in the first job
    ("cluster.host_ms", (50 + 70 + 80 + 90) / 2 / 1000),
    ("index.load_ms", (10 + 40) / 2 / 1000),
    ("tiled.plan_ms", 60 / 2 / 1000),
    ("tiled.pack_wait_ms", (100 + 50) / 2 / 1000),
])
def test_span_reader(name, want, window):
    assert read(name, window) == pytest.approx(want)


@pytest.mark.parametrize("name", ["tsv.write_range_ms", "tsv.read_ms",
                                  "tiled.plan_ms", "tiled.pack_wait_ms"])
def test_span_reader_skips_the_other_stage(name):
    """A range opened in the other stage than its reader's is not read."""
    events = [ev("window", 0, 1000),
              ev("gpubench.pairwise", 0, 500), ev("kspider.tsv_read", 10, 20),
              ev("kspider.plan", 40, 20), ev("kspider.pack_wait", 70, 20),
              ev("gpubench.cluster", 600, 300), ev("kspider.tsv", 610, 20)]
    assert read(name, tr.Window(events, 0, 1000, {})) is None
