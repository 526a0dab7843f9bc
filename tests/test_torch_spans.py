"""The ``kspider.*`` ranges of each stage's host steps, on the CPU.

Each stage runs through the port's CLI under a CPU ``torch.profiler`` (as
the benchmark traces it: the default setting, which records the ranges of
the thread that started the profiler): ``pairwise`` on the dense engine,
``cluster`` from its TSV in several chunks, and ``cluster --from-index`` at
panels of 4 (25 groups: 7 panels, diagonal and off-diagonal pairs) with a
fold after every pair that keeps an edge.  Checked per stage: its ranges
open on the stage's thread, they nest, no range is held across a
generator's ``yield`` (no consumer range overlaps a producer range), and
the output files are the unprofiled run's bytes.
"""

import functools
import json
import os
import re
import shutil

import pytest
from click.testing import CliRunner
from torch.profiler import ProfilerActivity, profile, record_function

from kspider_tpu_torch.cli.main import cli
from kspider_tpu_torch.core import cluster as core_cluster
from kspider_tpu_torch.utils import timing

PANEL = 4
STAGE_RANGE = "test.stage"
INDEX = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
         "_color_count.bin", ".namesMap", ".extra")
#: each stage's command line after ``-i PREFIX``, and the ranges it opens
STAGES = {
    "pairwise": (["pairwise", "--device", "cpu"],
                 {"kspider.load", "kspider.counts", "kspider.matrix",
                  "kspider.tsv", "kspider.prepare", "kspider.pack", "kspider.gram",
                  "kspider.recombine"}),
    "cluster": (["cluster", "-c", "0.3", "--device", "cpu"],
                {"kspider.load", "kspider.tsv_read", "kspider.cc",
                 "kspider.clusters"}),
    "from-index": (["cluster", "-c", "0.3", "--device", "cpu", "--from-index",
                    "--panel", str(PANEL)],
                   {"kspider.load", "kspider.plan", "kspider.pack_wait",
                    "kspider.dispatch", "kspider.extract", "kspider.containment",
                    "kspider.cc", "kspider.clusters"}),
}
#: (consumer, producer) range names that may never overlap in time
APART = [("kspider.containment", "kspider.pack_wait"),
         ("kspider.containment", "kspider.dispatch"),
         ("kspider.containment", "kspider.extract"),
         ("kspider.tsv_read", "kspider.cc")]


def outputs(prefix):
    """The stage outputs beside ``prefix``: file name -> bytes."""
    folder, base = os.path.split(prefix)
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith(base + "_kSpider_"):
            with open(os.path.join(folder, name), "rb") as f:
                out[name] = f.read()
    return out


def invoke(argv):
    result = CliRunner().invoke(cli, argv, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result


@pytest.fixture(scope="module")
def index_prefix(sig_collection, tmp_path_factory):
    sigs_dir, _, ksize = sig_collection
    prefix = str(tmp_path_factory.mktemp("spans_index") / "sigs")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(timing.PROFILE_ENV, raising=False)
        invoke(["index", "--sourmash", "--dir", sigs_dir, "-k", str(ksize),
                "-o", prefix])
    return prefix


@pytest.fixture(scope="module")
def runs(index_prefix, tmp_path_factory):
    """Per stage: the outputs of an unprofiled and of a profiled run, the
    profiled run's ranges, and the id of the thread that ran it."""
    root = tmp_path_factory.mktemp("spans")
    cache = {}

    def get(stage):
        if stage in cache:
            return cache[stage]
        argv, _ = STAGES[stage]
        got = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv(timing.PROFILE_ENV, raising=False)
            # several TSV chunks, and a fold after every pair that keeps one
            mp.setattr(core_cluster, "cluster_index", functools.partial(
                core_cluster.cluster_index, chunk_rows=40))
            mp.setattr(core_cluster, "cluster_from_index", functools.partial(
                core_cluster.cluster_from_index, edge_batch=1))
            for tag in ("plain", "profiled"):
                prefix = str(root / stage / tag / "sigs")
                os.makedirs(os.path.dirname(prefix))
                for suffix in INDEX:
                    shutil.copy(index_prefix + suffix, prefix + suffix)
                if stage == "cluster":
                    invoke(["pairwise", "-i", prefix, "--device", "cpu"])
                before = set(outputs(prefix))
                if tag == "plain":
                    invoke([argv[0], "-i", prefix] + argv[1:])
                else:
                    with profile(activities=[ProfilerActivity.CPU]) as prof:
                        with record_function(STAGE_RANGE):
                            invoke([argv[0], "-i", prefix] + argv[1:])
                    trace = str(root / stage / "trace.json")
                    prof.export_chrome_trace(trace)
                    got["events"] = [e for e in load(trace)
                                     if e.get("cat") == "user_annotation"]
                got[tag] = {k: v for k, v in outputs(prefix).items()
                            if k not in before}
        stage_tid = [e["tid"] for e in got["events"] if e["name"] == STAGE_RANGE]
        assert len(stage_tid) == 1
        got["tid"] = stage_tid[0]
        cache[stage] = got
        return got

    return get


def load(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def span_ns(e):
    """A range's ``[start, end)`` in integer nanoseconds."""
    lo = round(e["ts"] * 1000)
    return lo, lo + round(e["dur"] * 1000)


def nests(ranges):
    """True when any two of ``ranges`` are disjoint or one holds the other."""
    ends = []
    for lo, hi in sorted((span_ns(e) for e in ranges),
                         key=lambda s: (s[0], -s[1])):
        while ends and ends[-1] <= lo:
            ends.pop()
        if ends and hi > ends[-1]:
            return False
        ends.append(hi)
    return True


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_ranges_open_on_the_stage_thread(runs, stage):
    got = runs(stage)
    on_stage = {e["name"] for e in got["events"] if e["tid"] == got["tid"]}
    want = STAGES[stage][1]
    assert want <= on_stage, want - on_stage


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_ranges_nest(runs, stage):
    got = runs(stage)
    mine = [e for e in got["events"] if e["tid"] == got["tid"]]
    assert len(mine) > len(STAGES[stage][1])
    assert nests(mine)


def test_nests_refuses_overlap():
    def r(ts, dur):
        return {"ts": ts, "dur": dur}

    assert nests([r(0, 10), r(2, 3), r(5, 5), r(10, 1)])
    assert not nests([r(0, 10), r(5, 6)])


@pytest.mark.parametrize("stage", list(STAGES))
def test_no_range_is_held_across_a_yield(runs, stage):
    got = runs(stage)
    by_name = {}
    for e in got["events"]:
        by_name.setdefault(e["name"], []).append(span_ns(e))
    for consumer, producer in APART:
        for a0, a1 in by_name.get(consumer, []):
            for b0, b1 in by_name.get(producer, []):
                assert min(a1, b1) <= max(a0, b0), (consumer, producer)
    if stage == "cluster":
        assert len(by_name["kspider.tsv_read"]) > 2
        assert len(by_name["kspider.cc"]) > 2
    if stage == "from-index":
        assert len(by_name["kspider.containment"]) > 2
        assert len(by_name["kspider.cc"]) > 2


@pytest.mark.parametrize("stage", list(STAGES))
def test_profiled_outputs_are_the_unprofiled_bytes(runs, stage):
    got = runs(stage)
    assert got["plain"] and got["plain"] == got["profiled"]


SECS = re.compile(r"^(.*): [0-9.e+-]+ secs$")


def test_pairwise_prints_the_reference_timer_lines(index_prefix, tmp_path,
                                                   monkeypatch):
    """The four timers' lines, in order, with seconds in ``%.6g``."""
    monkeypatch.delenv(timing.PROFILE_ENV, raising=False)
    prefix = str(tmp_path / "sigs")
    for suffix in INDEX:
        shutil.copy(index_prefix + suffix, prefix + suffix)
    lines = invoke(["pairwise", "-i", prefix, "--device", "cpu"]).stdout.splitlines()
    labels = [SECS.sub(r"\1", ln) for ln in lines]
    assert labels == ["mapping colors to groups", "kmer counting",
                      "pairwise matrix construction",
                      f"writing pairwise matrix to {prefix}_kSpider_pairwise.tsv",
                      "pairwise TSV written"]
    assert sum(bool(SECS.match(ln)) for ln in lines) == 4
