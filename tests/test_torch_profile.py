"""``KSPIDER_PROFILE``: kspider_tpu_torch's ``torch.profiler`` hook against
kspider_tpu's ``jax.profiler`` one, on the CPU.

With the variable set the port writes one Chrome trace per pairwise stage
(``utils.timing.profile_trace``), on the dense and the tiled engine, and
its TSV bytes stay kspider_tpu's unprofiled bytes on the same index.  A
nested ``profile_trace`` is a no-op, so the tiled stage (``run_pairwise``
around ``stream_pairwise_tsv``) traces once where kspider_tpu, whose two
``jax.profiler.trace`` calls nest, raises.  Tolerance: exact bytes.
"""

import glob
import json
import os
import shutil
import socket

import pytest
import torch
from click.testing import CliRunner
from torch.profiler import ProfilerActivity, record_function

from kspider_tpu.cli.main import cli as jcli
from kspider_tpu.core import pairwise as jpairwise
from kspider_tpu_torch.cli.main import cli
from kspider_tpu_torch.core import pairwise as tpairwise
from kspider_tpu_torch.io import artifacts
from kspider_tpu_torch.ops import tiled_pairwise as ttp
from kspider_tpu_torch.utils import timing

PANEL = 4  # 25 groups: 7 panels, diagonal and off-diagonal pairs
TSV = "_kSpider_pairwise.tsv"
INDEX = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
         "_color_count.bin", ".namesMap", ".extra")
#: the ranges each engine opens on the thread that runs the stage (the
#: tiled engine's ``kspider.pack`` is opened on its pack thread)
DENSE_RANGES = {"kspider.pack", "kspider.gram", "kspider.recombine"}
TILED_RANGES = {"kspider.pack_wait", "kspider.dispatch", "kspider.extract",
                "kspider.tsv"}


def copy_index(src_prefix, dst_prefix):
    os.makedirs(os.path.dirname(dst_prefix), exist_ok=True)
    for suffix in INDEX:
        shutil.copy(src_prefix + suffix, dst_prefix + suffix)


@pytest.fixture(scope="module")
def refs(sig_collection, tmp_path_factory):
    """The port-built index and kspider_tpu's unprofiled TSVs on copies of
    it: dense (``run_pairwise``) and tiled at ``PANEL``."""
    sigs_dir, _, ksize = sig_collection
    root = tmp_path_factory.mktemp("torch_profile")
    index = str(root / "port" / "sigs")
    os.makedirs(os.path.dirname(index))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(timing.PROFILE_ENV, raising=False)
        result = CliRunner().invoke(cli, ["index", "--sourmash", "--dir", sigs_dir,
                                          "-k", str(ksize), "-o", index],
                                    catch_exceptions=False)
        assert result.exit_code == 0, result.output
        out = {"index": index}
        for engine in ("auto", "tiled"):
            prefix = str(root / engine / "sigs")
            copy_index(index, prefix)
            jpairwise.run_pairwise(prefix, use_tpu=False, engine=engine,
                                   panel=PANEL, echo_timers=False)
            out[engine] = prefix + TSV
    return out


def profiling():
    """Whether a ``torch.profiler`` session is running in this process
    (``torch.autograd._profiler_enabled`` reads only the calling thread's
    state, which an all-threads session leaves unset)."""
    return torch.autograd.profiler._is_profiler_enabled


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def one_trace(prof_dir, stage="pairwise"):
    """The one trace in ``prof_dir``: its path and its event names."""
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    assert len(traces) == 1, traces
    assert os.listdir(prof_dir) == [os.path.basename(traces[0])]
    assert os.path.basename(traces[0]).startswith(
        f"kspider_{stage}.{socket.gethostname()}.{os.getpid()}.")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    return traces[0], {e.get("name") for e in events}


@pytest.mark.parametrize("engine,device,ranges", [
    ("auto", "cpu", DENSE_RANGES),
    ("tiled", "cpu", TILED_RANGES),
    ("auto", None, set()),  # --cpu: the numpy engine, no torch range
    ("tiled", None, TILED_RANGES),
])
def test_profiled_run_pairwise_matches_jax(refs, engine, device, ranges,
                                           monkeypatch, tmp_path):
    """(a) One trace per stage, holding the engine's ranges; the TSV is
    kspider_tpu's unprofiled one."""
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    tpairwise.run_pairwise(prefix, device=device, engine=engine, panel=PANEL,
                           echo_timers=False)
    assert same_bytes(prefix + TSV, refs[engine])
    _, names = one_trace(prof)
    assert ranges <= names, names


def test_stream_pairwise_tsv_alone_writes_one_trace(refs, monkeypatch, tmp_path):
    """(b) A direct library call of the tiled engine traces itself."""
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    index = artifacts.load_index_artifacts(refs["index"])
    prefix = str(tmp_path / "sigs")
    rows = ttp.stream_pairwise_tsv(index, prefix, device="cpu", panel=PANEL)
    assert rows > 0 and same_bytes(prefix + TSV, refs["tiled"])
    _, names = one_trace(prof)
    assert TILED_RANGES <= names


def test_nested_profile_trace_opens_one_profiler(monkeypatch, tmp_path):
    """(c) The inner call neither starts a second profiler nor stops the
    outer one: what runs after it is still in the one trace."""
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    with timing.profile_trace(["cpu"]):
        with timing.profile_trace(["cpu"]):
            with record_function("kspider.inner"):
                torch.ones(4).add_(1)
        assert profiling()
        with record_function("kspider.after_inner"):
            torch.ones(4).add_(1)
    assert not profiling()
    _, names = one_trace(prof)
    assert {"kspider.inner", "kspider.after_inner"} <= names


def test_stage_that_raises_still_writes_its_trace(monkeypatch, tmp_path):
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    with pytest.raises(KeyError):
        with timing.profile_trace(["cpu"]):
            with record_function("kspider.failing"):
                raise KeyError("stage failed")
    assert not profiling()
    _, names = one_trace(prof)
    assert "kspider.failing" in names
    with timing.profile_trace(["cpu"]):  # the depth count was restored
        assert profiling()


@pytest.mark.parametrize("value", [None, ""])
def test_unset_or_empty_runs_no_profiler(refs, value, monkeypatch, tmp_path):
    """(d) No profiler, no directory, no trace."""
    if value is None:
        monkeypatch.delenv(timing.PROFILE_ENV, raising=False)
    else:
        monkeypatch.setenv(timing.PROFILE_ENV, value)
    monkeypatch.chdir(tmp_path)
    with timing.profile_trace(["cpu"]):
        assert not profiling()
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    tpairwise.run_pairwise(prefix, device="cpu", engine="tiled", panel=PANEL,
                           echo_timers=False)
    assert same_bytes(prefix + TSV, refs["tiled"])
    assert os.listdir(tmp_path) == ["run"]
    assert not glob.glob(str(tmp_path / "**" / "*.json"), recursive=True)


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``; records its activities."""
    made = []

    def __init__(self, activities, on_trace_ready, **settings):
        self.made.append(list(activities))

    def start(self):
        pass

    def stop(self):
        pass


@pytest.mark.parametrize("devices,cuda", [
    ([], False),
    (["cpu", torch.device("cpu")], False),
    ([torch.device("cpu"), "cuda:0"], True),
])
def test_cuda_activity_follows_the_stage_devices(devices, cuda, monkeypatch,
                                                 tmp_path):
    """CUDA activity is asked for when a stage device is a CUDA one, and
    only then, whether or not this machine has a card."""
    monkeypatch.setenv(timing.PROFILE_ENV, str(tmp_path / "prof"))
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.made.clear()
    with timing.profile_trace(devices):
        pass
    want = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    assert _FakeProfile.made == [want]


def test_profiled_tiled_cli_exits_0(refs, monkeypatch, tmp_path):
    """(e) ``pairwise --engine tiled`` under the variable: one trace, the
    unprofiled bytes."""
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    result = CliRunner().invoke(cli, ["pairwise", "-i", prefix, "--engine", "tiled",
                                      "--panel", str(PANEL), "--device", "cpu"],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert same_bytes(prefix + TSV, refs["tiled"])
    one_trace(prof)


def test_jax_profiled_tiled_cli_raises(refs, monkeypatch, tmp_path):
    """(e) The companion of the test above: kspider_tpu's same run opens a
    ``jax.profiler.trace`` in ``run_pairwise`` and a second one in
    ``stream_pairwise_tsv``, which JAX refuses.  The port does not copy
    this; the difference is recorded in ROADMAP.md section 3."""
    monkeypatch.setenv(timing.PROFILE_ENV, str(tmp_path / "prof"))
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    result = CliRunner().invoke(jcli, ["pairwise", "-i", prefix, "--engine", "tiled",
                                       "--panel", str(PANEL)])
    assert isinstance(result.exception, RuntimeError), result.output
    assert "Only one profile may be run at a time" in str(result.exception)


def test_pack_thread_ranges_reach_the_trace(refs, monkeypatch, tmp_path):
    """The tiled engine's ``kspider.pack`` ranges, opened on its pack
    thread, reach the stage's trace, on another thread than the
    ``kspider.dispatch`` ranges of the thread that runs the stage."""
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    tpairwise.run_pairwise(prefix, device="cpu", engine="tiled", panel=PANEL,
                           echo_timers=False)
    path, _ = one_trace(prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids = {name: {e["tid"] for e in events if e.get("name") == name
                   and e.get("cat") == "user_annotation"}
            for name in ("kspider.pack", "kspider.dispatch", "kspider.load")}
    assert tids["kspider.pack"] and tids["kspider.dispatch"] == tids["kspider.load"]
    assert not tids["kspider.pack"] & tids["kspider.dispatch"]


@pytest.mark.parametrize("options,ranges", [
    ([], {"kspider.load", "kspider.tsv_read", "kspider.cc", "kspider.clusters"}),
    (["--from-index", "--panel", str(PANEL)],
     {"kspider.load", "kspider.plan", "kspider.pack_wait", "kspider.pack",
      "kspider.containment", "kspider.cc", "kspider.clusters"}),
])
def test_profiled_cluster_writes_one_trace(refs, options, ranges, monkeypatch,
                                           tmp_path):
    """``cluster`` and ``cluster --from-index`` under the variable: one
    ``kspider_cluster`` trace each, holding the stage's ranges, and the
    clusters of an unprofiled run."""
    prefix = str(tmp_path / "run" / "sigs")
    copy_index(refs["index"], prefix)
    shutil.copy(refs["auto"], prefix + TSV)
    argv = ["cluster", "-i", prefix, "-c", "0.3", "--device", "cpu"] + options
    monkeypatch.delenv(timing.PROFILE_ENV, raising=False)
    CliRunner().invoke(cli, argv, catch_exceptions=False)
    (plain,) = glob.glob(prefix + "_kSpider_clusters_*")
    with open(plain, "rb") as f:
        want = f.read()
    os.remove(plain)
    prof = tmp_path / "prof"
    monkeypatch.setenv(timing.PROFILE_ENV, str(prof))
    result = CliRunner().invoke(cli, argv, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    with open(plain, "rb") as f:
        assert f.read() == want
    _, names = one_trace(prof, "cluster")
    assert ranges <= names, ranges - names
