"""kspider_tpu_torch's CLI pipeline vs kspider_tpu on the sig fixture.

The port's ``index``, ``pairwise`` and ``cluster -c 0.55`` run through its
click group on the CPU; kspider_tpu's ``run_pairwise``, ``cluster_index``
and ``cluster_from_index`` run on copies of the same artifacts.
``_kSpider_seqToKmersNo.tsv``, ``_kSpider_pairwise.tsv`` and the clusters
TSV must be byte-identical, on every ``--engine`` name.
"""

import filecmp
import os
import shutil

import pytest
import torch
from click.testing import CliRunner

from kspider_tpu.core import cluster as jcluster
from kspider_tpu.core import pairwise as jpairwise
from kspider_tpu_torch.cli.main import cli

CUTOFF = 0.55
OUTPUTS = (
    "_kSpider_seqToKmersNo.tsv",
    "_kSpider_pairwise.tsv",
    f"_kSpider_clusters_{CUTOFF * 100.0}%.tsv",
)


def invoke(*args):
    return CliRunner().invoke(cli, list(args), catch_exceptions=False)


@pytest.fixture(scope="module")
def jax_run(sig_collection, tmp_path_factory):
    """Port-built index in ``port/``, a copy in ``jax/`` run by kspider_tpu."""
    sigs_dir, _, ksize = sig_collection
    root = tmp_path_factory.mktemp("torch_pipeline")
    port_prefix = str(root / "port" / "sigs")
    os.makedirs(os.path.dirname(port_prefix))
    result = invoke("index", "--sourmash", "--dir", sigs_dir, "-k", str(ksize),
                    "-o", port_prefix)
    assert result.exit_code == 0, result.output
    jax_dir = root / "jax"
    shutil.copytree(root / "port", jax_dir)
    jax_prefix = str(jax_dir / "sigs")
    jpairwise.run_pairwise(jax_prefix, echo_timers=False)
    jcluster.cluster_index(jax_prefix, CUTOFF)
    return port_prefix, jax_prefix


def copy_index(src_prefix, dst_prefix):
    for suffix in ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
                   "_color_count.bin", ".namesMap", ".extra"):
        shutil.copy(src_prefix + suffix, dst_prefix + suffix)


@pytest.mark.parametrize("engine_flags", [["--device", "cpu"], ["--cpu"]])
def test_cli_outputs_byte_identical(jax_run, engine_flags, tmp_path):
    port_prefix, jax_prefix = jax_run
    prefix = str(tmp_path / "sigs")
    copy_index(port_prefix, prefix)
    result = invoke("pairwise", "-i", prefix, *engine_flags)
    assert result.exit_code == 0, result.output
    result = invoke("cluster", "-i", prefix, "-c", str(CUTOFF), *engine_flags)
    assert result.exit_code == 0, result.output
    for suffix in OUTPUTS:
        assert filecmp.cmp(prefix + suffix, jax_prefix + suffix, shallow=False), suffix


def test_cuda_without_card_exits_nonzero(jax_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    port_prefix, _ = jax_run
    for command in (["pairwise", "-i", port_prefix],
                    ["cluster", "-i", port_prefix, "-c", "0.5", "--device", "cuda"]):
        result = invoke(*command)
        assert result.exit_code != 0
        assert "torch.cuda.is_available() is False" in result.output


@pytest.fixture(scope="module")
def jax_tiled_run(jax_run, tmp_path_factory):
    """kspider_tpu's panel-streamed pairwise (8-sample panels, so the 25
    groups make 4 panels and 10 pairs) and ``cluster_from_index``."""
    from kspider_tpu.io import artifacts

    port_prefix, _ = jax_run
    prefix = str(tmp_path_factory.mktemp("torch_pipeline_tiled") / "sigs")
    copy_index(port_prefix, prefix)
    jpairwise.run_pairwise(prefix, use_tpu=False, engine="tiled", panel=8,
                           echo_timers=False)
    jcluster.cluster_from_index(artifacts.load_index_artifacts(prefix), prefix,
                                CUTOFF, use_tpu=False, panel=8)
    return prefix


@pytest.mark.parametrize("args,outputs", [
    (["pairwise", "--engine", "tiled", "--panel", "8", "--device", "cpu"],
     OUTPUTS[:2]),
    (["pairwise", "--engine", "tiled", "--panel", "8", "--device", "cpu",
      "--device-pack", "force"], OUTPUTS[:2]),
    (["pairwise", "--engine", "tiled", "--panel", "8", "--cpu",
      "--device-pack", "off"], OUTPUTS[:2]),
    (["cluster", "--from-index", "-c", str(CUTOFF), "--panel", "8",
      "--device", "cpu"], OUTPUTS[2:]),
    (["cluster", "--from-index", "-c", str(CUTOFF), "--panel", "8", "--cpu"],
     OUTPUTS[2:]),
])
def test_tiled_cli_byte_identical(jax_run, jax_tiled_run, args, outputs,
                                  tmp_path):
    port_prefix, _ = jax_run
    prefix = str(tmp_path / "sigs")
    copy_index(port_prefix, prefix)
    result = invoke(*args, "-i", prefix)
    assert result.exit_code == 0, result.output
    for suffix in outputs:
        assert filecmp.cmp(prefix + suffix, jax_tiled_run + suffix,
                           shallow=False), suffix


@pytest.mark.parametrize("flags,tiled", [(["--cpu"], False),
                                         (["--device", "cpu"], True)])
def test_cpu_above_threshold_matches_jax(jax_run, monkeypatch, tmp_path,
                                         flags, tiled):
    """Above the tiled threshold ``--cpu`` runs the numpy dense engine, as
    kspider_tpu does; a torch device takes the panel-streamed engine.  Both
    write kspider_tpu's ``pairwise --cpu`` bytes."""
    from kspider_tpu_torch.core import pairwise as tpairwise
    from kspider_tpu_torch.ops import tiled_pairwise

    monkeypatch.setattr(jpairwise, "AUTO_TILED_THRESHOLD", 10)
    monkeypatch.setattr(tpairwise, "AUTO_TILED_THRESHOLD", 10)
    streamed = []
    stream = tiled_pairwise.stream_pairwise_tsv
    monkeypatch.setattr(tiled_pairwise, "stream_pairwise_tsv",
                        lambda *a, **k: streamed.append(1) or stream(*a, **k))
    port_prefix, _ = jax_run
    jax_prefix = str(tmp_path / "jax")
    copy_index(port_prefix, jax_prefix)
    assert jpairwise.run_pairwise(jax_prefix, use_tpu=False,
                                  echo_timers=False) is not None
    prefix = str(tmp_path / "port")
    copy_index(port_prefix, prefix)
    result = invoke("pairwise", "-i", prefix, *flags)
    assert result.exit_code == 0, result.output
    assert bool(streamed) == tiled
    for suffix in OUTPUTS[:2]:
        assert filecmp.cmp(prefix + suffix, jax_prefix + suffix,
                           shallow=False), suffix


@pytest.mark.parametrize("args,refusal", [
    (["pairwise", "--num-processes", "2"], "needs --coordinator"),
    (["pairwise", "--num-processes", "2", "--coordinator", "localhost:1"],
     "needs --coordinator"),
    (["pairwise", "--num-processes", "2", "--coordinator", "localhost:1",
      "--process-id", "0", "--device", "cpu,cpu"], "one device per process"),
    (["pairwise", "--engine", "scatter", "--device", "cpu,cpu"],
     "runs on one device"),
    (["index", "--dir", ".", "--device-build", "--device", "cpu,cpu"],
     "takes one device"),
    (["pairwise", "--coordinator", "localhost:1234"], None),
])
def test_unported_options_are_refused(jax_run, args, refusal, tmp_path):
    """Multi-process flags without what they need, and one-device engines
    or commands given a device list, exit 1 with a message before any work.
    ``--coordinator`` with one process runs single-process, as in
    kspider_tpu (the port refused it before it had multi-process runs)."""
    port_prefix, jax_prefix = jax_run
    prefix = str(tmp_path / "sigs")
    copy_index(port_prefix, prefix)
    if "--device" not in args:
        args = [*args, "--device", "cpu"]
    if args[0] == "pairwise":
        args = [*args, "-i", prefix]
    result = invoke(*args)
    if refusal is None:
        assert result.exit_code == 0, result.output
        for suffix in OUTPUTS[:2]:
            assert filecmp.cmp(prefix + suffix, jax_prefix + suffix,
                               shallow=False), suffix
        return
    assert result.exit_code == 1
    assert refusal in result.output
    assert not os.path.exists(prefix + OUTPUTS[1])


@pytest.mark.parametrize("args,outputs,tiled", [
    (["pairwise", "--device", "cpu,cpu"], OUTPUTS[:2], False),
    (["pairwise", "--device", "cpu,cpu,cpu", "--engine", "tiled", "--panel",
      "8"], OUTPUTS[:2], True),
    (["cluster", "--from-index", "-c", str(CUTOFF), "--panel", "8",
      "--device", "cpu,cpu"], OUTPUTS[2:], True),
    (["cluster", "-c", str(CUTOFF), "--device", "cpu,cpu"], OUTPUTS[2:], False),
])
def test_device_list_cli_byte_identical(jax_run, jax_tiled_run, args, outputs,
                                        tiled, tmp_path):
    """``--device cpu,cpu``: the dense engine shards its color blocks, the
    tiled engine its panel pairs; the bytes are kspider_tpu's."""
    port_prefix, jax_prefix = jax_run
    prefix = str(tmp_path / "sigs")
    copy_index(port_prefix, prefix)
    if args[0] == "cluster" and not tiled:
        shutil.copy(jax_prefix + OUTPUTS[1], prefix + OUTPUTS[1])
    result = invoke(*args, "-i", prefix)
    assert result.exit_code == 0, result.output
    want = jax_tiled_run if tiled else jax_prefix
    for suffix in outputs:
        assert filecmp.cmp(prefix + suffix, want + suffix, shallow=False), suffix


@pytest.fixture(scope="module")
def jax_engine_runs(jax_run, tmp_path_factory):
    """kspider_tpu's ``run_pairwise`` per (engine, use_tpu), on copies of the
    port-built index; each is run once, when a test first asks for it."""
    port_prefix, _ = jax_run
    root = tmp_path_factory.mktemp("torch_pipeline_engines")
    runs = {}

    def run(engine, use_tpu):
        if (engine, use_tpu) not in runs:
            prefix = str(root / f"{engine}_{use_tpu}")
            copy_index(port_prefix, prefix)
            jpairwise.run_pairwise(prefix, use_tpu=use_tpu, engine=engine,
                                   echo_timers=False)
            runs[engine, use_tpu] = prefix
        return runs[engine, use_tpu]

    return run


@pytest.mark.parametrize("flags,use_tpu", [(["--device", "cpu"], True),
                                           (["--cpu"], False)])
@pytest.mark.parametrize("engine", ["auto", "bitmask", "pallas", "scatter", "tiled"])
def test_every_engine_name_byte_identical(jax_run, jax_engine_runs, engine,
                                          flags, use_tpu, tmp_path):
    """Every ``--engine`` name of kspider_tpu's ``pairwise`` is accepted and
    writes its bytes (``--cpu``: the numpy engine for all but tiled)."""
    port_prefix, _ = jax_run
    prefix = str(tmp_path / "sigs")
    copy_index(port_prefix, prefix)
    result = invoke("pairwise", "-i", prefix, "--engine", engine, *flags)
    assert result.exit_code == 0, result.output
    want = jax_engine_runs(engine, use_tpu)
    for suffix in OUTPUTS[:2]:
        assert filecmp.cmp(prefix + suffix, want + suffix, shallow=False), suffix


def test_cli_device_build_index_equals_host_index(sig_collection, jax_run, tmp_path):
    """``index --device-build --device cpu`` writes the host build's five
    artifacts, so every later stage reads the same index."""
    sigs_dir, _, ksize = sig_collection
    port_prefix, _ = jax_run
    prefix = str(tmp_path / "x")
    result = invoke("index", "--sourmash", "--dir", sigs_dir, "-k", str(ksize),
                    "-o", prefix, "--device-build", "--device", "cpu")
    assert result.exit_code == 0, result.output
    for suffix in ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
                   "_color_count.bin", ".namesMap", ".extra"):
        assert filecmp.cmp(prefix + suffix, port_prefix + suffix,
                           shallow=False), suffix


def test_dense_engine_refuses_tiled_sizes(tmp_path):
    """N = 16,385 is past the dense engine: a torch device takes the
    panel-streamed engine, which writes kspider_tpu's header-only TSV."""
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu_torch.core import pairwise as tpairwise

    n = tpairwise.AUTO_TILED_THRESHOLD + 1
    index = build_index_from_hash_sets([f"s{i}" for i in range(n)], [None] * n)
    assert tpairwise.run_pairwise(str(tmp_path / "port"), index, device="cpu",
                                  echo_timers=False) is None
    assert jpairwise.run_pairwise(str(tmp_path / "jax"), index,
                                  echo_timers=False) is None
    for suffix in OUTPUTS[:2]:
        assert filecmp.cmp(str(tmp_path / "port") + suffix,
                           str(tmp_path / "jax") + suffix, shallow=False)
    with open(str(tmp_path / "port") + OUTPUTS[1]) as f:
        assert f.read().count("\n") == 1
