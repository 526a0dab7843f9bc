"""kspider_tpu_torch's CLI pipeline vs kspider_tpu on the sig fixture.

The port's ``index``, ``pairwise`` and ``cluster -c 0.55`` run through its
click group on the CPU; kspider_tpu's ``run_pairwise`` and ``cluster_index``
run on a second copy of the same artifacts.  ``_kSpider_seqToKmersNo.tsv``,
``_kSpider_pairwise.tsv`` and the clusters TSV must be byte-identical.
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


@pytest.mark.parametrize("engine_flags", [["--device", "cpu"], ["--cpu"]])
def test_cli_outputs_byte_identical(jax_run, engine_flags, tmp_path):
    port_prefix, jax_prefix = jax_run
    prefix = str(tmp_path / "sigs")
    for suffix in ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
                   "_color_count.bin", ".namesMap", ".extra"):
        shutil.copy(port_prefix + suffix, prefix + suffix)
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


@pytest.mark.parametrize("args", [
    ["pairwise", "--engine", "tiled"],
    ["pairwise", "--num-processes", "2"],
    ["pairwise", "--coordinator", "localhost:1234"],
    ["pairwise", "--device-pack", "force"],
    ["cluster", "--from-index"],
])
def test_unported_options_are_refused(jax_run, args):
    port_prefix, _ = jax_run
    result = invoke(*args, "-i", port_prefix, "--device", "cpu")
    assert result.exit_code == 1
    assert "not ported to kspider_tpu_torch yet" in result.output


def test_device_build_is_refused(sig_collection, tmp_path):
    sigs_dir, _, ksize = sig_collection
    result = invoke("index", "--sourmash", "--dir", sigs_dir, "-k", str(ksize),
                    "-o", str(tmp_path / "x"), "--device-build")
    assert result.exit_code == 1
    assert "index --device-build is not ported" in result.output
    assert not os.path.exists(str(tmp_path / "x.namesMap"))


def test_dense_engine_refuses_tiled_sizes(tmp_path):
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu_torch.core import pairwise as tpairwise

    n = tpairwise.AUTO_TILED_THRESHOLD + 1
    index = build_index_from_hash_sets([f"s{i}" for i in range(n)], [None] * n)
    with pytest.raises(NotImplementedError, match="tiled"):
        tpairwise.run_pairwise(str(tmp_path / "big"), index, device="cpu",
                               echo_timers=False)
    assert not os.path.exists(str(tmp_path / "big_kSpider_pairwise.tsv"))
