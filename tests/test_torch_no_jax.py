"""kspider_tpu_torch never imports jax.

Runs in a subprocess because tests/conftest.py imports jax into this one.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, sys
import numpy as np
import torch
import kspider_tpu_torch
from kspider_tpu_torch.cli.main import cli  # registers every command
from kspider_tpu.core.index import build_index_from_hash_sets
from kspider_tpu.io import artifacts
from kspider_tpu_torch.core import cluster, pairwise

rng = np.random.default_rng(0)
pool = np.unique(rng.integers(0, 2**63, size=4000, dtype=np.uint64))
arrays = [np.unique(np.concatenate([pool[(i % 2) * 1000:(i % 2) * 1000 + 1000][rng.random(1000) < 0.7],
                                    pool[2000 + 100 * i:2100 + 100 * i]])) for i in range(6)]
index = build_index_from_hash_sets([f"s{i}" for i in range(6)], arrays, ksize=21)
prefix = os.path.join(sys.argv[1], "idx")
artifacts.write_index_artifacts(prefix, index)
shared = pairwise.run_pairwise(prefix, device="cpu", echo_timers=False)
assert shared.shape == (6, 6) and shared[0, 2] > 0
with open(cluster.cluster_index(prefix, 0.3, device="cpu")) as f:
    assert f.read() == "s0,s2,s4\ns1,s3,s5\n"
with open(prefix + "_kSpider_pairwise.tsv", "rb") as f:
    dense_tsv = f.read()
# the panel-streamed engine: 3 panels of 2 samples, diagonal and
# off-diagonal pairs, device-packed sides
assert pairwise.run_pairwise(prefix, device="cpu", engine="tiled", panel=2,
                             device_pack="force", echo_timers=False) is None
with open(prefix + "_kSpider_pairwise.tsv", "rb") as f:
    assert f.read() == dense_tsv
with open(cluster.cluster_from_index(index, prefix, 0.3, device="cpu",
                                     panel=2)) as f:
    assert f.read() == "s0,s2,s4\ns1,s3,s5\n"
# every engine name, and the device index build through the CLI
from click.testing import CliRunner
from kspider_tpu.io import phmap
for engine in ("bitmask", "pallas", "scatter"):
    assert pairwise.run_pairwise(prefix, device="cpu", engine=engine,
                                 echo_timers=False) is not None
    with open(prefix + "_kSpider_pairwise.tsv", "rb") as f:
        assert f.read() == dense_tsv, engine
bins = os.path.join(sys.argv[1], "bins")
os.makedirs(bins)
for i, a in enumerate(arrays):
    phmap.write_hash_set(os.path.join(bins, f"s{i}.bin"), a)
for out, flags in (("host", []), ("dev", ["--device-build", "--device", "cpu"])):
    result = CliRunner().invoke(cli, ["index", "--bins", "--dir", bins, "-k", "21",
                                      "-o", os.path.join(sys.argv[1], out), *flags])
    assert result.exit_code == 0, result.output
for suffix in ("_color_to_sources.bin", "_color_count.bin", ".namesMap"):
    with open(os.path.join(sys.argv[1], "host" + suffix), "rb") as a, \
            open(os.path.join(sys.argv[1], "dev" + suffix), "rb") as b:
        assert a.read() == b.read(), suffix
# the fused step
from kspider_tpu_torch.parallel import step
bits, wl, counts, block, n_pad, n_limbs = step.make_example_blocks(
    n_samples=64, n_colors=256, block=32, seed=3)
shared, labels = step.single_device_step(bits, wl, counts, 0.01, block, n_pad,
                                         n_limbs, device="cpu")
assert shared.shape == (64, 64) and labels.shape == (64,)
# the multi-device and multi-process modules: two shards on the CPU
from kspider_tpu_torch.parallel import distributed, mesh, multiprocess, sharded_pairwise
sharded_s, sharded_l = step.sharded_step(["cpu", "cpu"], bits, wl, counts, 0.01,
                                         block, n_pad, n_limbs)
assert torch.equal(sharded_s, shared) and torch.equal(sharded_l, labels)
from kspider_tpu_torch.ops import pairwise as pw
m = sharded_pairwise.shared_kmer_matrix_sharded(
    index.color_offsets, index.color_members, index.color_counts,
    index.num_groups, devices=mesh.make_mesh("cpu,cpu"), block=32)
assert np.array_equal(m, pw.shared_kmer_matrix_numpy(
    index.color_offsets, index.color_members, index.color_counts,
    index.num_groups))
assert multiprocess.initialize() == distributed.process_info() == (0, 1)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
print("NO_JAX_OK")
"""


def test_port_runs_without_importing_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
