"""The harness on the card: a tiny cell of each mix runs whole, traced and
not, and prints a correct result line.  Needs a CUDA card; run there with
``python -m pytest -m gpu gpubench/tests/test_bench_gpu.py``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, make_root


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tiny.pipeline", "tiny.from-index"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(tmp_path, workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    root = str(tmp_path)
    make_root(root)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", workload, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert result["device"]["busy_s"] > 0
