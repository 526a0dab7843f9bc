"""Shared set-up of the benchmark's own tests (``python -m pytest gpubench/tests``
from the root of the repository).  They run on the CPU; a test that needs
the card carries the ``gpu`` marker and skips, from inside the test,
where there is none."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a collection small enough for the program's CPU path: 8 species of 8
TINY = {"name": "tiny", "genomes": 64, "group_size": 8,
        "core_hashes": [4500, 6500], "retention": [0.6, 0.95],
        "own_hashes": [800, 1800], "cross_hashes_per_8192": 2000,
        "cross_degree": [16, 64], "ksize": 21, "scaled": 1000}


@pytest.fixture
def tiny_config():
    return dict(TINY)


def make_root(path, extra_cells=()):
    """A checkout-like root at ``path``: ``BENCHMARK.json`` with the tiny
    cells ``tiny.pipeline`` and ``tiny.from-index`` (panels of 16) added,
    and a copy of ``gpubench/``.  Returns the benchmark dict."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), os.path.join(path, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(path, "gpubench", "configs", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(ROOT, "gpubench", "mixes", "cluster-from-index.json")) as f:
        mix = json.load(f)
    mix["name"] = "tiny-from-index"
    mix["stages"][0]["options"]["--panel"] = 16
    with open(os.path.join(path, "gpubench", "mixes", "tiny-from-index.json"), "w") as f:
        json.dump(mix, f)
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": ["genomes"],
                             "file": "gpubench/configs/tiny.json", "why": "test"})
    cells = {"tiny.pipeline": ("pairwise-then-cluster", "derep8k.pipeline"),
             "tiny.from-index": ("tiny-from-index", "derep32k.from-index")}
    for name, (traffic, like) in cells.items():
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    for cell in extra_cells:
        bench["workloads"].append(cell)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return bench


@pytest.fixture
def tiny_root(tmp_path):
    root = str(tmp_path / "root")
    os.makedirs(root)
    return root, make_root(root)
