"""A later change adds a cell by adding files and entries only: a new
configuration, mix and per-layer metric yield a runnable cell, and no
file that was there changes."""

import hashlib
import json
import os

import numpy as np

from conftest import make_root
from gpubench import datagen, reference, run


def digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "gpubench")):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_make_a_runnable_cell(tmp_path, tiny_config):
    root = str(tmp_path)
    make_root(root)
    before = digests(root)
    bench_dir = os.path.join(root, "gpubench")
    with open(os.path.join(bench_dir, "configs", "tiny-wide.json"), "w") as f:
        json.dump(dict(tiny_config, name="tiny-wide", genomes=96), f)
    with open(os.path.join(bench_dir, "mixes", "pairwise-ms3.json"), "w") as f:
        json.dump({"name": "pairwise-ms3", "why": "test", "stages": [
            {"command": "pairwise", "options": {"--min-shared": 3}}]}, f)
    with open(os.path.join(bench_dir, "metrics", "pairwise.jobs_seen.py"), "w") as f:
        f.write('"""The number of pairwise jobs in the window."""\n'
                'LAYER = "benchmark"\nUNIT = "jobs"\nBETTER = "higher"\n'
                'SOURCE = "program_span"\nMOVES = "pairwise_s"\n\n\n'
                'def read(win):\n    return float(len(win.stages.get("pairwise", [])))\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-wide", "source": "test", "reduced": [],
                             "file": "gpubench/configs/tiny-wide.json", "why": "test"})
    bench["workloads"].append({"name": "wide.ms3", "config": "tiny-wide",
                               "traffic": "pairwise-ms3", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairwise_s":
            m["workloads"].append("wide.ms3")
    bench["per_layer"].append({"name": "pairwise.jobs_seen", "unit": "jobs",
                               "better": "higher", "source": "program_span",
                               "layer": "benchmark", "moves": "pairwise_s",
                               "workloads": ["wide.ms3"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    for traced in (False, True):
        r = run.run_cell(bench, "wide.ms3", 9, 0.2, traced, device="cpu", root=root)
        assert r["correct"], r["checks"]
        assert r["run"]["collection"]["genomes"] == 96
        assert list(r["checks"]) == ["rows_wrong", "containment_gap"]
        if traced:
            assert r["metrics"]["pairwise.jobs_seen"]["value"] == r["run"]["jobs"]
        else:
            assert set(r["metrics"]) == {"pairwise_s", "peak_host_gib", "setup_s"}
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


#: heavy-tailed species sizes: singletons, a few small species drawn by the
#: multinomial, and species of 13 and 40 drawn member by member
SKEWED = {"name": "tiny-skew", "genomes": 128,
          "species_sizes": [[1, 22], [2, 10], [4, 5], [13, 2], [40, 1]],
          "core_hashes": [4500, 6500], "retention": [0.6, 0.95],
          "own_hashes": [800, 1800], "cross_hashes_per_8192": 2000,
          "cross_degree": [16, 64], "ksize": 21, "scaled": 1000}


def test_species_sizes_config_makes_a_cell_by_files_alone(tmp_path):
    """A configuration with ``species_sizes`` and a ``--from-index`` mix,
    added as files and entries, give a cell that runs, is judged correct,
    and whose control is not; no file that was there changes."""
    from gpubench import control

    root = str(tmp_path)
    make_root(root)
    before = digests(root)
    bench_dir = os.path.join(root, "gpubench")
    with open(os.path.join(bench_dir, "configs", "tiny-skew.json"), "w") as f:
        json.dump(SKEWED, f)
    with open(os.path.join(bench_dir, "mixes", "skew-from-index.json"), "w") as f:
        json.dump({"name": "skew-from-index", "why": "test", "stages": [
            {"command": "cluster", "options": {"--from-index": True, "--cutoff": 0.6,
                                               "--dist-type": "max_cont", "--panel": 32,
                                               "--min-shared": 1}}]}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-skew", "source": "test", "reduced": ["genomes"],
                             "file": "gpubench/configs/tiny-skew.json", "why": "test"})
    bench["workloads"].append({"name": "skew.from-index", "config": "tiny-skew",
                               "traffic": "skew-from-index", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "derep32k.from-index" in m.get("workloads", ()):
            m["workloads"].append("skew.from-index")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    for traced in (False, True):
        r = run.run_cell(bench, "skew.from-index", 2**31 + 9, 0.2, traced,
                         device="cpu", root=root)
        assert r["correct"], r["checks"]
        assert r["run"]["collection"]["genomes"] == 128
        assert list(r["checks"]) == ["genomes_misclustered"]
        if not traced:
            assert set(r["metrics"]) == {"cluster_s", "peak_host_gib", "setup_s"}
    col = datagen.generate(SKEWED, run.seed_rng_key(2**31 + 9))
    sizes = np.bincount(reference.groups(col.offsets, col.members, col.n))
    assert 40 in sizes.tolist()  # the reference took a group's product
    for seed in (1, 2, 3):
        c = control.readings("skew.from-index", seed, root)
        assert not c["correct"], c
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
