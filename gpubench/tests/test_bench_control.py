"""The control (the reference in bfloat16 where the configuration states
float32) comes out not correct; the reference in float32 in the same
place comes out correct."""

import json
import os

import numpy as np
import pytest

from conftest import make_root
from gpubench import check, control, datagen, run


def test_bf16_rounding():
    x = np.array([1.0, 1 + 2**-8, 1 + 2**-7, 3.14159265], np.float32)
    assert control.to_bf16(x).tolist() == [1.0, 1.0, 1 + 2**-7, 3.140625]


@pytest.mark.parametrize("workload", ["tiny.pipeline", "tiny.from-index"])
def test_control_is_not_correct(tmp_path, workload):
    root = str(tmp_path)
    make_root(root)
    for seed in (1, 2, 3):
        r = control.readings(workload, seed, root)
        assert not r["correct"], r
        if workload == "tiny.pipeline":
            assert r["checks"]["rows_wrong"]["value"] > 0
            assert r["checks"]["containment_gap"]["value"] > 128


def test_each_step_alone_is_not_correct(tmp_path, tiny_config):
    """int4 operands alone, and bfloat16 containment alone, each fail the
    clusters at the mixes' cutoff of 0.6; bfloat16 needs pairs near the
    cutoff, so this runs at the genus size (the cells' own readings are in
    PERF.md)."""
    root = str(tmp_path)
    make_root(root)
    with open(os.path.join(root, "gpubench", "configs", "tiny.json"), "w") as f:
        json.dump(dict(tiny_config, genomes=8192), f)
    for steps in (("int4",), ("bf16",)):
        for seed in (1, 2, 3):
            r = control.readings("tiny.from-index", seed, root, steps)
            assert r["checks"]["genomes_misclustered"]["value"] > 0, (steps, r)


def test_reference_in_the_programs_place_is_correct(tmp_path, monkeypatch):
    """The same files written in float32 read correct: what fails the
    control is its precision."""
    root = str(tmp_path)
    make_root(root)
    _, config, mix = run.cell(run.load_benchmark(root), "tiny.pipeline", root)
    exp = check.Expected(datagen.generate(config, 4))
    prefix = os.path.join(str(tmp_path), "derep")
    control.write_control(exp, mix["stages"], prefix, steps=())
    found = check.judge(prefix, exp, mix["stages"])
    assert all(r.ok for r in found), found
    assert max(r.value for r in found) <= 1.0 + 1e-9
