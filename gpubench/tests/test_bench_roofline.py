"""The roofline count at a tiny N, against a count by hand."""

import numpy as np

from gpubench import roofline

# six genomes; colors {0,1} x3, {2,4} x200, {5} x10 (a singleton), {0..4} x1
OFFSETS = np.array([0, 2, 4, 5, 10])
MEMBERS = np.array([0, 1, 2, 4, 5, 0, 1, 2, 3, 4], np.int32)
COUNTS = np.array([3, 200, 10, 1])


def test_limbs():
    assert roofline.limbs(np.array([127])) == 1
    assert roofline.limbs(np.array([128])) == 2
    assert roofline.limbs(np.array([16383, 5])) == 2
    assert roofline.limbs(np.array([16384])) == 3


def test_dense_work_by_hand():
    # 3 colors of two or more genomes, L = 2 (200 >= 128), 21 upper pairs
    w = roofline.dense_work(OFFSETS, MEMBERS, COUNTS, 6)
    assert w.ops == 2 * 2 * 3 * 21
    assert w.bytes == 3 * 6 / 8 + 3 * 2 + 4 * 2 * 21


def test_panel_work_by_hand():
    # panels {0,1,2}, {3,4,5}: C_00 = 2 ({0,1}, {0..4}), C_11 = 1 ({0..4}),
    # C_01 = 2 ({2,4}, {0..4}); 6 upper pairs in a diagonal panel pair, 9 off
    w = roofline.panel_work(OFFSETS, MEMBERS, COUNTS, 6, 3)
    assert w.ops == 2 * 2 * (2 * 6 + 1 * 6 + 2 * 9)
    bits = 2 * 3 / 8 + 1 * 3 / 8 + 2 * 6 / 8
    limbs = 2 * (2 + 1 + 2)
    out = 4 * 2 * (6 + 6 + 9)
    assert w.bytes == bits + limbs + out


def test_least_time_and_stage_work():
    w = roofline.Work(ops=1979e12 * 1e-3, bytes=3.35e12 * 2e-3)
    assert w.least_s("NVIDIA H100 80GB HBM3") == 2e-3
    assert w.least_s("some other card") is None
    args = (OFFSETS, MEMBERS, COUNTS, 6)
    assert roofline.stage_work("cluster", {}, *args) is None
    assert roofline.stage_work("pairwise", {}, *args) == roofline.dense_work(*args)
    assert roofline.stage_work("cluster", {"--from-index": True, "--panel": 3},
                               *args) == roofline.panel_work(*args, 3)
    assert roofline.stage_work("pairwise", {"--engine": "tiled", "--panel": 3},
                               *args) == roofline.panel_work(*args, 3)
