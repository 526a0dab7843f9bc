"""A run with the timed path broken underneath sees ``correct`` come out
false, once for each fault the cells can have (one card: no exchange
between chips): a stage that leaves its state unchanged, half of the work
left out, and an answer altered where it is produced."""

import numpy as np
import pytest

from gpubench import run


def run_tiny(root, bench, workload):
    return run.run_cell(bench, workload, 31, 0.2, False, device="cpu", root=root)


@pytest.mark.parametrize("workload", ["tiny.pipeline", "tiny.from-index"])
def test_sound_run_is_correct(tiny_root, workload):
    r = run_tiny(*tiny_root, workload)
    assert r["correct"] and r["failed"] == 0, r["checks"]


def test_pairwise_stage_does_nothing(tiny_root, monkeypatch):
    from kspider_tpu_torch.core import pairwise

    monkeypatch.setattr(pairwise, "run_pairwise", lambda *a, **k: None)
    r = run_tiny(*tiny_root, "tiny.pipeline")
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] is None


def test_from_index_stage_does_nothing(tiny_root, monkeypatch):
    from kspider_tpu_torch.core import cluster

    monkeypatch.setattr(cluster, "cluster_from_index",
                        lambda index, prefix, *a, **k: prefix + "_kSpider_none.tsv")
    r = run_tiny(*tiny_root, "tiny.from-index")
    assert not r["correct"]


def test_half_of_the_colors_left_out(tiny_root, monkeypatch):
    from kspider_tpu_torch.ops import pairwise as ops

    whole = ops.shared_kmer_matrix

    def half(offsets, members, counts, n, **kw):
        keep = len(counts) // 2
        return whole(offsets[:keep + 1], members[:offsets[keep]], counts[:keep], n, **kw)

    monkeypatch.setattr(ops, "shared_kmer_matrix", half)
    r = run_tiny(*tiny_root, "tiny.pipeline")
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("kept", ["every_other", "diagonal_only"])
def test_panel_pairs_left_out(tiny_root, monkeypatch, kept):
    """Half of the panel pairs, or every off-diagonal one, never reaches
    the clusters."""
    from kspider_tpu_torch.ops import tiled_pairwise as tp

    whole = tp.iter_panel_pairs

    def some(*a, **k):
        for p, out in enumerate(whole(*a, **k)):
            if (p % 2 == 0) if kept == "every_other" else (out[0] == out[1]):
                yield out

    monkeypatch.setattr(tp, "iter_panel_pairs", some)
    r = run_tiny(*tiny_root, "tiny.from-index")
    assert not r["correct"]
    assert r["checks"]["genomes_misclustered"]["value"] > 0


def test_one_shared_count_altered(tiny_root, monkeypatch):
    from kspider_tpu_torch.ops import pairwise as ops

    whole = ops.shared_kmer_matrix

    def altered(*a, **k):
        s = whole(*a, **k)
        s[0, 1] += 1
        s[1, 0] += 1
        return s

    monkeypatch.setattr(ops, "shared_kmer_matrix", altered)
    r = run_tiny(*tiny_root, "tiny.pipeline")
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] == 2  # one row out, one in


def test_one_pair_altered_in_the_panel_stream(tiny_root, monkeypatch):
    from kspider_tpu_torch.ops import tiled_pairwise as tp

    whole = tp.iter_panel_pairs

    def altered(plan, **k):
        first = True
        for pi, pj, gi, gj, vals in whole(plan, **k):
            if first and len(gi):
                gj, vals = gj.copy(), vals.copy()
                gj[0], vals[0] = plan.n - 1, np.int64(10**6)
                first = False
            yield pi, pj, gi, gj, vals

    monkeypatch.setattr(tp, "iter_panel_pairs", altered)
    r = run_tiny(*tiny_root, "tiny.from-index")
    assert not r["correct"]
    assert r["checks"]["genomes_misclustered"]["value"] > 0


def test_off_diagonal_panel_pairs_left_out_at_the_cells_size(tmp_path):
    """At ``derep32k.from-index``'s own size and panel width, clusters made
    from the diagonal panel pairs alone read not correct: the drawn order
    scatters each species over the panels."""
    from gpubench import check, datagen, reference

    bench = run.load_benchmark()
    _, config, mix = run.cell(bench, "derep32k.from-index")
    options = mix["stages"][0]["options"]
    col = datagen.generate(config, run.seed_rng_key(2**31 + 17))
    exp = check.Expected(col)
    p, panel = exp.pairs, int(options["--panel"])
    assert col.n // panel == 8
    diagonal = p.i // panel == p.j // panel
    keep = diagonal & (exp.cont[options["--dist-type"]].astype(np.float64) * 100.0
                       >= float(options["--cutoff"]) * 100.0)
    prefix = str(tmp_path / "derep")
    with open(check.clusters_path(prefix, options["--cutoff"]), "w") as f:
        for c in reference.partition(reference.components(col.n, p.i[keep], p.j[keep])):
            f.write(",".join(col.names[g] for g in sorted(c)) + "\n")
    reading = check.judge_clusters(prefix, exp, options, None)
    assert not reading.ok
    assert reading.value > 0.5 * col.n
