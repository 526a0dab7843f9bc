"""The comparison that decides ``correct``: the last job's output files
against the plain reference (``reference.py``), worked out again from the
drawn collection.

Each command of a mix leaves files; each is judged by numbers, each with a
limit of its own (:data:`LIMITS`, with the readings they were set from in
``PERF.md``):

- ``pairwise``: ``rows_wrong``, the rows of ``_kSpider_seqToKmersNo.tsv``
  that differ from the reference's plus the rows of
  ``_kSpider_pairwise.tsv`` whose ids or shared count are not the
  reference's (missing, extra, altered or out of order);
  ``containment_gap``, the widest gap between a printed containment and
  the reference's float32 value, in halves of the sixth significant digit
  (a value printed right is at most 1 away).
- ``cluster``: ``genomes_misclustered``, the genomes whose cluster in the
  clusters file is not their reference cluster (or that are missing or
  listed twice).

A number that cannot be read (a missing or malformed file) is None and
fails.
"""

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from gpubench import reference as ref

#: each number's limit: a reading above it is not correct
LIMITS = {
    "rows_wrong": 0,
    "containment_gap": 128.0,
    "genomes_misclustered": 0,
}

PAIRWISE_HEADER = ("source_1\tsource_2\tshared_kmers\tmin_containment\t"
                   "avg_containment\tmax_containment")
#: the ``cluster`` command's defaults
DEFAULT_DIST = "max_cont"
DEFAULT_CUTOFF = 0.0


@dataclass
class Reading:
    name: str
    value: Optional[float]
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and self.value <= self.limit


def seq_path(prefix):
    return prefix + "_kSpider_seqToKmersNo.tsv"


def pairwise_path(prefix):
    return prefix + "_kSpider_pairwise.tsv"


def clusters_path(prefix, cutoff):
    # the command names the file after cutoff * 100 as Python prints it
    return prefix + f"_kSpider_clusters_{float(cutoff) * 100.0}%.tsv"


def min_shared_of(options: dict) -> int:
    return max(1, int(options.get("--min-shared", 1)))


class Expected:
    """The reference's answers for one collection, worked out once."""

    def __init__(self, col):
        self.col = col
        self.pairs = ref.pairs(col.offsets, col.members, col.counts, col.n)
        k = col.kmer_counts
        self.cont = dict(zip(ref.DISTANCES, ref.containment(
            self.pairs.shared, k[self.pairs.i], k[self.pairs.j])))
        self.index_of = {name: g for g, name in enumerate(col.names)}

    def seq_lines(self) -> List[str]:
        return ["ID\tseq\tkmers"] + [
            f"{c}\t{g + 1}\t{k}" for c, (g, k) in
            enumerate(enumerate(self.col.kmer_counts.tolist()), start=1)]

    def partition(self, options: dict, printed_from: Optional[dict]):
        """Reference clusters of a ``cluster`` command; ``printed_from`` is
        the options of the ``pairwise`` command whose TSV it reads (None for
        ``--from-index``, which thresholds the float32 values)."""
        dist = options.get("--dist-type", DEFAULT_DIST)
        cutoff = float(options.get("--cutoff", DEFAULT_CUTOFF))
        m = min_shared_of(printed_from if printed_from is not None else options)
        sel = self.pairs.shared >= m
        d = self.cont[dist][sel]
        if printed_from is None:
            keep = d.astype(np.float64) * 100.0 >= cutoff * 100.0
        else:
            keep = ref.above_cutoff_printed(d, cutoff)
        i, j = self.pairs.i[sel][keep], self.pairs.j[sel][keep]
        return ref.partition(ref.components(self.col.n, i, j))


def read_pairwise_tsv(path: str) -> Optional[np.ndarray]:
    """The TSV's rows as float64[rows, 6], or None if unreadable."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        text = f.read()
    head, _, body = text.partition(b"\n")
    if head.decode(errors="replace") != PAIRWISE_HEADER:
        return None
    n_rows = body.count(b"\n")
    if n_rows == 0:
        return np.zeros((0, 6))
    values = np.fromstring(body, sep=" ")  # every whitespace separates
    if values.size != 6 * n_rows:
        return None
    return values.reshape(n_rows, 6)


def seq_rows_wrong(prefix: str, exp: Expected) -> Optional[int]:
    """Rows of the k-mer count file that differ from the reference's."""
    if not os.path.exists(seq_path(prefix)):
        return None
    want = exp.seq_lines()
    with open(seq_path(prefix)) as f:
        got = f.read().split("\n")
    if got and got[-1] == "":
        got.pop()
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def judge_pairwise(prefix: str, exp: Expected, options: dict) -> List[Reading]:
    rows = read_pairwise_tsv(pairwise_path(prefix))
    seq_wrong = seq_rows_wrong(prefix, exp)
    if rows is None or seq_wrong is None:
        return [Reading("rows_wrong", None, LIMITS["rows_wrong"]),
                Reading("containment_gap", None, LIMITS["containment_gap"])]
    n = exp.col.n
    p = exp.pairs
    sel = p.shared >= min_shared_of(options)
    want_key = p.i[sel] * n + p.j[sel]
    ids = rows[:, :3].astype(np.int64)
    got_key = (ids[:, 0] - 1) * n + (ids[:, 1] - 1)
    # a triple (pair, shared) is right only where both agree
    span = int(max(p.shared.max(initial=0), ids[:, 2].max(initial=0))) + 2
    want_t = want_key * span + p.shared[sel]
    got_t = got_key * span + ids[:, 2]
    bad_ids = (ids[:, 0] < 1) | (ids[:, 1] <= ids[:, 0]) | (ids[:, 1] > n)
    wrong = (seq_wrong + int((~np.isin(got_t, want_t)).sum())
             + int((~np.isin(want_t, got_t)).sum())
             + int((np.diff(got_key) <= 0).sum()) + int(bad_ids.sum()))
    # containment of the rows whose pair the reference has
    pos = hit = np.zeros(0, np.int64)
    if len(want_key):
        pos = np.minimum(np.searchsorted(want_key, got_key), len(want_key) - 1)
        hit = np.flatnonzero(want_key[pos] == got_key)
    gap = 0.0
    for col, dist in zip((3, 4, 5), ref.DISTANCES):
        want = exp.cont[dist][sel][pos[hit]].astype(np.float64)
        if len(want):
            gap = max(gap, float(np.max(np.abs(rows[hit, col] - want)
                                        / ref.half_digit(want))))
    if len(hit) == 0 and len(want_key):
        gap = None
    return [Reading("rows_wrong", float(wrong), LIMITS["rows_wrong"]),
            Reading("containment_gap", gap, LIMITS["containment_gap"])]


def judge_clusters(prefix: str, exp: Expected, options: dict,
                   pairwise_options: Optional[dict]) -> Reading:
    limit = LIMITS["genomes_misclustered"]
    cutoff = options.get("--cutoff", DEFAULT_CUTOFF)
    path = clusters_path(prefix, cutoff)
    if not os.path.exists(path):
        return Reading("genomes_misclustered", None, limit)
    want = {g: c for c in exp.partition(options, pairwise_options) for g in c}
    seen: Dict[int, frozenset] = {}
    wrong = 0
    with open(path) as f:
        for line in f:
            names = line.rstrip("\n").split(",")
            ids = [exp.index_of.get(name) for name in names]
            wrong += sum(g is None for g in ids)
            cluster = frozenset(g for g in ids if g is not None)
            for g in cluster:
                if g in seen:
                    wrong += 1
                seen[g] = cluster
    wrong += sum(g not in seen or seen[g] != c for g, c in want.items())
    return Reading("genomes_misclustered", float(wrong), limit)


def judge(prefix: str, exp: Expected, stages: List[dict]) -> List[Reading]:
    """Every number for the files that the mix's ``stages`` left at
    ``prefix``."""
    out: List[Reading] = []
    pairwise_options = None
    for stage in stages:
        command, options = stage["command"], stage.get("options", {})
        if command == "pairwise":
            pairwise_options = options
            out.extend(judge_pairwise(prefix, exp, options))
        elif command == "cluster":
            from_index = bool(options.get("--from-index", False))
            out.append(judge_clusters(prefix, exp, options,
                                      None if from_index else pairwise_options))
        else:
            raise ValueError(f"no check for the command {command!r}")
    return out
