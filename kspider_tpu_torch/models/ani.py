"""Containment -> ANI estimation (sourmash ``distance_utils`` semantics).

The reference shells out to ``sourmash.distance_utils.containment_to_distance``
with the sketch ``scale`` and per-group k-mer counts
(kSpider/pykSpider/kSpider2/ks_pairwise.py:78-80):

    containment_to_distance(min_cont, k, scale,
                            n_unique_kmers=count[id_2] * scale).ani

We implement the same model natively (sourmash is not a dependency of
this framework), column-for-column:

- point estimate ``dist = 1 - containment**(1/k)`` with the exact
  ``containment == 0`` (dist = 1) and ``containment == 1`` (dist = 0)
  edge handling;
- the FracMinHash "probability nothing in common" gate
  ``exp((L - L*q) * ln(1 - 1/scale))`` with ``q = 1 - (1-dist)**k``,
  which is what ``scale`` and ``n_unique_kmers`` feed — sourmash flags a
  result whose probability exceeds 1e-3 as unreliable
  (``p_exceeds_threshold``); kSpider discards the flag, we surface it as
  a warning count.

The ``--estimate-ani`` flow mirrors ks_pairwise.py:62-86: read per-group
k-mer counts from ``{p}_kSpider_seqToKmersNo.tsv``, compute ``ani_1_in_2``
from min_containment against group 2's budget (count * scale) and
``ani_2_in_1`` from max_containment against group 1's, and write their
average as a single ``avg_ani`` column file (Python float repr, matching
the reference's f-string emission).
"""

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from kspider_tpu_torch.utils.logger import Logger


def _r1_to_q(ksize: int, r1: float) -> float:
    """Expected fraction of k-mers mutated at per-base mutation rate r1."""
    return 1.0 - (1.0 - float(r1)) ** ksize


def exp_probability_nothing_common(
    dist: float, ksize: int, scaled: int, n_unique_kmers: float
) -> float:
    """Expected probability that two FracMinHash sketches share nothing.

    Mirrors sourmash ``get_exp_probability_nothing_common``:
    ``exp((L - L*q) * ln(1 - 1/scaled))`` where ``q = 1 - (1-dist)**k``.
    ``dist`` 0 -> 0.0, ``dist`` 1 -> 1.0 by convention.
    """
    if dist == 1.0:
        return 1.0
    if dist == 0.0:
        return 0.0
    f_scaled = 1.0 / float(scaled)
    exp_n_mut = n_unique_kmers * _r1_to_q(ksize, dist)
    try:
        log_prob = (n_unique_kmers - exp_n_mut) * math.log(1.0 - f_scaled)
    except ValueError:  # log(0): scaled == 1 handled above; keep -inf
        return 0.0
    return math.exp(log_prob)


@dataclass
class ANIResult:
    """Distance/ANI estimate with the sourmash reliability gate.

    ``p_exceeds_threshold`` means the sketches are small/sparse enough
    that sharing nothing by chance was likely — the estimate should not
    be trusted (sourmash ``ANIResult.__post_init__`` semantics).
    """

    dist: float
    p_nothing_in_common: float
    p_threshold: float = 1e-3
    p_exceeds_threshold: bool = field(init=False)

    def __post_init__(self):
        if not 0.0 <= self.dist <= 1.0:
            raise ValueError(
                f"distance value {self.dist:.4f} is not between 0 and 1!"
            )
        self.p_exceeds_threshold = (
            self.p_nothing_in_common >= self.p_threshold
        )

    @property
    def ani(self) -> float:
        return 1.0 - self.dist


def containment_to_distance(
    containment: float,
    ksize: int,
    scaled: int,
    n_unique_kmers: float,
    prob_threshold: float = 1e-3,
) -> ANIResult:
    """sourmash ``containment_to_distance`` point-estimate path.

    (CI estimation is an ``estimate_ci=True`` branch the reference never
    takes — ks_pairwise.py:78-80 calls with defaults.)
    """
    if containment == 0.0:
        point_estimate = 1.0
    elif containment == 1.0:
        point_estimate = 0.0
    else:
        point_estimate = 1.0 - containment ** (1.0 / ksize)
    prob = exp_probability_nothing_common(
        point_estimate, ksize, scaled, n_unique_kmers
    )
    return ANIResult(point_estimate, prob, p_threshold=prob_threshold)


def containment_to_ani(containment, ksize: int) -> np.ndarray:
    """Vectorized point-estimate ANI = containment ** (1/k); 0 maps to 0."""
    c = np.asarray(containment, dtype=np.float64)
    out = np.zeros_like(c)
    pos = c > 0
    out[pos] = np.power(c[pos], 1.0 / ksize)
    return out


def read_seq_to_kmers(seq_to_kmers_tsv: str) -> Dict[int, int]:
    """{group_id: kmer_count} from ``{p}_kSpider_seqToKmersNo.tsv``
    (reference parse: columns [1:] = seq_ID, no_of_kmers,
    ks_pairwise.py:58-62)."""
    id_to_kmer_count: Dict[int, int] = {}
    with open(seq_to_kmers_tsv) as fh:
        next(fh)
        for line in fh:
            seq_id, n_kmers = line.strip().split("\t")[1:]
            id_to_kmer_count[int(seq_id)] = int(n_kmers)
    return id_to_kmer_count


def write_ani_column(
    prefix: str,
    ksize: int,
    scale: int,
    logger: Optional[Logger] = None,
) -> str:
    """Post-process ``{p}_kSpider_pairwise.tsv`` into
    ``{p}_kSpider_pairwise.ani_col.tsv`` (one ``avg_ani`` value per row,
    same order), replicating ks_pairwise.py:66-84 including the
    ``n_unique_kmers = kmer_count * scale`` budgets."""
    pairwise_file = prefix + "_kSpider_pairwise.tsv"
    out_file = prefix + "_kSpider_pairwise.ani_col.tsv"
    seq_to_kmers_tsv = prefix + "_kSpider_seqToKmersNo.tsv"
    if not os.path.exists(seq_to_kmers_tsv):
        # the reference fails on open() here (ks_pairwise.py:58); a
        # missing budget file would make every pair's
        # exp_probability_nothing_common = 1.0, i.e. silently wrong
        # reliability flags
        if logger is not None:
            logger.ERROR(f"File {seq_to_kmers_tsv} is not found.")
        raise FileNotFoundError(seq_to_kmers_tsv)
    id_to_kmer_count = read_seq_to_kmers(seq_to_kmers_tsv)
    unreliable = 0
    with open(pairwise_file) as pw, open(out_file, "w") as out:
        next(pw)
        out.write("avg_ani\n")
        for line in pw:
            parts = line.rstrip("\n").split("\t")
            id_1, id_2 = int(parts[0]), int(parts[1])
            min_containment = float(parts[3])
            max_containment = float(parts[5])
            r12 = containment_to_distance(
                min_containment, ksize, scale,
                n_unique_kmers=id_to_kmer_count.get(id_2, 0) * scale,
            )
            r21 = containment_to_distance(
                max_containment, ksize, scale,
                n_unique_kmers=id_to_kmer_count.get(id_1, 0) * scale,
            )
            if r12.p_exceeds_threshold or r21.p_exceeds_threshold:
                unreliable += 1
            avg_ani = (r12.ani + r21.ani) / 2.0
            out.write(f"{avg_ani}\n")
    if unreliable and logger is not None:
        logger.WARNING(
            f"{unreliable} pair(s) have a >0.1% chance of sharing nothing "
            "by chance at this scale — their ANI estimates are unreliable "
            "(sourmash p_exceeds_threshold)."
        )
    return out_file
