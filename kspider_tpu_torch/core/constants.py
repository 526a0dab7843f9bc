"""Enums mirrored from the reference's kmerDecoder surface.

The reference records these as integers in the ``.extra`` artifact
(kSpider/src/sourmash_indexing.cpp:322-327).  Only the first line
(kSize) is ever read back by the reference tooling
(kSpider/pykSpider/kSpider2/ks_pairwise.py:47-48); the remaining
lines are informational, so the exact integer values only need to be
self-consistent within this framework.
"""

import enum


class HashingMode(enum.IntEnum):
    integer_hasher = 0
    mumur_hasher = 1
    nonCanonicalInteger_Hasher = 2
    protein_hasher = 3
    proteinDayhoff_hasher = 4


class SlicingMode(enum.IntEnum):
    KMERS = 1
    SKIPMERS = 2
    PROTEIN = 3
