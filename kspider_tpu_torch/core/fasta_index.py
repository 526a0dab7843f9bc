"""FASTA indexing with names-file grouping.

Capability mirror of the reference's hidden ``index_kmers`` /
``index_skipmers`` / ``index_protein`` commands, which call
``kProcessor::index(kf, fasta, chunk, names)``
(kSpider/src/index.cpp:53-81).  The names file is a TSV of
``fasta_header<TAB>group_name`` merging FASTA records into samples
(kSpider/docs/index.md:9-37).

Divergence, by design: the reference saves a kProcessor
``colored_kDataFrame`` (a format we cannot reproduce without the absent
submodule, and which its own pairwise engine cannot consume); we emit the
standard five pairwise-ready artifacts instead, unifying all index paths.

Group ids are assigned in order of first appearance in the names file.
"""

from typing import Dict, List, Optional

import numpy as np

from kspider_tpu_torch.core import hashing
from kspider_tpu_torch.core.constants import HashingMode, SlicingMode
from kspider_tpu_torch.core.index import ColorIndex, build_index_from_hash_sets
from kspider_tpu_torch.io import artifacts as artifacts_io
from kspider_tpu_torch.io import fastx
from kspider_tpu_torch.utils.logger import Logger


def read_names_file(names_file: str) -> Dict[str, str]:
    """header -> group name; raises on malformed lines like the CLI
    validation at kSpider/pykSpider/kSpider2/ks_index.py:16-25."""
    mapping: Dict[str, str] = {}
    with open(names_file) as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                raise ValueError(
                    f"invalid names line detected at L{i}: '{line.strip()}'"
                )
            mapping[parts[0]] = parts[1]
    return mapping


def _skipmer_codes(seq: str, m: int, n: int, k: int) -> np.ndarray:
    """Skip-mer extraction: from every start, take m bases out of every
    n-base cycle until k bases are collected (k % m == 0), canonicalized
    like regular k-mers.  Shape validation mirrors
    kSpider/pykSpider/kSpider2/ks_index.py:77-79."""
    if n < 1 or n < m or k < m or k % m != 0:
        raise ValueError(
            "Invalid skip-mer shape! Conditions: 0 < m <= n < k & k must be "
            "multiple of m"
        )
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    raw = hashing._UPPER[raw]
    cycles = k // m
    span = (cycles - 1) * n + m  # bases touched by one skip-mer
    if len(raw) < span:
        return np.empty(0, dtype=np.uint64)
    # gather the used positions for every start offset
    offsets = (np.arange(cycles)[:, None] * n + np.arange(m)[None, :]).reshape(-1)
    starts = np.arange(len(raw) - span + 1)
    windows = raw[starts[:, None] + offsets[None, :]]  # (n_windows, k)
    valid = (hashing._CODE[windows] != 255).all(axis=1)
    windows = windows[valid]
    if len(windows) == 0:
        return np.empty(0, dtype=np.uint64)
    fwd_codes = hashing.encode_2bit(windows)
    rc_windows = hashing._COMPLEMENT[windows][:, ::-1]
    rc_codes = hashing.encode_2bit(rc_windows)
    return np.minimum(fwd_codes, rc_codes)


def index_fasta(
    fasta_file: str,
    names_file: str,
    ksize: int,
    output_prefix: str,
    mode: str = "kmers",
    canonical: bool = True,
    dayhoff: bool = False,
    skip_m: int = 0,
    skip_n: int = 0,
    logger: Optional[Logger] = None,
    write_artifacts: bool = True,
) -> ColorIndex:
    """Index one FASTA into the standard artifacts, grouping records by the
    names file.  ``mode``: kmers | skipmers | protein."""
    log = logger or Logger(quiet=True)
    names = read_names_file(names_file)

    group_order: List[str] = []
    group_of: Dict[str, int] = {}
    group_hashes: Dict[int, List[np.ndarray]] = {}
    for header, group in names.items():
        if group not in group_of:
            group_of[group] = len(group_order)
            group_order.append(group)

    if mode == "kmers":
        hash_mode = int(
            HashingMode.integer_hasher
            if canonical
            else HashingMode.nonCanonicalInteger_Hasher
        )
        slicing = int(SlicingMode.KMERS)
    elif mode == "skipmers":
        hash_mode = int(HashingMode.integer_hasher)
        slicing = int(SlicingMode.SKIPMERS)
    elif mode == "protein":
        hash_mode = int(
            HashingMode.proteinDayhoff_hasher if dayhoff else HashingMode.protein_hasher
        )
        slicing = int(SlicingMode.PROTEIN)
    else:
        raise ValueError(f"unknown mode {mode}")

    skipped = 0
    for name, seq in fastx.read_records(fasta_file):
        if name not in names:
            skipped += 1
            continue
        gid = group_of[names[name]]
        if mode == "kmers":
            h = hashing.kmer_hashes_integer(seq, ksize, canonical=canonical)
        elif mode == "skipmers":
            h = _skipmer_codes(seq, skip_m, skip_n, ksize)
            h = hashing.integer_hash(h, ksize) if len(h) else h
        else:  # protein
            h = hashing.protein_kmer_codes(seq, ksize, dayhoff=dayhoff)
        group_hashes.setdefault(gid, []).append(h)

    if skipped:
        log.WARNING(f"{skipped} FASTA records not present in the names file; skipped")

    hash_arrays: List[Optional[np.ndarray]] = []
    for gid in range(len(group_order)):
        parts = group_hashes.get(gid)
        if parts:
            hash_arrays.append(np.unique(np.concatenate(parts)))
        else:
            hash_arrays.append(np.empty(0, dtype=np.uint64))

    if mode == "skipmers":
        params = f"m:{skip_m},n:{skip_n},k:{ksize}"
    else:
        params = f"kSize:{ksize}"

    index = build_index_from_hash_sets(
        group_order,
        hash_arrays,
        ksize=ksize,
        hash_mode=hash_mode,
        slicing_mode=slicing,
        params=params,
    )
    if write_artifacts:
        artifacts_io.write_index_artifacts(output_prefix, index)
    return index
