"""FracMinHash sketching of FASTA/FASTQ inputs.

Behavioral mirror of the reference sketch stage
(kSpider/src/fastx_to_kf.cpp): stream records, hash every k-mer,
keep hashes below ``UINT64_MAX / ratio`` (the downsampling rule at
:30,50,63), optionally drop singletons (count == 1; :81-95).  Paired-end
mode consumes R1/R2 in lockstep and derives the output basename from R1
truncated at the first underscore (:20-22).

Divergence from the reference, by design: kProcessor's ``.phmap``/``.mqf``
serialization is not reproducible (submodule absent), so sketches are
persisted as sourmash-compatible ``.sig`` JSON or phmap-dump ``.bin`` hash
sets — both of which the indexing stage (and the reference's own
bins/sourmash paths) consume directly.  Hashing defaults to the sourmash
convention (first 64 bits of MurmurHash3_x64_128 of the canonical k-mer
string at seed 42, pinned to sourmash's own test vectors) for ecosystem
interop; kProcessor-style integer and MurmurHash64A hashing are available
via ``hasher=``.
"""

import os
from collections import Counter
from typing import Iterable, List, Optional, Tuple

import numpy as np

from kspider_tpu_torch.core import hashing
from kspider_tpu_torch.io import fastx

UINT64_MAX = (1 << 64) - 1

HASHERS = {
    "sourmash": hashing.kmer_hashes_sourmash,
    "integer": lambda seq, k: hashing.kmer_hashes_integer(seq, k, canonical=True),
    "integer_noncanonical": lambda seq, k: hashing.kmer_hashes_integer(
        seq, k, canonical=False
    ),
    "murmur_int": lambda seq, k: hashing.kmer_hashes_murmur_int(seq, k),
}


class SketchResult:
    def __init__(self, hashes: np.ndarray, total_kmers: int, inserted_kmers: int):
        self.hashes = hashes
        self.total_kmers = total_kmers
        self.inserted_kmers = inserted_kmers


def _sketch_streams(
    seq_iters: List[Iterable[Tuple[str, str]]],
    ksize: int,
    scale: int,
    hasher: str,
    remove_singletons: bool,
) -> SketchResult:
    hash_fn = HASHERS[hasher]
    max_hash = UINT64_MAX // max(1, int(scale))
    keep_all = int(scale) <= 1
    total = 0
    inserted = 0
    counts: Counter = Counter()
    chunks: List[np.ndarray] = []
    for it in seq_iters:
        for _, seq in it:
            h = hash_fn(seq, ksize)
            total += len(h)
            if not keep_all:
                h = h[h < max_hash]
            inserted += len(h)
            if remove_singletons:
                counts.update(h.tolist())
            else:
                chunks.append(h)
    if remove_singletons:
        kept = np.array(
            [k for k, c in counts.items() if c > 1], dtype=np.uint64
        )
        hashes = np.sort(kept)
    else:
        hashes = (
            np.unique(np.concatenate(chunks))
            if chunks
            else np.empty(0, dtype=np.uint64)
        )
    return SketchResult(hashes, total, inserted)


def _native_sketch(path: str, ksize: int, scale: int):
    """Native C++ fast path (sourmash hashing, no singleton filtering).

    Failures are never silent: under KSPIDER_NATIVE=auto a one-time
    RuntimeWarning is emitted and the numpy path takes over; under
    KSPIDER_NATIVE=force the failure raises."""
    from kspider_tpu_torch.io import native

    if not native.enabled():
        return None
    try:
        if not native.available():
            raise RuntimeError(
                f"native library failed to load: {native.load_error()!r}"
            )
        return native.sketch_file(path, ksize, scale)
    except native.NativeRequiredError:
        raise
    except Exception as exc:
        native.report_fallback("sketch_file", exc)
    return None


def sketch_single_end(
    path: str,
    ksize: int,
    scale: int = 1,
    hasher: str = "sourmash",
    remove_singletons: bool = False,
) -> SketchResult:
    if hasher == "sourmash" and not remove_singletons:
        nat = _native_sketch(path, ksize, scale)
        if nat is not None:
            hashes, total, inserted = nat
            return SketchResult(hashes, total, inserted)
    return _sketch_streams(
        [fastx.read_records(path)], ksize, scale, hasher, remove_singletons
    )


def sketch_paired_end(
    r1_path: str,
    r2_path: str,
    ksize: int,
    scale: int = 1,
    hasher: str = "sourmash",
    remove_singletons: bool = False,
) -> SketchResult:
    if hasher == "sourmash" and not remove_singletons:
        nat1 = _native_sketch(r1_path, ksize, scale)
        nat2 = _native_sketch(r2_path, ksize, scale)
        if nat1 is not None and nat2 is not None:
            h1, t1, i1 = nat1
            h2, t2, i2 = nat2
            return SketchResult(np.union1d(h1, h2), t1 + t2, i1 + i2)
    return _sketch_streams(
        [fastx.read_records(r1_path), fastx.read_records(r2_path)],
        ksize,
        scale,
        hasher,
        remove_singletons,
    )


def sketch_protein(
    path: str,
    ksize: int,
    dayhoff: bool = False,
    scale: int = 1,
) -> SketchResult:
    """Protein sketching: insert the 5-bit packed representation, with the
    downsampling threshold derived through the integer hash of the packed
    code (reference: kSpider/src/fastx_to_kf.cpp:177-199 inserts
    the 5-bit repr, not the hash)."""
    # reference: IntegerHasher(k*5/2) => TW mix masked to 2^(5k) bits,
    # threshold = hash(2^(k*5/2)) / ratio (kSpider/src/fastx_to_kf.cpp:177-185)
    hasher_ksize = (ksize * 5) // 2  # "kSize" arg of IntegerHasher
    total = 0
    inserted = 0
    chunks: List[np.ndarray] = []
    if int(scale) <= 1:
        max_hash = UINT64_MAX
    else:
        max_real = int(
            hashing.integer_hash(
                np.array([1 << hasher_ksize], dtype=np.uint64), hasher_ksize
            )[0]
        )
        max_hash = max_real // int(scale)
    for _, seq in fastx.read_records(path):
        codes = hashing.protein_kmer_codes(seq, ksize, dayhoff=dayhoff)
        total += len(codes)
        if int(scale) > 1:
            hs = hashing.integer_hash(codes, hasher_ksize)
            codes = codes[hs < max_hash]
        inserted += len(codes)
        chunks.append(codes)
    hashes = (
        np.unique(np.concatenate(chunks)) if chunks else np.empty(0, dtype=np.uint64)
    )
    return SketchResult(hashes, total, inserted)


def paired_end_basename(r1_path: str) -> str:
    """Reference rule: basename truncated at the first '_'
    (kSpider/src/fastx_to_kf.cpp:20-22)."""
    base = os.path.basename(r1_path)
    return base.split("_", 1)[0]
