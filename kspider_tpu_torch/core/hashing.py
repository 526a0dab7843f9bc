"""K-mer encoding and hashing (vectorized numpy).

The reference delegates hashing to the (absent) kProcessor/kmerDecoder
submodule; its call sites use ``mumur_hasher`` for sketches
(kSpider/src/fastx_to_kf.cpp:24) and ``integer_hasher`` /
``nonCanonicalInteger_Hasher`` for FASTA indexing
(kSpider/src/index.cpp:54-60).  We re-derive:

- ``murmur3_64``: first 64 bits of MurmurHash3_x64_128.  The sourmash
  ecosystem hashes the canonical k-mer *string* with this function at
  seed 42 — the convention that makes our sketches interoperable with
  sourmash ``mins``; ``kmer_hashes_sourmash`` implements it.
- ``murmur64``: MurmurHash64A (the 64-bit Appleby hash), used for the
  kProcessor-style ``murmur_int`` hasher.
- ``integer_hash``: the invertible Thomas-Wang 64-bit mix used by
  MQF-family tools, masked to 2k bits, applied to the canonical 2-bit
  k-mer encoding.
- dayhoff/protein encodings for the protein path
  (kSpider/src/fastx_to_kf.cpp:170-213).

Encoding order A<C<G<T matches ASCII order, so lexicographic canonical
selection equals numeric comparison of the 2-bit encodings.
"""

from typing import Optional, Tuple

import numpy as np

_M = np.uint64(0xC6A4A7935BD1E995)
_R = np.uint64(47)

# base -> 2-bit code; 255 = invalid
_CODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
for i, b in enumerate(b"acgt"):
    _CODE[b] = i

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in [(ord("A"), ord("T")), (ord("C"), ord("G"))]:
    _COMPLEMENT[a], _COMPLEMENT[b] = b, a
    la, lb = a + 32, b + 32
    _COMPLEMENT[la], _COMPLEMENT[lb] = lb, la
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] -= 32


def murmur64(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    """MurmurHash64A over each row of a (n, length) uint8 matrix."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, length = rows.shape
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64(seed) ^ (np.uint64(length) * _M), dtype=np.uint64)
        nblocks = length // 8
        if nblocks:
            blocks = (
                rows[:, : nblocks * 8]
                .reshape(n, nblocks, 8)
                .view("<u8")
                .reshape(n, nblocks)
            )
            for i in range(nblocks):
                k = blocks[:, i].copy()
                k *= _M
                k ^= k >> _R
                k *= _M
                h ^= k
                h *= _M
        tail = length & 7
        if tail:
            t = np.zeros(n, dtype=np.uint64)
            base = nblocks * 8
            for i in range(tail - 1, -1, -1):
                t = (t << np.uint64(8)) | rows[:, base + i].astype(np.uint64)
            h ^= t
            h *= _M
        h ^= h >> _R
        h *= _M
        h ^= h >> _R
    return h


_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _fmix64(k: np.ndarray) -> np.ndarray:
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xFF51AFD7ED558CCD)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xC4CEB9FE1A85EC53)
    k ^= k >> np.uint64(33)
    return k


def murmur3_64(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    """First 64 bits of MurmurHash3_x64_128 over each row of a (n, length)
    uint8 matrix — the hash sourmash applies to canonical k-mer strings
    (seed 42).  Checked in tests against an independent scalar
    implementation of the canonical smhasher algorithm."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, length = rows.shape
    with np.errstate(over="ignore"):
        h1 = np.full(n, np.uint64(seed))
        h2 = np.full(n, np.uint64(seed))
        nblocks = length // 16
        if nblocks:
            blocks = (
                rows[:, : nblocks * 16]
                .reshape(n, nblocks * 2, 8)
                .view("<u8")
                .reshape(n, nblocks, 2)
            )
            for i in range(nblocks):
                k1 = blocks[:, i, 0].copy()
                k2 = blocks[:, i, 1].copy()
                k1 *= _C1
                k1 = _rotl64(k1, 31)
                k1 *= _C2
                h1 ^= k1
                h1 = _rotl64(h1, 27)
                h1 += h2
                h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
                k2 *= _C2
                k2 = _rotl64(k2, 33)
                k2 *= _C1
                h2 ^= k2
                h2 = _rotl64(h2, 31)
                h2 += h1
                h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)
        tail = length & 15
        base = nblocks * 16
        if tail > 8:
            k2 = np.zeros(n, dtype=np.uint64)
            for i in range(tail - 1, 7, -1):
                k2 = (k2 << np.uint64(8)) | rows[:, base + i].astype(np.uint64)
            k2 *= _C2
            k2 = _rotl64(k2, 33)
            k2 *= _C1
            h2 ^= k2
        if tail > 0:
            k1 = np.zeros(n, dtype=np.uint64)
            for i in range(min(tail, 8) - 1, -1, -1):
                k1 = (k1 << np.uint64(8)) | rows[:, base + i].astype(np.uint64)
            k1 *= _C1
            k1 = _rotl64(k1, 31)
            k1 *= _C2
            h1 ^= k1
        h1 ^= np.uint64(length)
        h2 ^= np.uint64(length)
        h1 += h2
        h2 += h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 += h2
    return h1


def integer_hash(kmers: np.ndarray, ksize: int) -> np.ndarray:
    """Invertible Thomas-Wang 64-bit mix masked to 2k bits (MQF-style).

    For 2k >= 64 the mask saturates to the full 64-bit space.
    """
    mask = np.uint64((1 << min(64, 2 * ksize)) - 1)
    key = np.asarray(kmers, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


def _windows(seq_bytes: np.ndarray, k: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(seq_bytes, k)


def kmer_windows(
    sequence: str, ksize: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (fwd_windows, rc_windows, valid_mask) over a DNA sequence.

    Windows are (n, k) uint8 byte matrices (uppercased); windows containing
    any non-ACGT character are flagged invalid.
    """
    raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    raw = _UPPER[raw]
    if len(raw) < ksize:
        empty = np.empty((0, ksize), dtype=np.uint8)
        return empty, empty, np.empty(0, dtype=bool)
    fwd = _windows(raw, ksize)
    ok = _CODE[raw] != 255
    valid = (
        _windows(ok.astype(np.uint8), ksize).min(axis=1).astype(bool)
        if len(ok) >= ksize
        else np.empty(0, dtype=bool)
    )
    rc_full = _COMPLEMENT[raw][::-1]
    rc = _windows(rc_full, ksize)[::-1]
    return fwd, rc, valid


def encode_2bit(windows: np.ndarray) -> np.ndarray:
    """(n, k) uint8 base matrix -> u64 2-bit encodings (k <= 31)."""
    codes = _CODE[windows].astype(np.uint64)
    n, k = windows.shape
    out = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | codes[:, i]
    return out


def canonical_kmers(sequence: str, ksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical (min of forward/revcomp) k-mer windows and 2-bit codes.

    Returns ``(canonical_windows (n,k) uint8, canonical_codes u64[n])`` for
    the valid windows only.
    """
    fwd, rc, valid = kmer_windows(sequence, ksize)
    fwd = fwd[valid]
    rc = rc[valid]
    if len(fwd) == 0:
        return fwd, np.empty(0, dtype=np.uint64)
    f_codes = encode_2bit(fwd)
    r_codes = encode_2bit(rc)
    use_rc = r_codes < f_codes
    canon = np.where(use_rc[:, None], rc, fwd)
    codes = np.where(use_rc, r_codes, f_codes)
    return canon, codes


def kmer_hashes_sourmash(sequence: str, ksize: int) -> np.ndarray:
    """sourmash-convention hashes: first 64 bits of
    MurmurHash3_x64_128(canonical kmer string, seed=42) — interoperable
    with hashes in real sourmash ``.sig`` files."""
    canon, _ = canonical_kmers(sequence, ksize)
    if len(canon) == 0:
        return np.empty(0, dtype=np.uint64)
    return murmur3_64(canon, seed=42)


def kmer_hashes_integer(
    sequence: str, ksize: int, canonical: bool = True
) -> np.ndarray:
    """kProcessor-style integer-hash values over 2-bit k-mer codes."""
    if canonical:
        _, codes = canonical_kmers(sequence, ksize)
    else:
        fwd, _, valid = kmer_windows(sequence, ksize)
        codes = encode_2bit(fwd[valid])
    if len(codes) == 0:
        return np.empty(0, dtype=np.uint64)
    return integer_hash(codes, ksize)


def kmer_hashes_murmur_int(
    sequence: str, ksize: int, seed: int = 42, canonical: bool = True
) -> np.ndarray:
    """MurmurHash64A over the 8-byte little-endian 2-bit k-mer code.

    This mirrors the reference's ``mumur_hasher`` applied to the integer
    k-mer representation (kSpider/src/fastx_to_kf.cpp:24) — the
    MQF/squeakr-lineage convention kmerDecoder descends from.  The exact
    kProcessor seed is **documented unverifiable** (PARITY.md "Known
    gaps"): the hasher lives in the absent kmerDecoder submodule and the
    snapshot ships no kProcessor-produced sketch to pin it against, so
    the seed stays a parameter.  The gap is contained: stored hashes in
    ``.phmap``/``.bin``/``.sig`` artifacts are never recomputed, so all
    cross-implementation artifact flows are seed-independent.
    """
    if canonical:
        _, codes = canonical_kmers(sequence, ksize)
    else:
        fwd, _, valid = kmer_windows(sequence, ksize)
        codes = encode_2bit(fwd[valid])
    if len(codes) == 0:
        return np.empty(0, dtype=np.uint64)
    return murmur64(codes[:, None].view(np.uint8).reshape(-1, 8), seed=seed)


# --------------------------------------------------------------------------
# Protein / Dayhoff encodings (reference: src/fastx_to_kf.cpp:170-213 uses
# 5-bit packed protein k-mers; dayhoff compresses to 6 groups).
# --------------------------------------------------------------------------

_AA = "ACDEFGHIKLMNPQRSTVWY"
_AA_CODE = np.full(256, 255, dtype=np.uint8)
for i, ch in enumerate(_AA):
    _AA_CODE[ord(ch)] = i
    _AA_CODE[ord(ch.lower())] = i

_DAYHOFF_GROUPS = {
    "a": "AGPST",  # small
    "b": "C",  # sulfur
    "c": "DENQ",  # acid/amide
    "d": "FWY",  # aromatic
    "e": "HKR",  # basic
    "f": "ILMV",  # hydrophobic
}
_DAYHOFF_CODE = np.full(256, 255, dtype=np.uint8)
for gi, (_, members) in enumerate(sorted(_DAYHOFF_GROUPS.items())):
    for ch in members:
        _DAYHOFF_CODE[ord(ch)] = gi
        _DAYHOFF_CODE[ord(ch.lower())] = gi


def protein_kmer_codes(
    sequence: str, ksize: int, dayhoff: bool = False
) -> np.ndarray:
    """5-bit packed protein k-mer codes (valid windows only).

    5 bits/residue caps k at 12 (5k <= 64); the reference shares this
    limit implicitly through its u64 packing.
    """
    if ksize > 12:
        raise ValueError("protein k-mer size must be <= 12 (5-bit packing)")
    table = _DAYHOFF_CODE if dayhoff else _AA_CODE
    raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    if len(raw) < ksize:
        return np.empty(0, dtype=np.uint64)
    codes = table[raw]
    win = _windows(codes, ksize)
    valid = win.max(axis=1) != 255
    win = win[valid].astype(np.uint64)
    out = np.zeros(len(win), dtype=np.uint64)
    for i in range(ksize):
        out = (out << np.uint64(5)) | win[:, i]
    return out
