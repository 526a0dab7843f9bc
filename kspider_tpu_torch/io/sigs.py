"""Sourmash signature (``.sig`` JSON) reading and writing.

The reference parses sig files with a vendored C++ JSON parser through a
gzip-aware stream (kSpider/src/sourmash_indexing.cpp:154-191): it
takes ``json[0]["signatures"]`` and uses the *first* entry whose ``ksize``
matches the selected k, reading its ``mins`` array as the pre-hashed k-mer
stream.  ``sig_to_bin`` additionally filters by ``abundances >=
min_abundance`` (kSpider/sig_to_bin.cpp:44-54), and only inspects
the first signature entry.

We mirror those selection semantics here on top of the stdlib json module.
"""

import gzip
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _open_maybe_gzip(path):
    # zstr::ifstream sniffs the gzip magic regardless of extension; do the same.
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def sig_basename(path: str) -> str:
    """Strip directory and the *last* extension only, like the reference
    (``file_name.substr(0, file_name.find_last_of("."))`` at
    kSpider/src/sourmash_indexing.cpp:87-89) — so ``x.sig.gz``
    becomes ``x.sig``."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot != -1 else base


def load_signatures(path) -> List[dict]:
    """Load the raw signature entry list ``json[0]["signatures"]``."""
    with _open_maybe_gzip(path) as f:
        data = json.load(f)
    return data[0]["signatures"]


def load_sig_mins(
    path, ksize: int, min_abundance: Optional[int] = None, first_entry_only: bool = False
) -> Optional[np.ndarray]:
    """Return the ``mins`` of the first ksize-matching signature as u64.

    ``first_entry_only`` replicates ``sig_to_bin``'s quirk of only ever
    looking at the first signature entry (kSpider/sig_to_bin.cpp:41-57:
    the loop breaks unconditionally after the first element).  Returns None
    when no entry matches.
    """
    sigs = load_signatures(path)
    if first_entry_only:
        sigs = sigs[:1]
    for entry in sigs:
        if entry.get("ksize") != ksize:
            continue
        mins = np.asarray(entry["mins"], dtype=np.uint64)
        if min_abundance is not None and min_abundance > 1:
            abund = np.asarray(entry["abundances"], dtype=np.int64)
            mins = mins[abund >= min_abundance]
        return mins
    return None


def write_sig(
    path,
    name: str,
    mins: Sequence[int],
    ksize: int,
    abundances: Optional[Sequence[int]] = None,
    scaled: int = 1000,
) -> None:
    """Write a minimal sourmash-compatible signature JSON file."""
    entry = {
        "num": 0,
        "ksize": int(ksize),
        "seed": 42,
        "max_hash": (1 << 64) // int(scaled) if scaled else 0,
        "mins": [int(x) for x in mins],
        "md5sum": "0" * 32,
        "molecule": "DNA",
    }
    if abundances is not None:
        entry["abundances"] = [int(a) for a in abundances]
    doc = [
        {
            "class": "sourmash_signature",
            "email": "",
            "hash_function": "0.murmur64",
            "filename": os.path.basename(str(path)),
            "name": name,
            "license": "CC0",
            "signatures": [entry],
            "version": 0.4,
        }
    ]
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(doc, f)


def scan_sigs_dir(sigs_dir: str) -> Tuple[List[str], List[str]]:
    """Replicate the reference's two-pass directory scan semantics.

    Pass 1 (group-id assignment, kSpider/src/sourmash_indexing.cpp:85-117)
    accepts extensions ``.sig`` and ``.gz``; pass 2 (k-mer ingestion, :141-152)
    accepts only ``.sig``.  Group ids are assigned 1..N in sorted-glob order
    over the pass-1 set.  Returns ``(pass1_paths, pass2_paths)``.
    """
    entries = sorted(
        os.path.join(sigs_dir, e) for e in os.listdir(sigs_dir)
    )
    pass1, pass2 = [], []
    for p in entries:
        if not os.path.isfile(p):
            continue
        ext = p.rsplit(".", 1)[-1] if "." in os.path.basename(p) else ""
        if ext in ("sig", "gz"):
            pass1.append(p)
        if ext == "sig":
            pass2.append(p)
    return pass1, pass2
