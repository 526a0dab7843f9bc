"""Directory-level index builds: sourmash sig dirs, .bin dirs, .phmap dirs.

Counterpart of ``kspider_tpu/core/dataset.py``, whose device build imports
jax.  Each function reads its directory exactly as the JAX package's does,
then builds with the host lexsort (``device=None``) or with the postings
sort on a torch device (:func:`kspider_tpu_torch.core.index.build_index_device`),
and writes the same five artifacts.  The readers and writers (``sigs``,
``phmap``, ``artifacts``) and ``dir_prefix_of`` are the JAX package's
jax-free modules.
"""

import functools
import os
from typing import List, Optional

import numpy as np

from kspider_tpu.core.constants import HashingMode, SlicingMode
from kspider_tpu.core.dataset import dir_prefix_of
from kspider_tpu.core.index import ColorIndex, build_index_from_hash_sets
from kspider_tpu.io import artifacts as artifacts_io
from kspider_tpu.io import phmap as phmap_io
from kspider_tpu.io import sigs as sigs_io
from kspider_tpu.utils.logger import Logger
from kspider_tpu_torch.core.index import build_index_device


def _build(names, hash_arrays, *, ksize, device, output_prefix, default_prefix,
           write_artifacts, kmer_counts=None) -> ColorIndex:
    """Build with the host lexsort or on ``device``; write the artifacts."""
    builder = (build_index_from_hash_sets if device is None
               else functools.partial(build_index_device, device=device))
    index = builder(
        names,
        hash_arrays,
        kmer_counts=kmer_counts,
        ksize=ksize,
        hash_mode=int(HashingMode.mumur_hasher),
        slicing_mode=int(SlicingMode.KMERS),
        params=f"kSize:{ksize}",
    )
    if write_artifacts:
        artifacts_io.write_index_artifacts(output_prefix or default_prefix, index)
    return index


def index_sigs_dir(
    sigs_dir: str,
    ksize: int,
    output_prefix: Optional[str] = None,
    logger: Optional[Logger] = None,
    write_artifacts: bool = True,
    device=None,
) -> ColorIndex:
    """Index every ``.sig`` in a directory at the given k (the JAX package's
    two-pass group ids and raw ``mins`` k-mer counts)."""
    log = logger or Logger(quiet=True)
    pass1, pass2 = sigs_io.scan_sigs_dir(sigs_dir)
    if not pass1:
        raise FileNotFoundError(f"no signature files found in {sigs_dir}")

    names: List[str] = []
    name_to_gid = {}
    for p in pass1:
        base = sigs_io.sig_basename(p)
        if base not in name_to_gid:
            name_to_gid[base] = len(names)
            names.append(base)

    hash_arrays: List[Optional[np.ndarray]] = [None] * len(names)
    kmer_counts: List[Optional[int]] = [None] * len(names)
    for i, p in enumerate(pass2):
        base = sigs_io.sig_basename(p)
        gid = name_to_gid[base]
        mins = sigs_io.load_sig_mins(p, ksize)
        if mins is None:
            log.WARNING(f"{p}: no signature entry with ksize={ksize}; skipped")
            continue
        log.INFO(f"Processing {i + 1}/{len(pass2)} | {base} k:{ksize}")
        hash_arrays[gid] = mins
        kmer_counts[gid] = len(mins)

    return _build(names, hash_arrays, kmer_counts=kmer_counts, ksize=ksize,
                  device=device, output_prefix=output_prefix,
                  default_prefix=dir_prefix_of(sigs_dir),
                  write_artifacts=write_artifacts)


def index_kf_dir(
    kfs_dir: str,
    output_prefix: Optional[str] = None,
    logger: Optional[Logger] = None,
    write_artifacts: bool = True,
    device=None,
) -> ColorIndex:
    """Index a directory of kProcessor-style ``.phmap`` sketches; kSize comes
    from the first sketch's ``.extra``.  ``.mqf`` sketches raise, as in the
    JAX package (their layout is internal to kProcessor)."""
    log = logger or Logger(quiet=True)
    entries = sorted(os.path.join(kfs_dir, e) for e in os.listdir(kfs_dir))
    prefixes = []
    for p in entries:
        if p.endswith(".mqf"):
            raise ValueError(
                f"{p}: .mqf (counting-quotient-filter) sketches are not "
                "supported — the CQF serialization is internal to the "
                "kProcessor/MQF submodules, which are absent from the "
                "reference snapshot; re-sketch with `kspider sketch` "
                "(.sig/.bin) or use .phmap sketches"
            )
        if p.endswith(".phmap"):
            prefixes.append(p[: -len(".phmap")])
    if not prefixes:
        raise FileNotFoundError(f"no .phmap sketches found in {kfs_dir}")

    detected_ksize = 0
    extra = prefixes[0] + ".extra"
    if os.path.exists(extra):
        with open(extra) as f:
            for line in f:
                try:
                    detected_ksize = int(line.strip().split()[0])
                    break
                except (ValueError, IndexError):
                    continue
    log.INFO(f"Detected kSize: {detected_ksize}")

    names, hash_arrays = [], []
    for i, pref in enumerate(prefixes):
        hashes, _counts = phmap_io.read_phmap_sketch(pref)
        base = os.path.basename(pref)
        log.INFO(f"Processing {i + 1}/{len(prefixes)} | {base} ({len(hashes)} kmers)")
        names.append(base)
        hash_arrays.append(hashes)

    return _build(names, hash_arrays, ksize=detected_ksize, device=device,
                  output_prefix=output_prefix,
                  default_prefix=dir_prefix_of(kfs_dir),
                  write_artifacts=write_artifacts)


def index_bins_dir(
    bins_dir: str,
    ksize: int,
    output_prefix: Optional[str] = None,
    logger: Optional[Logger] = None,
    write_artifacts: bool = True,
    device=None,
) -> ColorIndex:
    """Index every ``.bin`` (phmap hash-set dump) in a directory; other
    files are skipped with a warning."""
    log = logger or Logger(quiet=True)
    entries = sorted(os.path.join(bins_dir, e) for e in os.listdir(bins_dir))
    names: List[str] = []
    paths: List[str] = []
    for p in entries:
        if not os.path.isfile(p):
            continue
        if not p.endswith(".bin"):
            log.WARNING(f"skipping {p} does not have extension .bin")
            continue
        names.append(sigs_io.sig_basename(p))
        paths.append(p)
    if not names:
        raise FileNotFoundError(f"no .bin files found in {bins_dir}")

    hash_arrays: List[Optional[np.ndarray]] = []
    for i, p in enumerate(paths):
        hashes = phmap_io.read_hash_set(p)
        log.INFO(f"Processing {i + 1}/{len(paths)} | {names[i]} ({len(hashes)} kmers)")
        hash_arrays.append(hashes)

    return _build(names, hash_arrays, ksize=ksize, device=device,
                  output_prefix=output_prefix,
                  default_prefix=dir_prefix_of(bins_dir),
                  write_artifacts=write_artifacts)
