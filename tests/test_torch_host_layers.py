"""The port's own host layers against the JAX package's originals.

kspider_tpu_torch keeps copies of kspider_tpu's jax-free host modules
(hashing, sketch, phmap/sig/FASTX IO, index build and artifacts, the npz
cache, the pairwise-TSV reader, the ctypes bridge to ``native/``, ANI,
export, the logger and timers).  On the same seeded inputs every copy must
give what its original gives: equal arrays, equal ColorIndex fields and
byte-equal files.  Tolerance: exact equality throughout.
"""

import filecmp
import gzip
import os

import numpy as np
import pytest

from kspider_tpu.core import constants as j_constants
from kspider_tpu.core import fasta_index as j_fasta_index
from kspider_tpu.core import hashing as j_hashing
from kspider_tpu.core import index as j_index
from kspider_tpu.core import sketch as j_sketch
from kspider_tpu.core.dataset import dir_prefix_of as j_dir_prefix_of
from kspider_tpu.io import artifacts as j_artifacts
from kspider_tpu.io import fastx as j_fastx
from kspider_tpu.io import native as j_native
from kspider_tpu.io import npz_index as j_npz
from kspider_tpu.io import pairwise_tsv as j_tsv
from kspider_tpu.io import phmap as j_phmap
from kspider_tpu.io import sigs as j_sigs
from kspider_tpu.models import ani as j_ani
from kspider_tpu.models import export as j_export
from kspider_tpu.utils import logger as j_logger
from kspider_tpu.utils import timing as j_timing
from kspider_tpu_torch.core import constants as t_constants
from kspider_tpu_torch.core import fasta_index as t_fasta_index
from kspider_tpu_torch.core import hashing as t_hashing
from kspider_tpu_torch.core import index as t_index
from kspider_tpu_torch.core import sketch as t_sketch
from kspider_tpu_torch.core.dataset import dir_prefix_of as t_dir_prefix_of
from kspider_tpu_torch.io import artifacts as t_artifacts
from kspider_tpu_torch.io import fastx as t_fastx
from kspider_tpu_torch.io import native as t_native
from kspider_tpu_torch.io import npz_index as t_npz
from kspider_tpu_torch.io import pairwise_tsv as t_tsv
from kspider_tpu_torch.io import phmap as t_phmap
from kspider_tpu_torch.io import sigs as t_sigs
from kspider_tpu_torch.models import ani as t_ani
from kspider_tpu_torch.models import export as t_export
from kspider_tpu_torch.utils import logger as t_logger
from kspider_tpu_torch.utils import timing as t_timing

INDEX_FIELDS = ("names", "group_kmer_count", "color_ids", "color_offsets",
                "color_members", "color_counts", "ksize", "hash_mode",
                "slicing_mode", "params")
ARTIFACTS = ("_groupID_to_kmerCount.bin", "_color_to_sources.bin",
             "_color_count.bin", ".namesMap", ".extra")


def assert_same_index(a, b):
    """ColorIndex fields, compared one by one (the two packages' classes
    differ)."""
    assert type(a).__module__.startswith("kspider_tpu.")
    assert type(b).__module__.startswith("kspider_tpu_torch.")
    for f in INDEX_FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert (a.num_groups, a.num_colors, a.num_kmers) == \
        (b.num_groups, b.num_colors, b.num_kmers)


def dna(rng, n, with_n=True):
    alphabet = list("ACGTacgt" + ("N" if with_n else ""))
    return "".join(rng.choice(alphabet, size=n))


def write_fasta(path, records, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


def hash_sets(seed, n=9, pool=3000):
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(0, 2**64 - 1, size=pool, dtype=np.uint64,
                                      endpoint=True))
    arrays = [universe[rng.random(len(universe)) < rng.uniform(0.05, 0.4)]
              for _ in range(n)]
    arrays[n // 2] = None  # a registered but never ingested group
    return [f"s{i}" for i in range(n)], arrays


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

HASHERS = [
    ("kmer_hashes_sourmash", {}),
    ("kmer_hashes_integer", {"canonical": True}),
    ("kmer_hashes_integer", {"canonical": False}),
    ("kmer_hashes_murmur_int", {}),
    ("kmer_hashes_murmur_int", {"seed": 7, "canonical": False}),
]


@pytest.mark.parametrize("ksize", [7, 21, 31])
@pytest.mark.parametrize("name,kwargs", HASHERS,
                         ids=[f"{n}-{k}" for n, k in HASHERS])
def test_kmer_hashes_equal(name, kwargs, ksize):
    rng = np.random.default_rng(ksize)
    for _ in range(3):
        seq = dna(rng, int(rng.integers(ksize - 1, 400)))
        want = getattr(j_hashing, name)(seq, ksize, **kwargs)
        got = getattr(t_hashing, name)(seq, ksize, **kwargs)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("fn", ["murmur64", "murmur3_64"])
@pytest.mark.parametrize("length", [3, 8, 21, 64])
def test_row_hashes_equal(fn, length):
    rows = np.random.default_rng(length).integers(0, 256, size=(300, length),
                                                  dtype=np.uint8)
    for seed in (42, 0, 2**40 + 1):
        assert np.array_equal(getattr(t_hashing, fn)(rows, seed),
                              getattr(j_hashing, fn)(rows, seed))


@pytest.mark.parametrize("ksize", [11, 21, 31])
def test_integer_hash_and_2bit_codes_equal(ksize):
    rng = np.random.default_rng(100 + ksize)
    kmers = rng.integers(0, 2**(2 * ksize), size=500, dtype=np.uint64)
    assert np.array_equal(t_hashing.integer_hash(kmers, ksize),
                          j_hashing.integer_hash(kmers, ksize))
    seq = dna(rng, 300)
    for a, b in zip(t_hashing.canonical_kmers(seq, ksize),
                    j_hashing.canonical_kmers(seq, ksize)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ksize,dayhoff", [(5, False), (8, True), (12, False)])
def test_protein_codes_equal(ksize, dayhoff):
    rng = np.random.default_rng(ksize)
    seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYX*"), size=300))
    assert np.array_equal(
        t_hashing.protein_kmer_codes(seq, ksize, dayhoff=dayhoff),
        j_hashing.protein_kmer_codes(seq, ksize, dayhoff=dayhoff))


def test_constants_equal():
    for enum_name in ("HashingMode", "SlicingMode"):
        j, t = getattr(j_constants, enum_name), getattr(t_constants, enum_name)
        assert [(m.name, int(m)) for m in j] == [(m.name, int(m)) for m in t]


# ---------------------------------------------------------------------------
# sketches and FASTX
# ---------------------------------------------------------------------------

@pytest.fixture
def reads(tmp_path):
    rng = np.random.default_rng(3)
    genome = dna(rng, 5000, with_n=False)
    recs = []
    for i in range(60):
        start = int(rng.integers(0, len(genome) - 150))
        recs.append((f"r{i}", genome[start:start + int(rng.integers(40, 150))]))
    r1, r2 = tmp_path / "lib_R1.fa", tmp_path / "lib_R2.fa.gz"
    write_fasta(r1, recs[:30])
    write_fasta(r2, recs[30:], gz=True)
    return str(r1), str(r2)


@pytest.mark.parametrize("hasher,scale,singletons", [
    ("sourmash", 1, False), ("sourmash", 10, False), ("sourmash", 1, True),
    ("integer", 1, False), ("murmur_int", 5, True),
])
def test_sketches_equal(reads, hasher, scale, singletons):
    r1, r2 = reads
    for want, got in (
        (j_sketch.sketch_single_end(r1, 21, scale, hasher, singletons),
         t_sketch.sketch_single_end(r1, 21, scale, hasher, singletons)),
        (j_sketch.sketch_paired_end(r1, r2, 21, scale, hasher, singletons),
         t_sketch.sketch_paired_end(r1, r2, 21, scale, hasher, singletons)),
    ):
        assert np.array_equal(got.hashes, want.hashes)
        assert (got.total_kmers, got.inserted_kmers) == \
            (want.total_kmers, want.inserted_kmers)
    assert t_sketch.paired_end_basename(r1) == j_sketch.paired_end_basename(r1)


@pytest.mark.parametrize("dayhoff,scale", [(False, 1), (True, 3)])
def test_protein_sketch_equal(tmp_path, dayhoff, scale):
    rng = np.random.default_rng(5)
    path = tmp_path / "p.fa"
    write_fasta(path, [(f"p{i}", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                                     size=120)))
                       for i in range(8)])
    want = j_sketch.sketch_protein(str(path), 7, dayhoff=dayhoff, scale=scale)
    got = t_sketch.sketch_protein(str(path), 7, dayhoff=dayhoff, scale=scale)
    assert np.array_equal(got.hashes, want.hashes)
    assert (got.total_kmers, got.inserted_kmers) == \
        (want.total_kmers, want.inserted_kmers)


@pytest.mark.parametrize("gz,fastq", [(False, False), (True, False), (True, True)])
def test_fastx_readers_equal(tmp_path, gz, fastq):
    rng = np.random.default_rng(9)
    path = tmp_path / ("x.fq" if fastq else "x.fa")
    path = str(path) + (".gz" if gz else "")
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        for i in range(25):
            seq = dna(rng, int(rng.integers(1, 90)))
            if fastq:
                f.write(f"@q{i} extra\n{seq}\n+\n{'I' * len(seq)}\n")
            else:  # multi-line records
                f.write(f">q{i} extra\n{seq[:40]}\n{seq[40:]}\n")
    assert list(t_fastx.read_records(path)) == list(j_fastx.read_records(path))
    assert list(t_fastx.read_chunks(path, 7)) == list(j_fastx.read_chunks(path, 7))


# ---------------------------------------------------------------------------
# .bin / .sig / phmap round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 57, 2000])
def test_bin_round_trip_both_ways(tmp_path, n):
    hashes = np.unique(np.random.default_rng(n).integers(
        0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True))
    a, b = tmp_path / "j.bin", tmp_path / "t.bin"
    j_phmap.write_hash_set(a, hashes)
    t_phmap.write_hash_set(b, hashes)
    assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(t_phmap.read_hash_set(a), j_phmap.read_hash_set(b))
    assert np.array_equal(np.sort(t_phmap.read_hash_set(a)), hashes)


@pytest.mark.parametrize("kind", ["u32", "u64"])
def test_phmap_maps_round_trip(tmp_path, kind):
    rng = np.random.default_rng(11)
    hi = 2**32 - 1 if kind == "u32" else 2**64 - 1
    dtype = np.uint32 if kind == "u32" else np.uint64
    keys = np.unique(rng.integers(0, hi, size=300, dtype=dtype, endpoint=True))
    values = rng.integers(0, hi, size=len(keys), dtype=dtype, endpoint=True)
    write, read = f"write_{kind}_{kind}_map", f"read_{kind}_{kind}_map"
    a, b = tmp_path / "j.map", tmp_path / "t.map"
    getattr(j_phmap, write)(a, keys, values)
    getattr(t_phmap, write)(b, keys, values)
    assert a.read_bytes() == b.read_bytes()
    for x, y in zip(getattr(t_phmap, read)(a), getattr(j_phmap, read)(b)):
        assert np.array_equal(x, y)


def test_color_to_sources_round_trip(tmp_path):
    names, arrays = hash_sets(13)
    index = j_index.build_index_from_hash_sets(names, arrays, ksize=21)
    members1 = index.color_members.astype(np.uint32) + 1
    a, b = tmp_path / "j.bin", tmp_path / "t.bin"
    j_phmap.write_color_to_sources(a, index.color_ids, index.color_offsets, members1)
    t_phmap.write_color_to_sources(b, index.color_ids, index.color_offsets, members1)
    assert a.read_bytes() == b.read_bytes()
    for x, y in zip(t_phmap.read_color_to_sources(a), j_phmap.read_color_to_sources(b)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("abund,gz", [(False, False), (True, False), (True, True)])
def test_sig_round_trip_both_ways(tmp_path, abund, gz):
    rng = np.random.default_rng(17)
    mins = np.sort(rng.integers(0, 2**63, size=80, dtype=np.uint64)).tolist()
    ab = rng.integers(1, 9, size=80).tolist() if abund else None
    # the file name is written into the signature: one name, two directories
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    a, b = tmp_path / "j" / "x.sig", tmp_path / "t" / "x.sig"
    j_sigs.write_sig(str(a), "x", mins, 21, abundances=ab)
    t_sigs.write_sig(str(b), "x", mins, 21, abundances=ab)
    assert a.read_bytes() == b.read_bytes()
    if gz:
        for p in (a, b):
            with open(p, "rb") as f, gzip.open(str(p) + ".gz", "wb") as g:
                g.write(f.read())
            os.remove(p)
        a, b = tmp_path / "j" / "x.sig.gz", tmp_path / "t" / "x.sig.gz"
    for path in (a, b):
        for k in (21, 31):
            got = t_sigs.load_sig_mins(str(path), k)
            want = j_sigs.load_sig_mins(str(path), k)
            assert repr(got) == repr(want)
        assert t_sigs.load_signatures(str(path)) == j_sigs.load_signatures(str(path))
        assert t_sigs.sig_basename(str(path)) == j_sigs.sig_basename(str(path))
        folder = os.path.dirname(str(path))
        assert t_sigs.scan_sigs_dir(folder) == j_sigs.scan_sigs_dir(folder)


# ---------------------------------------------------------------------------
# index build and artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,consume", [(21, False), (22, True), (23, False)])
def test_host_build_and_artifacts_equal(tmp_path, seed, consume):
    names, arrays = hash_sets(seed, n=7 + seed % 5)
    counts = [None if a is None or i % 3 else len(a) + 5
              for i, a in enumerate(arrays)]
    kw = dict(ksize=21, params="kSize:21")
    want = j_index.build_index_from_hash_sets(names, list(arrays), counts, **kw)
    got = t_index.build_index_from_hash_sets(names, list(arrays), counts,
                                             consume=consume, **kw)
    assert_same_index(want, got)
    j_artifacts.write_index_artifacts(str(tmp_path / "j"), want)
    t_artifacts.write_index_artifacts(str(tmp_path / "t"), got)
    for suffix in ARTIFACTS:
        assert filecmp.cmp(tmp_path / f"j{suffix}", tmp_path / f"t{suffix}",
                           shallow=False), suffix
    # each package loads the other's artifacts and npz cache
    assert_same_index(j_artifacts.load_index_artifacts(str(tmp_path / "t")),
                      t_artifacts.load_index_artifacts(str(tmp_path / "j")))
    assert_same_index(j_npz.load(str(tmp_path / "t")), t_npz.load(str(tmp_path / "j")))
    assert t_artifacts.read_names_map(str(tmp_path / "j.namesMap")) == \
        j_artifacts.read_names_map(str(tmp_path / "t.namesMap"))
    assert t_artifacts.read_extra(str(tmp_path / "j.extra")) == \
        j_artifacts.read_extra(str(tmp_path / "t.extra"))


def test_empty_and_classes_equal():
    assert_same_index(j_index.build_index_from_hash_sets(["a", "b"], [None, None]),
                      t_index.build_index_from_hash_sets(["a", "b"], [None, None]))
    rng = np.random.default_rng(31)
    lengths = rng.integers(1, 5, size=40)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    members = rng.integers(0, 6, size=int(lengths.sum())).astype(np.int32)
    for x, y in zip(t_index.group_runs_into_classes(starts, lengths, members),
                    j_index.group_runs_into_classes(starts, lengths, members)):
        assert np.array_equal(x, y)


def test_native_build_paths_equal(monkeypatch):
    """Above 1 M postings both builds take the native fill and color
    build; with KSPIDER_NATIVE=off both take numpy."""
    rng = np.random.default_rng(37)
    universe = np.unique(rng.integers(0, 2**63, size=300_000, dtype=np.uint64))
    arrays = [universe[rng.random(len(universe)) < 0.3] for _ in range(12)]
    assert sum(len(a) for a in arrays) > 1_000_000
    names = [f"g{i}" for i in range(12)]
    want = j_index.build_index_from_hash_sets(names, arrays)
    assert_same_index(want, t_index.build_index_from_hash_sets(names, arrays))
    monkeypatch.setenv("KSPIDER_NATIVE", "off")
    assert_same_index(want, t_index.build_index_from_hash_sets(names, arrays))


@pytest.mark.parametrize("path", ["dir", "dir/", "a/b/c//", "/x/y"])
def test_dir_prefix_of_equal(path):
    assert t_dir_prefix_of(path) == j_dir_prefix_of(path)


# ---------------------------------------------------------------------------
# the ctypes bridge, with the declared ks_fill_postings signature
# ---------------------------------------------------------------------------

@pytest.fixture
def native_lib():
    if not t_native.available():
        pytest.skip(f"native library unavailable: {t_native.load_error()!r}")
    return t_native._try_load()


def test_fill_postings_declares_its_signature(native_lib):
    import ctypes

    fn = native_lib.ks_fill_postings
    assert fn.restype is ctypes.c_int
    assert fn.argtypes is not None and len(fn.argtypes) == 7
    assert fn.argtypes[4] is ctypes.c_int64  # n_arrays


@pytest.mark.parametrize("n_arrays", [2, 7, 300])
def test_fill_postings_equals_numpy(native_lib, n_arrays):
    rng = np.random.default_rng(n_arrays)
    arrays = [rng.integers(0, 2**64 - 1, size=int(rng.integers(0, 40)),
                           dtype=np.uint64, endpoint=True) for _ in range(n_arrays)]
    entries, pos = [], 0
    for g, a in enumerate(arrays):
        if len(a):
            entries.append((g, a, pos))
            pos += len(a)
    hashes = np.empty(pos, dtype=np.uint64)
    gids = np.empty(pos, dtype=np.int32)
    t_native.fill_postings(entries, hashes, gids)
    assert np.array_equal(hashes, np.concatenate(arrays))
    assert np.array_equal(gids, np.repeat(np.arange(n_arrays, dtype=np.int32),
                                          [len(a) for a in arrays]))


def test_native_entry_points_equal(native_lib, tmp_path):
    rng = np.random.default_rng(41)
    rows = rng.integers(0, 256, size=(100, 21), dtype=np.uint8)
    assert np.array_equal(t_native.murmur64_batch(rows), j_native.murmur64_batch(rows))
    assert np.array_equal(t_native.murmur3_batch(rows), j_native.murmur3_batch(rows))
    names, arrays = hash_sets(43)
    index = j_index.build_index_from_hash_sets(names, arrays)
    args = (index.color_offsets, index.color_members, index.color_counts,
            index.num_groups)
    s = t_native.shared_kmer_matrix(*args)
    assert np.array_equal(s, j_native.shared_kmer_matrix(*args))
    hashes = np.concatenate([a for a in arrays if a is not None])
    gids = np.concatenate([np.full(len(a), g, np.int32)
                           for g, a in enumerate(arrays) if a is not None])
    order = np.lexsort((gids, hashes))
    for x, y in zip(t_native.build_colors(hashes[order], gids[order]),
                    j_native.build_colors(hashes[order], gids[order])):
        assert np.array_equal(x, y)
    counts = index.group_kmer_count.clip(0)
    t_native.write_pairwise_tsv(str(tmp_path / "t.tsv"), s, counts)
    j_native.write_pairwise_tsv(str(tmp_path / "j.tsv"), s, counts)
    assert filecmp.cmp(tmp_path / "t.tsv", tmp_path / "j.tsv", shallow=False)


# ---------------------------------------------------------------------------
# FASTA indexers, pairwise TSV, ANI, export, logger, timing
# ---------------------------------------------------------------------------

@pytest.fixture
def fasta_and_names(tmp_path):
    rng = np.random.default_rng(47)
    records, names = [], []
    for g in range(4):
        base = dna(rng, 400, with_n=False)
        for r in range(3):
            cut = int(rng.integers(0, 100))
            records.append((f"seq{g}_{r}", base[cut:cut + 250]))
            names.append(f"seq{g}_{r}\tgroup{g}")
    fasta, names_file = tmp_path / "in.fa", tmp_path / "in.names"
    write_fasta(fasta, records)
    names_file.write_text("\n".join(names) + "\n")
    return str(fasta), str(names_file)


@pytest.mark.parametrize("mode,kw", [
    ("kmers", {"canonical": True}), ("kmers", {"canonical": False}),
    ("skipmers", {"skip_m": 2, "skip_n": 3}), ("protein", {"dayhoff": True}),
])
def test_index_fasta_equal(tmp_path, fasta_and_names, mode, kw):
    fasta, names_file = fasta_and_names
    ksize = {"protein": 7, "skipmers": 12}.get(mode, 15)
    want = j_fasta_index.index_fasta(fasta, names_file, ksize,
                                     str(tmp_path / "j"), mode=mode, **kw)
    got = t_fasta_index.index_fasta(fasta, names_file, ksize,
                                    str(tmp_path / "t"), mode=mode, **kw)
    assert_same_index(want, got)
    for suffix in ARTIFACTS:
        assert filecmp.cmp(tmp_path / f"j{suffix}", tmp_path / f"t{suffix}",
                           shallow=False), suffix
    assert t_fasta_index.read_names_file(names_file) == \
        j_fasta_index.read_names_file(names_file)


@pytest.fixture
def pairwise_prefix(tmp_path):
    """A kspider_tpu pairwise run (numpy engine) on a small collection."""
    from kspider_tpu.core import pairwise as j_pairwise

    rng = np.random.default_rng(53)
    universe = np.unique(rng.integers(0, 2**63, size=3000, dtype=np.uint64))
    arrays = [universe[(i % 3) * 800:(i % 3) * 800 + 1000][
        rng.random(1000) < 0.6] for i in range(9)]
    names = [f"s{i}" for i in range(9)]
    index = j_index.build_index_from_hash_sets(names, arrays, ksize=21,
                                               params="kSize:21")
    prefix = str(tmp_path / "idx")
    j_artifacts.write_index_artifacts(prefix, index)
    j_pairwise.run_pairwise(prefix, use_tpu=False, echo_timers=False)
    return prefix


@pytest.mark.parametrize("dist_col,chunk", [(3, 5), (4, 1000), (5, 7)])
def test_pairwise_tsv_reader_equal(pairwise_prefix, dist_col, chunk):
    tsv = pairwise_prefix + "_kSpider_pairwise.tsv"
    got = list(t_tsv.iter_pairwise_chunks(tsv, dist_col, chunk_rows=chunk))
    want = list(j_tsv.iter_pairwise_chunks(tsv, dist_col, chunk_rows=chunk))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_ani_equal(pairwise_prefix, tmp_path):
    c = np.linspace(0.0, 1.0, 23)
    for k in (21, 31):
        assert np.array_equal(t_ani.containment_to_ani(c, k),
                              j_ani.containment_to_ani(c, k))
        got = t_ani.containment_to_distance(0.37, k, 1000, n_unique_kmers=4000)
        want = j_ani.containment_to_distance(0.37, k, 1000, n_unique_kmers=4000)
        assert repr(got) == repr(want)
    t_out = t_ani.write_ani_column(pairwise_prefix, 21, 1000)
    with open(t_out, "rb") as f:
        t_bytes = f.read()
    j_out = j_ani.write_ani_column(pairwise_prefix, 21, 1000)
    assert t_out == j_out
    with open(j_out, "rb") as f:
        assert f.read() == t_bytes
    assert t_ani.read_seq_to_kmers(pairwise_prefix + "_kSpider_seqToKmersNo.tsv") \
        == j_ani.read_seq_to_kmers(pairwise_prefix + "_kSpider_seqToKmersNo.tsv")


@pytest.mark.parametrize("dist_type,newick", [
    ("max_cont", True), ("min_cont", False), ("avg_cont", True)])
def test_export_equal(pairwise_prefix, tmp_path, dist_type, newick):
    outs = {}
    for tag, mod in (("j", j_export), ("t", t_export)):
        outs[tag] = mod.export_pairwise(
            pairwise_prefix, distance_type=dist_type, newick=newick,
            output_prefix=str(tmp_path / tag), distmat=True, chunk_rows=4)
    for pj, pt in zip(outs["j"], outs["t"]):
        assert (pj is None) == (pt is None)
        if pj is not None:
            assert filecmp.cmp(pj, pt, shallow=False), pj


def test_logger_and_timing_equal(capsys):
    for mod in (j_logger, t_logger):
        log = mod.Logger(quiet=False)
        log.INFO("info line")
        log.WARNING("warning line")
        log.SUCCESS("done line")
        mod.Logger(quiet=True).INFO("hidden")
    err = capsys.readouterr().err  # the logger writes to stderr
    half = len(err) // 2
    assert err[:half] == err[half:] and "[INFO] info line" in err
    assert "hidden" not in err
    for mod in (j_logger, t_logger):
        with pytest.raises(SystemExit) as exc:
            mod.Logger(quiet=True).ERROR("fatal")
        assert exc.value.code == 1
    for mod in (j_timing, t_timing):
        reg = mod.Span()
        with mod.timed("phase", echo=False, registry=reg):
            pass
        with reg("phase"):
            pass
        with mod.timed("echoed", echo=True):
            pass
        assert list(reg.spans) == ["phase"] and reg.spans["phase"] >= 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["echoed", "echoed"]
