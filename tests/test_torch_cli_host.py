"""The port's copies of kspider_tpu's host commands, through both CLIs.

``sketch``, the hidden FASTA indexers, ``index`` (host build, ``--sourmash``
and ``--bins``), ``export`` and every ``tools`` subcommand run with click's
test runner once through ``python -m kspider_tpu``'s group and once through
``python -m kspider_tpu_torch``'s, each in its own empty working directory
on the same inputs (given by the same relative paths).  The exit codes, the
terminal output and every file written must be equal, byte for byte.
"""

import gzip
import os

import numpy as np
import pytest
from click.testing import CliRunner

from kspider_tpu.cli.main import cli as j_cli
from kspider_tpu.io import phmap as j_phmap
from kspider_tpu.io import sigs as j_sigs
from kspider_tpu_torch.cli.main import cli as t_cli


def snapshot(root):
    """{relative path: bytes} of every file under ``root``."""
    files = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def run_both(tmp_path, args, prepare=None):
    """Runs ``args`` through both CLIs in ``tmp_path/j`` and ``tmp_path/t``;
    asserts equal exit codes, output and files; returns the port's
    (exit code, output, files)."""
    got = {}
    for tag, cli in (("j", j_cli), ("t", t_cli)):
        work = tmp_path / tag
        work.mkdir()
        if prepare is not None:
            prepare(work)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            result = CliRunner().invoke(cli, args)
        finally:
            os.chdir(cwd)
        got[tag] = (result.exit_code, result.output, snapshot(work))
    j_code, j_out, j_files = got["j"]
    t_code, t_out, t_files = got["t"]
    assert t_code == j_code, (j_out, t_out)
    assert t_out == j_out
    assert sorted(t_files) == sorted(j_files)
    for name in j_files:
        assert t_files[name] == j_files[name], name
    return got["t"]


def dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture
def inputs(tmp_path):
    """Shared inputs in ``tmp_path/in``: reads, proteins, a FASTA with a
    names file, sigs, bins and a small pairwise TSV."""
    rng = np.random.default_rng(61)
    d = tmp_path / "in"
    (d / "sigs").mkdir(parents=True)
    (d / "bins").mkdir()
    genomes = [dna(rng, 3000) for _ in range(3)]
    with open(d / "reads.fa", "w") as f:
        for i in range(40):
            g = genomes[i % 3]
            s = int(rng.integers(0, 2800))
            f.write(f">r{i}\n{g[s:s + 150]}\n")
    for name, part in (("lib_R1.fq", 0), ("lib_R2.fq.gz", 1)):
        opener = gzip.open if name.endswith(".gz") else open
        with opener(d / name, "wt") as f:
            for i in range(20):
                s = int(rng.integers(0, 2800))
                seq = genomes[part][s:s + 100]
                f.write(f"@q{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    with open(d / "prot.fa", "w") as f, open(d / "prot.names", "w") as names:
        for i in range(6):
            f.write(f">p{i}\n{''.join(rng.choice(list('ACDEFGHIKLMNPQRSTVWY'), size=90))}\n")
            names.write(f"p{i}\tprotein{i % 2}\n")
    with open(d / "seqs.fa", "w") as f, open(d / "seqs.names", "w") as names:
        for g in range(3):
            for r in range(3):
                s = int(rng.integers(0, 2000))
                f.write(f">c{g}_{r}\n{genomes[g][s:s + 600]}\n")
                names.write(f"c{g}_{r}\tgenome{g}\n")
    universe = np.unique(rng.integers(0, 2**63, size=4000, dtype=np.uint64))
    for i in range(6):
        fam = universe[(i % 2) * 1500:(i % 2) * 1500 + 1500]
        mins = np.sort(np.concatenate([fam[rng.random(len(fam)) < 0.7],
                                       universe[3000 + 150 * i:3150 + 150 * i]]))
        ab = rng.integers(1, 6, size=len(mins)).tolist()
        j_sigs.write_sig(str(d / "sigs" / f"s{i}.sig"), f"s{i}", mins.tolist(), 21,
                         abundances=ab)
        j_phmap.write_hash_set(d / "bins" / f"s{i}.bin", mins)
    (d / "bad.bin").write_bytes(b"\x05\x00")
    with open(d / "pairs.tsv", "w") as f:
        f.write("source_1\tsource_2\tshared_kmers\tmin_containment\t"
                "avg_containment\tmax_containment\n")
        for a in range(1, 7):
            for b in range(a + 1, 7):
                c = float(rng.uniform(0, 0.5))
                f.write(f"{a}\t{b}\t{int(rng.integers(1, 90))}\t{c / 2:g}\t{c:g}\t"
                        f"{min(1.0, c * 1.5):g}\n")
    return "../in"


@pytest.mark.parametrize("args", [
    ["sketch", "--fastx", "{i}/reads.fa", "-k", "21"],
    ["sketch", "--fastx", "{i}/reads.fa", "-k", "21", "-s", "10", "--format", "sig"],
    ["sketch", "--fastx", "{i}/reads.fa", "-k", "15", "--singletones",
     "--hasher", "integer", "-o", "ints"],
    ["sketch", "--fastx", "{i}/reads.fa", "-k", "19", "--hasher", "murmur_int",
     "--format", "sig", "-o", "mi"],
    ["sketch", "--r1", "{i}/lib_R1.fq", "--r2", "{i}/lib_R2.fq.gz", "-k", "21"],
    ["sketch", "--fastx", "{i}/prot.fa", "-k", "7", "--protein"],
    ["sketch", "--fastx", "{i}/prot.fa", "-k", "9", "--dayhoff", "-s", "3"],
    ["sketch", "--fastx", "{i}/prot.fa", "-k", "9", "--dayhoff", "--protein"],
    ["sketch", "-k", "21"],
], ids=["bin", "sig-scaled", "integer-singletons", "murmur-int-sig", "paired",
        "protein", "dayhoff", "protein-and-dayhoff", "no-input"])
def test_sketch(tmp_path, inputs, args):
    run_both(tmp_path, [a.format(i=inputs) for a in args])


@pytest.mark.parametrize("args", [
    ["index_kmers", "-f", "{i}/seqs.fa", "-n", "{i}/seqs.names", "-k", "21", "-o", "km"],
    ["index_kmers", "-f", "{i}/seqs.fa", "-n", "{i}/seqs.names", "-k", "17",
     "--strand-specific", "-o", "ss"],
    ["index_skipmers", "-f", "{i}/seqs.fa", "-n", "{i}/seqs.names", "-k", "12",
     "-m", "2", "--cycle-length", "3", "-o", "sk"],
    ["index_skipmers", "-f", "{i}/seqs.fa", "-n", "{i}/seqs.names", "-k", "13",
     "-m", "2", "--cycle-length", "3", "-o", "bad"],
    ["index_protein", "-f", "{i}/prot.fa", "-n", "{i}/prot.names", "-k", "7", "-o", "pr"],
    ["index_protein", "-f", "{i}/prot.fa", "-n", "{i}/prot.names", "-k", "8",
     "--dayhoff", "-o", "dh"],
    ["index_protein", "-f", "{i}/prot.fa", "-n", "{i}/prot.names", "-k", "5", "-o", "k5"],
], ids=["kmers", "strand-specific", "skipmers", "skipmers-invalid", "protein",
        "dayhoff", "protein-k-out-of-range"])
def test_fasta_indexers(tmp_path, inputs, args):
    run_both(tmp_path, [a.format(i=inputs) for a in args])


@pytest.mark.parametrize("args", [
    ["index", "--sourmash", "--dir", "{i}/sigs", "-k", "21"],
    ["index", "--sourmash", "--dir", "{i}/sigs/", "-k", "31", "-o", "k31"],
    ["index", "--bins", "--dir", "{i}/bins", "-k", "21", "-o", "binidx"],
    ["index", "--sourmash", "--dir", "{i}/sigs"],
], ids=["sourmash", "sourmash-k31", "bins", "sourmash-no-k"])
def test_index_host_build(tmp_path, inputs, args):
    code, _, files = run_both(tmp_path, [a.format(i=inputs) for a in args])
    if code == 0:
        assert any(name.endswith("_color_to_sources.bin") for name in files)


@pytest.mark.parametrize("flags", [
    ["--newick"], [], ["-d", "min_cont", "-o", "custom"], ["--no-distmat"],
    ["--no-distmat", "--force-distmat"],
], ids=["newick", "distmat", "min-cont-custom", "no-distmat", "conflict"])
def test_export(tmp_path, inputs, flags):
    def prepare(work):
        # an index and its pairwise TSV, made by kspider_tpu in each dir
        cwd = os.getcwd()
        os.chdir(work)
        try:
            for args in (["index", "--sourmash", "--dir", f"{inputs}/sigs", "-k", "21"],
                         ["pairwise", "-i", "sigs", "--cpu"]):
                assert CliRunner().invoke(j_cli, args).exit_code == 0
        finally:
            os.chdir(cwd)

    run_both(tmp_path, ["export", "-i", "sigs", *flags], prepare)


@pytest.mark.parametrize("args", [
    ["tools", "sig_to_bin", "{i}/sigs/s0.sig", "21", "2", "s0.bin"],
    ["tools", "sig_to_bin", "{i}/sigs/s1.sig", "31", "1", "s1.bin"],
    ["tools", "sigs_to_bins", "{i}/sigs", "21", "out", "2"],
    ["tools", "dump_bin", "{i}/bins/s2.bin"],
    ["tools", "dump_sig", "{i}/sigs/s3.sig", "21"],
    ["tools", "check_bin", "{i}/bins/s4.bin"],
    ["tools", "check_bin", "{i}/bad.bin"],
    ["tools", "validate", "{i}/sigs/s5.sig", "{i}/bins/s5.bin", "21"],
    ["tools", "validate", "{i}/sigs/s0.sig", "{i}/bins/s1.bin", "21"],
    ["tools", "validate_bins", "{i}/bins", "-o", "report.txt"],
    ["tools", "validate_bins", "{i}", "-o", "report.txt"],
    ["tools", "dump_kmer_count", "{i}/reads.fa", "15"],
    ["tools", "normalize", "--r1", "{i}/lib_R1.fq", "-k", "21", "-o", "norm.bin"],
    ["tools", "normalize", "--r1", "{i}/lib_R1.fq", "--r2", "{i}/lib_R2.fq.gz",
     "-k", "17", "--percentile", "20", "--max-kmers", "500", "-o", "norm2.bin"],
    ["tools", "repr_sketches", "{i}/pairs.tsv"],
    ["tools", "repr_sketches", "{i}/pairs.tsv", "--threshold", "0.05"],
    ["tools"],
], ids=["sig_to_bin", "sig_to_bin-k31", "sigs_to_bins", "dump_bin", "dump_sig",
        "check_bin", "check_bin-invalid", "validate", "validate-mismatch",
        "validate_bins", "validate_bins-invalid", "dump_kmer_count", "normalize",
        "normalize-paired", "repr_sketches", "repr_sketches-threshold", "help"])
def test_tools(tmp_path, inputs, args):
    run_both(tmp_path, [a.format(i=inputs) for a in args])


def test_sigs_to_bins_resumes(tmp_path, inputs):
    def prepare(work):
        (work / "out").mkdir()
        j_phmap.write_hash_set(work / "out" / "s0.bin", np.arange(3, dtype=np.uint64))

    run_both(tmp_path, ["tools", "sigs_to_bins", f"{inputs}/sigs", "21", "out"],
             prepare)


def test_root_help_lists_commands_in_the_same_order():
    def names(cli):
        out = CliRunner().invoke(cli, ["--help"]).output
        body = out.split("Commands:")[1]
        return [line.split()[0] for line in body.splitlines() if line.strip()]

    assert names(t_cli) == names(j_cli)
    assert t_cli.help_priorities == j_cli.help_priorities
    hidden = {n for n, c in j_cli.commands.items() if c.hidden}
    assert hidden == {n for n, c in t_cli.commands.items() if c.hidden} \
        == {"index_kmers", "index_skipmers", "index_protein"}
