"""CLI of the port: ``python -m kspider_tpu_torch`` / ``kspider-torch``.

``index``, ``pairwise`` and ``cluster`` are the port's own and keep the
option names of ``kspider_tpu/cli/main.py``, plus ``--device`` (default
``cuda``), the torch device of ``index --device-build`` and of the Gram
kernel; ``pairwise`` and ``cluster`` also take a comma-separated device
list (``cuda:0,cuda:1``) whose devices share the Gram product.  ``--cpu``
keeps its meaning: the numpy / scipy host engines.  ``pairwise
--num-processes N --process-id R --coordinator HOST:PORT`` runs one of N
coordinated processes (``parallel/multiprocess.py``), each on one device.
The other commands (sketch, the hidden FASTA indexers, export, tools) are
copies of the JAX package's, with the same options, help priorities and
hidden flags, on the port's host layers.
"""

import os
from glob import glob

import click

import numpy as np

from kspider_tpu_torch.cli.context import cli


def _resolve(log, device_name, force_cpu, many=False):
    """The torch device for ``--device``, or None for ``--cpu``.  With
    ``many``, a comma-separated list of several devices gives a list."""
    if force_cpu:
        return None
    from kspider_tpu_torch.parallel.mesh import make_mesh

    try:
        devices = make_mesh(device_name)
    except (RuntimeError, ValueError) as exc:
        log.ERROR(f"--device {device_name}: {exc}")
    if len(devices) == 1:
        return devices[0]
    if not many:
        log.ERROR(f"--device {device_name}: this command takes one device")
    return devices


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------

@cli.command(name="sketch", help_priority=1)
@click.option("-c", "--chunk-size", "chunk_size", required=False, type=click.INT, default=3000, help="chunk size")
@click.option("-k", "--kmer-size", "ksize", required=True, type=click.IntRange(7, 31, clamp=False), help="kmer size")
@click.option("--fastx", "fastx_path", type=click.Path(exists=True), help="FASTX file path, works with interleaved paired-end and protein", required=False)
@click.option("--r1", "r1", type=click.Path(exists=True), help="paired-end FASTX R1 file", required=False)
@click.option("--r2", "r2", type=click.Path(exists=True), help="paired-end FASTX R2 file", required=False)
@click.option("--protein", "protein", is_flag=True, show_default=True, default=False, help="parsing protein")
@click.option("--singletones", "singletons", is_flag=True, show_default=True, default=False, help="remove singletones")
@click.option("--dayhoff", "dayhoff", is_flag=True, show_default=True, default=False, help="parsing protein in dayhoff encoding")
@click.option("-s", "--scale", "scale", required=False, default=1, help="Downsampling ratio")
@click.option("--hasher", "hasher", required=False, default="sourmash", show_default=True, type=click.Choice(["sourmash", "integer", "murmur_int"]), help="k-mer hashing convention")
@click.option("-o", "--output", "output", required=False, default=None, help="output prefix (default: derived from input basename)")
@click.option("--format", "out_format", required=False, default="bin", show_default=True, type=click.Choice(["bin", "sig"]), help="sketch output format")
@click.pass_context
def sketch(ctx, fastx_path, r1, r2, chunk_size, ksize, protein, dayhoff, scale, singletons, hasher, output, out_format):
    """Sketch a FASTA/Q file into a hash set (.bin) or sourmash-style .sig."""
    from kspider_tpu_torch.core import sketch as sketch_core
    from kspider_tpu_torch.io import phmap as phmap_io
    from kspider_tpu_torch.io import sigs as sigs_io

    log = ctx.obj
    if protein and (r1 or r2):
        log.ERROR("Protein can't be paired-end.")
    if fastx_path and (r1 or r2):
        log.ERROR("You can use either --fastx or --r1 --r2.")
    if not fastx_path and not (r1 and r2):
        log.ERROR("You need to provide --r1 --r2.")
    if protein and dayhoff:
        log.ERROR("You can use either --protein or --dayhoff")
    if scale > 100:
        log.WARNING("Deep downsampling (scale > 100); consider whether a sparser sketch still covers your genomes.")

    if r1 and r2:
        log.INFO("Processing paired-end reads.")
        res = sketch_core.sketch_paired_end(r1, r2, ksize, scale=scale, hasher=hasher, remove_singletons=singletons)
        base = output or sketch_core.paired_end_basename(r1)
    elif protein or dayhoff:
        log.INFO(f"Processing protein in {'dayhoff' if dayhoff else 'default'} mode.")
        res = sketch_core.sketch_protein(fastx_path, ksize, dayhoff=dayhoff, scale=scale)
        base = output or os.path.basename(fastx_path)
    else:
        log.INFO("Processing single-end reads.")
        res = sketch_core.sketch_single_end(fastx_path, ksize, scale=scale, hasher=hasher, remove_singletons=singletons)
        base = output or os.path.basename(fastx_path)

    out_dir = os.path.dirname(base)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if out_format == "sig":
        out_path = base + ".sig"
        sigs_io.write_sig(out_path, base, res.hashes.tolist(), ksize, scaled=scale)
    else:
        out_path = base + ".bin"
        phmap_io.write_hash_set(out_path, res.hashes)
    print(f"filename({base}): total({res.total_kmers}) inserted({res.inserted_kmers}) unique({len(res.hashes)})")
    log.SUCCESS("File(s) has been sketched.")


# ---------------------------------------------------------------------------
# hidden FASTA index commands
# ---------------------------------------------------------------------------

@cli.command(name="index_kmers", help_priority=1, hidden=True)
@click.option("-f", "--fasta", "fasta_file", required=True, type=click.Path(exists=True), help="FASTA file")
@click.option("-n", "--names", "names_file", required=True, type=click.Path(exists=True), help="Names file")
@click.option("-k", "--kmer-size", "ksize", required=True, type=click.IntRange(7, 31, clamp=False), help="kmer size")
@click.option("-c", "--chunk-size", "chunk_size", required=False, type=click.INT, default=3000, help="chunk size")
@click.option("--strand-specific", "strand_specific", is_flag=True)
@click.option("-o", "--output", "output_prefix", required=False, default=None, help="index output file prefix")
@click.pass_context
def index_kmers(ctx, fasta_file, names_file, ksize, output_prefix, chunk_size, strand_specific):
    """FASTA file indexing by Kmers."""
    from kspider_tpu_torch.core import fasta_index

    log = ctx.obj
    _validate_names(log, names_file)
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="kmers", canonical=not strand_specific, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


@cli.command(name="index_skipmers", help_priority=2, hidden=True)
@click.option("-f", "--fasta", "fasta_file", required=True, type=click.Path(exists=True), help="FASTA file")
@click.option("-n", "--names", "names_file", required=True, type=click.Path(exists=True), help="Names file")
@click.option("-k", "--kmer-size", "ksize", required=True, type=click.INT, help="kmer size")
@click.option("-m", "--cycle-bases", "skip_m", required=True, type=click.INT, help="used bases per cycle")
@click.option("--cycle-length", "skip_n", required=True, type=click.INT, help="cycle length")
@click.option("-c", "--chunk-size", "chunk_size", required=False, type=click.INT, default=3000, help="chunk size")
@click.option("-o", "--output", "output_prefix", required=False, default=None, help="index output file prefix")
@click.pass_context
def index_skipmers(ctx, fasta_file, names_file, ksize, skip_m, skip_n, chunk_size, output_prefix):
    """FASTA file indexing by Skipmers."""
    from kspider_tpu_torch.core import fasta_index

    log = ctx.obj
    _validate_names(log, names_file)
    if skip_n < 1 or skip_n < skip_m or ksize < skip_m or ksize % skip_m != 0:
        raise click.BadParameter(
            "Invalid skip-mer shape!\nConditions: 0 < m <= n < k & k must be multiple of m"
        )
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="skipmers", skip_m=skip_m, skip_n=skip_n, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


@cli.command(name="index_protein", help_priority=3, hidden=True)
@click.option("-f", "--fasta", "fasta_file", required=True, type=click.Path(exists=True), help="FASTA file")
@click.option("-n", "--names", "names_file", required=True, type=click.Path(exists=True), help="Names file")
@click.option("-k", "--kmer-size", "ksize", required=True, type=click.IntRange(7, 31, clamp=False), help="kmer size")
@click.option("-c", "--chunk-size", "chunk_size", required=False, type=click.INT, default=3000, help="chunk size")
@click.option("--dayhoff", "dayhoff", is_flag=True, show_default=True, default=False, help="use Dayhoff encoding")
@click.option("-o", "--output", "output_prefix", required=False, default=None, help="index output file prefix")
@click.pass_context
def index_protein(ctx, fasta_file, names_file, ksize, output_prefix, chunk_size, dayhoff):
    """FASTA file indexing by Protein.

    Note: the reference routes both --dayhoff and default to the dayhoff
    indexer (bug at kSpider/pykSpider/kSpider2/ks_index.py:108-113);
    here the flag selects the encoding correctly."""
    from kspider_tpu_torch.core import fasta_index

    log = ctx.obj
    _validate_names(log, names_file)
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="protein", dayhoff=dayhoff, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


def _validate_names(log, names_file):
    log.INFO("validating names file..")
    with open(names_file) as names:
        for i, line in enumerate(names, 1):
            if len(line.strip().split("\t")) != 2:
                log.ERROR(f"invalid names line detected at L{i}: '{line.strip()}'")


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

@cli.command(name="index", help_priority=2)
@click.option("--dir", "sketches_dir", required=True, help="Sketches directory (must contain only the sketches)")
@click.option("-k", "--kmer-size", "ksize", required=False, default=0, type=click.INT, help="kmer size (required for --sourmash and --bins)")
@click.option("--sourmash", "sourmash", is_flag=True, show_default=True, default=False, help="index sourmash signature (.sig) files")
@click.option("--bins", "bins", is_flag=True, show_default=True, default=False, help="index .bin hash-set files")
@click.option("-o", "--output", "output_prefix", required=False, default=None, help="index output prefix (default: directory basename, in CWD)")
@click.option("--device-build", "device_build", is_flag=True, default=False, help="run the postings sort/dedup/singleton filter on --device (ops/device_build.py)")
@click.option("--device", "device_name", default="cuda", show_default=True, type=click.STRING, help="torch device of --device-build (cuda, cuda:N or cpu)")
@click.pass_context
def index(ctx, sketches_dir, sourmash, bins, ksize, output_prefix, device_build, device_name):
    """Index all sketches in a directory."""
    from kspider_tpu_torch.core import dataset

    log = ctx.obj
    if not os.path.exists(sketches_dir):
        log.ERROR(f"{sketches_dir} does not exist!")
    device = _resolve(log, device_name, False) if device_build else None

    if sourmash:
        if not ksize:
            log.ERROR("must select kSize when using --sourmash")
        log.INFO(f"Indexing sourmash sigs in {sketches_dir} with kSize={ksize}.")
        dataset.index_sigs_dir(sketches_dir, ksize, output_prefix=output_prefix, logger=log, device=device)
        log.SUCCESS("DONE!")
        return

    if bins or glob(f"{sketches_dir}/*.bin"):
        if not ksize:
            log.ERROR("must select kSize when indexing .bin sketches")
        log.INFO(f"Indexing bins in {sketches_dir}.")
        dataset.index_bins_dir(sketches_dir, ksize, output_prefix=output_prefix, logger=log, device=device)
        log.SUCCESS("DONE!")
        return

    # reference consistency check for the kProcessor sketch path
    all_extra = glob(f"{sketches_dir}/*extra")
    all_phmap = glob(f"{sketches_dir}/*phmap")
    all_mqf = glob(f"{sketches_dir}/*mqf")
    if len(all_extra) != (len(all_phmap) + len(all_mqf)):
        log.ERROR("Inconsistent sketches files.")
    if not all_phmap and not all_mqf:
        log.ERROR(
            f"no sketches found in {sketches_dir}; expected .sig, .bin, or "
            ".phmap files"
        )
    log.INFO(f"Indexing sketches in {sketches_dir}.")
    try:
        dataset.index_kf_dir(sketches_dir, output_prefix=output_prefix, logger=log, device=device)
    except ValueError as e:
        log.ERROR(str(e))
    log.SUCCESS("DONE!")


@cli.command(name="pairwise", help_priority=3)
@click.option("-i", "--index-prefix", "index_prefix", required=True, type=click.STRING, help="Index file prefix")
@click.option("--estimate-ani", "ani", is_flag=True, show_default=True, default=False, help="estimate ANI and write result in a new file with single column")
@click.option("-t", "--threads", "user_threads", default=1, required=False, type=int, help="number of cores (accepted for compatibility; the GPU engine ignores it)")
@click.option("-s", "--scale", "sourmash_scale", required=False, default=0, type=int, help="scale used in creating sourmash sigs (only when using --estimate-ani)")
@click.option("--cpu", "force_cpu", is_flag=True, default=False, help="use the host (numpy) engine instead of the GPU kernel")
@click.option("--device", "device_name", default="cuda", show_default=True, type=click.STRING, help="torch device of the Gram kernel (cuda, cuda:N or cpu), or a comma-separated list (cuda:0,cuda:1) whose devices share it: the dense engine splits the color blocks over them, the tiled engine the panel pairs (or each pair's color blocks).  One device per process with --num-processes")
@click.option("--engine", "engine", default="auto", show_default=True, type=click.Choice(["auto", "bitmask", "pallas", "scatter", "tiled"]), help="co-occurrence engine: bitmask and pallas both run the dense engine on the one hand-written Gram kernel (on Hopper the XLA-bitmask and Pallas variants are that kernel); scatter = postings scatter + int8 matmul; tiled = panel-streamed, any N; auto = dense, or tiled above 16,384 samples on a device.  With --cpu every engine but tiled is the numpy engine")
@click.option("--panel", "panel", default=4096, show_default=True, type=int, help="sample-panel width for the tiled engine")
@click.option("--min-shared", "min_shared", default=1, show_default=True, type=int, help="emit only pairs with at least this many shared k-mers")
@click.option("--device-pack", "device_pack", default=None, type=click.Choice(["auto", "force", "off"]), help="ship sparse color chunks (dense engine) and panel sides (tiled engine) as posting keys and build the bitmask on the device (default: env KSPIDER_DEVICE_PACK or auto; --engine bitmask packs on the host)")
@click.option("--coordinator", "coordinator", default=None, type=click.STRING, help="torch.distributed coordinator address (host:port) for multi-process runs; or env KSPIDER_COORDINATOR")
@click.option("--num-processes", "num_processes", default=None, type=int, help="total coordinated processes; or env KSPIDER_NUM_PROCESSES")
@click.option("--process-id", "process_id", default=None, type=int, help="this process's id in [0, num-processes); or env KSPIDER_PROCESS_ID")
@click.pass_context
def pairwise(ctx, index_prefix, ani, user_threads, sourmash_scale, force_cpu, device_name, engine, panel, min_shared, device_pack, coordinator, num_processes, process_id):
    """Generate containment pairwise matrix."""
    log = ctx.obj
    if not ani:
        from kspider_tpu_torch.core import pairwise as core_pairwise
        from kspider_tpu_torch.ops.pairwise import check_engine_devices
        from kspider_tpu_torch.parallel import multiprocess as mp

        device = _resolve(log, device_name, force_cpu, many=True)
        if isinstance(device, list) and engine != "tiled":
            try:
                check_engine_devices(engine, len(device))
            except ValueError as exc:
                log.ERROR(str(exc))
        coordinator_, n_procs, process_id_ = mp.resolve_flags(
            coordinator, num_processes, process_id)
        if n_procs > 1:
            try:
                mp.rank_device(device)
            except ValueError as exc:
                log.ERROR(f"--num-processes {n_procs}: {exc}")
            if not coordinator_ or process_id_ is None:
                log.ERROR(f"--num-processes {n_procs} needs --coordinator "
                          "host:port and --process-id")
            log.INFO(f"Constructing the containment pairwise matrix across "
                     f"{n_procs} coordinated processes.")
            try:
                mp.run_multiprocess_pairwise(
                    index_prefix, device=device, engine=engine, panel=panel,
                    min_shared=min_shared, device_pack=device_pack,
                    coordinator=coordinator, num_processes=num_processes,
                    process_id=process_id,
                )
            finally:
                mp.shutdown()
            log.SUCCESS("Done.")
            return
        log.INFO("Constructing the containment pairwise matrix.")
        if sourmash_scale:
            log.WARNING("No need to provide -s/--scale when running this command.")
        core_pairwise.run_pairwise(
            index_prefix, device=device, engine=engine, panel=panel,
            min_shared=min_shared, device_pack=device_pack,
        )
        log.SUCCESS("Done.")
        return

    from kspider_tpu_torch.models import ani as ani_model

    if not os.path.exists(index_prefix + "_kSpider_pairwise.tsv"):
        log.ERROR("Please, run the same command without --estimate-ani first, then run this command.")
    log.INFO("Estimating the ANI. This might take some time if the data is very large.")
    if user_threads > 1:
        log.WARNING("sorry, current ANI estimation implementation does not allow multithreading")
    if not sourmash_scale:
        log.ERROR("estimating ANI requires to provide --scale value")
    with open(f"{index_prefix}.extra") as extra:
        ksize = int(next(extra))
    ani_model.write_ani_column(index_prefix, ksize, sourmash_scale, logger=log)
    log.SUCCESS("Done.")


@cli.command(name="cluster", help_priority=4)
@click.option("-c", "--cutoff", required=False, type=click.FloatRange(0, 1, clamp=False), default=0.0, show_default=True, help="cluster sequences with (containment > cutoff)")
@click.option("-i", "--index-prefix", "index_prefix", required=True, type=click.STRING, help="Index file prefix")
@click.option("-d", "--dist-type", "distance_type", required=False, default="max_cont", show_default=True, type=click.STRING, help="select from ['min_cont', 'avg_cont', 'max_cont', 'ani']")
@click.option("--cpu", "force_cpu", is_flag=True, default=False, help="use scipy connected-components instead of the GPU label propagation (with --from-index, also the CPU Gram product)")
@click.option("--device", "device_name", default="cuda", show_default=True, type=click.STRING, help="torch device of the connected-components rounds, and of the Gram kernel with --from-index (cuda, cuda:N or cpu); a comma-separated list shares the --from-index Gram product, and the CC runs on its first device")
@click.option("--from-index", "from_index", is_flag=True, default=False, help="cluster straight from the index via the panel-streamed engine (no pairwise TSV round-trip; min/avg/max metrics only)")
@click.option("--panel", "panel", default=4096, show_default=True, type=int, help="sample-panel width (--from-index mode)")
@click.option("--min-shared", "min_shared", default=1, show_default=True, type=int, help="ignore pairs below this many shared k-mers (--from-index mode)")
@click.pass_context
def cluster(ctx, index_prefix, cutoff, distance_type, force_cpu, device_name, from_index, panel, min_shared):
    """Sequence clustering."""
    from kspider_tpu_torch.core import cluster as core_cluster
    from kspider_tpu_torch.utils.timing import profile_trace, timed

    log = ctx.obj
    device = _resolve(log, device_name, force_cpu, many=True)
    devices = [] if device is None else device if isinstance(device, list) \
        else [device]
    with profile_trace(devices, "cluster"):
        if from_index:
            from kspider_tpu_torch.io import artifacts, npz_index

            with timed("kspider.load"):
                index = npz_index.load(index_prefix)
                if index is None:
                    index = artifacts.load_index_artifacts(index_prefix)
            out = core_cluster.cluster_from_index(
                index, index_prefix, cutoff, dist_type=distance_type,
                device=device, panel=panel, min_shared=min_shared, logger=log,
            )
        else:
            log.INFO("Building the main graph...")
            out = core_cluster.cluster_index(
                index_prefix, cutoff, dist_type=distance_type,
                device=devices[0] if devices else None, logger=log,
            )
    log.SUCCESS(f"Clusters written to {out}")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

@cli.command(name="export", help_priority=5)
@click.option("-i", "--index-prefix", required=True, type=click.STRING, help="Index file prefix")
@click.option("--newick", "newick", is_flag=True, help="Convert pairwise (containment) matrix to newick format", default=False)
@click.option("-d", "--dist-type", "distance_type", required=False, default="max_cont", show_default=True, type=click.STRING, help="select from ['min_cont', 'avg_cont', 'max_cont', 'ani']")
@click.option("-o", "overwritten_output", default="na", required=False, type=click.STRING, help="custom output file name prefix")
@click.option("--no-distmat", "no_distmat", is_flag=True, default=False, help="skip the NxN distance matrix (O(N^2); auto-skipped above 16384 samples)")
@click.option("--force-distmat", "force_distmat", is_flag=True, default=False, help="build the NxN distance matrix even above the auto-gate threshold")
@click.pass_context
def export(ctx, index_prefix, newick, distance_type, overwritten_output, no_distmat, force_distmat):
    """Export kSpider pairwise to multiple formats."""
    from kspider_tpu_torch.models import export as export_model

    if no_distmat and force_distmat:
        ctx.obj.ERROR("--no-distmat and --force-distmat are mutually exclusive")
    out = None if overwritten_output == "na" else overwritten_output
    distmat = False if no_distmat else (True if force_distmat else None)
    export_model.export_pairwise(
        index_prefix, distance_type=distance_type, newick=newick,
        output_prefix=out, logger=ctx.obj, distmat=distmat,
    )


# ---------------------------------------------------------------------------
# tools (the reference's standalone executables)
# ---------------------------------------------------------------------------

@cli.group(name="tools", help_priority=6)
def tools():
    """Utility tools (sig/bin conversion, dumps, validation)."""


@tools.command(name="sig_to_bin")
@click.argument("sig_path", type=click.Path(exists=True))
@click.argument("ksize", type=int)
@click.argument("min_abundance", type=int)
@click.argument("output_path")
def sig_to_bin(sig_path, ksize, min_abundance, output_path):
    """Convert one .sig to a .bin hash set, filtering abundance >= MIN
    (reference kSpider/sig_to_bin.cpp:21-65)."""
    from kspider_tpu_torch.io import phmap as phmap_io
    from kspider_tpu_torch.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(
        sig_path, ksize, min_abundance=min_abundance, first_entry_only=True
    )
    hashes = mins if mins is not None else np.empty(0, dtype=np.uint64)
    print(f"inserted {len(hashes)} hashes.")
    phmap_io.write_hash_set(output_path, np.unique(hashes))


@tools.command(name="sigs_to_bins")
@click.argument("sigs_dir", type=click.Path(exists=True))
@click.argument("ksize", type=int)
@click.argument("output_dir")
@click.argument("threads", type=int, default=1, required=False)
def sigs_to_bins(sigs_dir, ksize, output_dir, threads):
    """Batch-convert a directory of sigs to bins; resumable (skips already
    converted outputs, reference kSpider/sigs_to_bins.cpp:94-102)."""
    from concurrent.futures import ThreadPoolExecutor

    from kspider_tpu_torch.io import phmap as phmap_io
    from kspider_tpu_torch.io import sigs as sigs_io

    os.makedirs(output_dir, exist_ok=True)
    pass1, _ = sigs_io.scan_sigs_dir(sigs_dir)
    todo = []
    skipped = 0
    for p in pass1:
        base = sigs_io.sig_basename(p)
        out = os.path.join(output_dir, base + ".bin")
        if os.path.exists(out):
            skipped += 1
            continue
        todo.append((p, out))
    print(f"Skipped {skipped} files as they already converted to bins.")

    def convert(args):
        p, out = args
        mins = sigs_io.load_sig_mins(p, ksize, first_entry_only=True)
        hashes = mins if mins is not None else np.empty(0, dtype=np.uint64)
        phmap_io.write_hash_set(out, np.unique(hashes))

    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        list(ex.map(convert, todo))
    print("Process completed.")


@tools.command(name="dump_bin")
@click.argument("bin_path", type=click.Path(exists=True))
def dump_bin(bin_path):
    """Print all hashes in a .bin (reference export_bin.cpp:17-32)."""
    from kspider_tpu_torch.io import phmap as phmap_io

    for h in phmap_io.read_hash_set(bin_path):
        print(h)


@tools.command(name="dump_sig")
@click.argument("sig_path", type=click.Path(exists=True))
@click.argument("ksize", type=int)
def dump_sig(sig_path, ksize):
    """Print all hashes in a .sig at k (reference export_sig.cpp:21-53)."""
    from kspider_tpu_torch.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(sig_path, ksize)
    if mins is not None:
        for h in mins:
            print(h)


@tools.command(name="check_bin")
@click.argument("bin_path", type=click.Path(exists=True))
def check_bin(bin_path):
    """Validate a .bin loads; print VALID_BIN: <n> (reference check_bin.cpp)."""
    from kspider_tpu_torch.io import phmap as phmap_io

    try:
        hashes = phmap_io.read_hash_set(bin_path)
    except Exception as e:  # malformed dump
        print(f"INVALID_BIN: {e}")
        raise SystemExit(1)
    print(f"VALID_BIN: {len(hashes)}")


@tools.command(name="validate")
@click.argument("sig_path", type=click.Path(exists=True))
@click.argument("bin_path", type=click.Path(exists=True))
@click.argument("ksize", type=int)
def validate(sig_path, bin_path, ksize):
    """Shared-hash count between a sig and a bin (reference validate.cpp:21-64)."""
    from kspider_tpu_torch.io import phmap as phmap_io
    from kspider_tpu_torch.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(sig_path, ksize)
    bin_hashes = phmap_io.read_hash_set(bin_path)
    shared = 0
    if mins is not None:
        shared = len(np.intersect1d(np.unique(mins), bin_hashes))
    print(f"shared_hashes: {shared}")


@tools.command(name="validate_bins")
@click.argument("bins_dir", type=click.Path(exists=True))
@click.option("-o", "--report", "report_path", default="validate_bins_report.txt", show_default=True)
def validate_bins(bins_dir, report_path):
    """Integrity-sweep every .bin in a directory; write a report
    (reference kSpider/validate_bins.sh:1-20)."""
    from kspider_tpu_torch.io import phmap as phmap_io

    ok, bad = 0, 0
    with open(report_path, "w") as report:
        for entry in sorted(os.listdir(bins_dir)):
            if not entry.endswith(".bin"):
                continue
            path = os.path.join(bins_dir, entry)
            try:
                hashes = phmap_io.read_hash_set(path)
                report.write(f"{entry}\tVALID_BIN: {len(hashes)}\n")
                ok += 1
            except Exception as e:
                report.write(f"{entry}\tINVALID_BIN: {e}\n")
                bad += 1
    print(f"checked {ok + bad} bins: {ok} valid, {bad} invalid -> {report_path}")
    if bad:
        raise SystemExit(1)


@tools.command(name="dump_kmer_count")
@click.argument("fastx_path", type=click.Path(exists=True))
@click.argument("ksize", type=int)
def dump_kmer_count(fastx_path, ksize):
    """Print per-k-mer occurrence counts of a FASTX file
    (capability of the reference's disabled apps/dump_kmer_count.cpp)."""
    from collections import Counter

    from kspider_tpu_torch.core import hashing
    from kspider_tpu_torch.io import fastx as fastx_io

    counts = Counter()
    for _, seq in fastx_io.read_records(fastx_path):
        counts.update(hashing.kmer_hashes_sourmash(seq, ksize).tolist())
    for h, c in sorted(counts.items()):
        print(f"{h}\t{c}")


@tools.command(name="normalize")
@click.option("--r1", type=click.Path(exists=True), required=True)
@click.option("--r2", type=click.Path(exists=True), required=False)
@click.option("-k", "--kmer-size", "ksize", required=True, type=int)
@click.option("--percentile", default=5.0, show_default=True, help="drop k-mers in the lowest count percentile")
@click.option("--max-kmers", default=100_000_000, show_default=True, help="cap on retained k-mers")
@click.option("-o", "--output", required=True, help="output .bin path")
def normalize(r1, r2, ksize, percentile, max_kmers, output):
    """Count-normalize reads into a hash set: drop the lowest-percentile
    k-mers by count, cap the total (capability of the reference's disabled
    apps/normalize_pe.cpp — including fixing its infinite-loop bug)."""
    from collections import Counter

    import numpy as np

    from kspider_tpu_torch.core import hashing
    from kspider_tpu_torch.io import fastx as fastx_io
    from kspider_tpu_torch.io import phmap as phmap_io

    counts = Counter()
    for path in filter(None, [r1, r2]):
        for _, seq in fastx_io.read_records(path):
            counts.update(hashing.kmer_hashes_sourmash(seq, ksize).tolist())
    if not counts:
        phmap_io.write_hash_set(output, np.empty(0, dtype=np.uint64))
        print("no kmers found")
        return
    hashes = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    vals = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
    order = np.argsort(vals, kind="stable")
    cutoff_idx = int(np.ceil(len(vals) * percentile / 100.0))
    cutoff = vals[order[cutoff_idx]] if cutoff_idx < len(vals) else vals.max() + 1
    keep = hashes[vals >= cutoff]
    removed = len(hashes) - len(keep)
    keep = np.sort(keep)[:max_kmers]
    phmap_io.write_hash_set(output, keep)
    print(
        f"kept {len(keep)} kmers (removed {removed} below count {cutoff}, "
        f"cap {max_kmers})"
    )


@tools.command(name="repr_sketches")
@click.argument("pairwise_tsv", type=click.Path(exists=True))
@click.option("--threshold", default=0.20, show_default=True, type=float, help="avg containment threshold")
def repr_sketches(pairwise_tsv, threshold):
    """Node degrees over edges with avg containment > threshold, sorted
    descending (reference apps/repr_sketches.cpp:27-43)."""
    from collections import Counter

    degrees = Counter()
    with open(pairwise_tsv) as f:
        next(f)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if float(parts[4]) > threshold:
                degrees[int(parts[0])] += 1
                degrees[int(parts[1])] += 1
    for node, deg in sorted(degrees.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"{node}: {deg}")


def main():
    cli()


if __name__ == "__main__":
    main()
