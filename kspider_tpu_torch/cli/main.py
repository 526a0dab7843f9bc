"""CLI of the port: ``python -m kspider_tpu_torch`` / ``kspider-torch``.

``index``, ``pairwise`` and ``cluster`` are the port's own and keep the
option names of ``kspider_tpu/cli/main.py``, plus ``--device`` (default
``cuda``), the torch device of ``index --device-build`` and of the Gram
kernel; ``pairwise`` and ``cluster`` also take a comma-separated device
list (``cuda:0,cuda:1``) whose devices share the Gram product.  ``--cpu``
keeps its meaning: the numpy / scipy host engines.  ``pairwise
--num-processes N --process-id R --coordinator HOST:PORT`` runs one of N
coordinated processes (``parallel/multiprocess.py``), each on one device.
The other jax-free commands of the JAX package (sketch, hidden FASTA
indexers, export, tools) are registered unchanged.
"""

import os
from glob import glob

import click

from kspider_tpu.cli import main as tpu_cli
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


for _cmd, _priority in (
    (tpu_cli.sketch, 1),
    (tpu_cli.index_kmers, 1),
    (tpu_cli.index_skipmers, 2),
    (tpu_cli.index_protein, 3),
    (tpu_cli.export, 5),
    (tpu_cli.tools, 6),
):
    cli.add_command(_cmd)
    cli.help_priorities[_cmd.name] = _priority


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
@click.option("--device-pack", "device_pack", default=None, type=click.Choice(["auto", "force", "off"]), help="ship sparse panel sides as posting keys and pack them on the device (tiled engine; default: env KSPIDER_DEVICE_PACK or auto; the dense engine packs on the host)")
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

    from kspider_tpu.models import ani as ani_model

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

    log = ctx.obj
    device = _resolve(log, device_name, force_cpu, many=True)
    if from_index:
        from kspider_tpu.io import artifacts, npz_index

        index = npz_index.load(index_prefix)
        if index is None:
            index = artifacts.load_index_artifacts(index_prefix)
        out = core_cluster.cluster_from_index(
            index, index_prefix, cutoff, dist_type=distance_type,
            device=device, panel=panel, min_shared=min_shared, logger=log,
        )
        log.SUCCESS(f"Clusters written to {out}")
        return
    log.INFO("Building the main graph...")
    out = core_cluster.cluster_index(
        index_prefix, cutoff, dist_type=distance_type,
        device=device[0] if isinstance(device, list) else device, logger=log,
    )
    log.SUCCESS(f"Clusters written to {out}")


def main():
    cli()


if __name__ == "__main__":
    main()
