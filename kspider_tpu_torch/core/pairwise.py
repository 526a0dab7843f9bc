"""Pairwise stage: shared-k-mer matrix and reference-exact TSV output.

Counterpart of ``kspider_tpu/core/pairwise.py``, with the same output
contract (``kSpider::pairwise``):

- ``{p}_kSpider_seqToKmersNo.tsv``: header ``ID\\tseq\\tkmers``, then one row
  per ingested group: running 1-based counter, groupID, k-mer count.
- ``{p}_kSpider_pairwise.tsv``: the format and writers of
  ``kspider_tpu_torch.io.pairwise_tsv``, which emit kspider_tpu's bytes
  for the same pairs.

Up to ``AUTO_TILED_THRESHOLD`` samples a torch device runs the dense
engine (one NxN matrix); above it, or with ``engine="tiled"``, the
panel-streamed engine writes the TSV panel row by panel row.  ``--cpu``
(``device=None``) runs the numpy dense engine at any size, as kspider_tpu
does.
"""

from typing import Optional

import numpy as np

from kspider_tpu_torch.core.index import ColorIndex
from kspider_tpu_torch.io import pairwise_tsv as pw_tsv
from kspider_tpu_torch.ops import pairwise as pairwise_ops
from kspider_tpu_torch.parallel.mesh import make_mesh
from kspider_tpu_torch.utils.timing import profile_trace, timed

# beyond this sample count the JAX package switches to its panel-streamed
# engine (the int64 NxN host matrix would exceed ~2 GB)
AUTO_TILED_THRESHOLD = 16384


def write_seq_to_kmers_tsv(prefix: str, index: ColorIndex) -> None:
    ingested = np.flatnonzero(index.group_kmer_count >= 0)
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("ID\tseq\tkmers\n")
        for counter, g in enumerate(ingested, start=1):
            f.write(f"{counter}\t{g + 1}\t{index.group_kmer_count[g]}\n")


def write_pairwise_tsv(
    prefix: str, index: ColorIndex, shared: np.ndarray, min_shared: int = 1
) -> int:
    """Emit ``{p}_kSpider_pairwise.tsv`` from the dense shared matrix;
    returns the number of pair rows (``io/pairwise_tsv.write_dense``)."""
    return pw_tsv.write_dense(prefix + "_kSpider_pairwise.tsv", shared,
                              pw_tsv.kmer_counts(index), max(1, int(min_shared)))


def compute_shared_matrix(
    index: ColorIndex, *, device, engine: str = "auto",
    device_pack: Optional[str] = None,
) -> np.ndarray:
    """S[i, j] = number of k-mer hashes shared by groups i and j (int64).

    ``device=None`` runs the numpy host reference (the CLI's ``--cpu``)
    whatever the engine, as kspider_tpu does; otherwise ``device`` is one
    device or a device list and ``engine`` picks the dense, sharded or
    scatter engine (``ops.pairwise.shared_kmer_matrix``, which hands
    ``device_pack`` to the dense engine)."""
    args = (index.color_offsets, index.color_members, index.color_counts,
            index.num_groups)
    if device is None:
        return pairwise_ops.shared_kmer_matrix_numpy(*args)
    return pairwise_ops.shared_kmer_matrix(*args, device=device, engine=engine,
                                           device_pack=device_pack)


def run_pairwise(
    prefix: str,
    index: Optional[ColorIndex] = None,
    *,
    device,
    engine: str = "auto",
    panel: int = 4096,
    min_shared: int = 1,
    device_pack: Optional[str] = None,
    echo_timers: bool = True,
) -> Optional[np.ndarray]:
    """Full pairwise stage: load artifacts if needed, compute, emit TSVs.

    ``device`` is a torch device for the Gram kernel, a device list
    (``parallel/mesh.make_mesh``) whose devices share the work, or None for
    the numpy host engine.  ``engine="tiled"``, or ``"auto"`` with a device
    and more than ``AUTO_TILED_THRESHOLD`` samples, takes the panel-streamed
    engine (on the CPU when ``device`` is None) with ``panel``-wide panels
    and returns None: the pairs then live only in the TSV.  Otherwise
    ``engine`` ("auto", "bitmask", "pallas", "scatter" or "sharded", see
    :func:`compute_shared_matrix`) computes the dense shared matrix, which
    is returned.  ``device_pack`` (see ``ops.bitmask.device_pack_policy``)
    reaches either engine.  Each host step runs under a ``kspider.*``
    range (``utils.timing.timed``): ``load``, ``counts``, ``matrix`` (the
    engine) and, on the dense engine, ``tsv``; with ``echo_timers`` each
    prints the reference's timer line.  With ``KSPIDER_PROFILE`` set, the
    whole stage, index load through the last TSV byte, runs under one
    ``utils.timing.profile_trace``."""
    devices = [] if device is None else make_mesh(device)

    def step(name, label):
        return timed(name, label if echo_timers else None)

    with profile_trace(devices, "pairwise"):
        with step("kspider.load", "mapping colors to groups"):
            if index is None:
                from kspider_tpu_torch.io import artifacts, npz_index

                index = npz_index.load(prefix)
                if index is None:
                    index = artifacts.load_index_artifacts(prefix)

        with step("kspider.counts", "kmer counting"):
            write_seq_to_kmers_tsv(prefix, index)

        tiled = engine == "tiled" or (
            engine == "auto" and device is not None
            and index.num_groups > AUTO_TILED_THRESHOLD
        )
        if tiled:
            from kspider_tpu_torch.ops import tiled_pairwise

            with step("kspider.matrix", "pairwise matrix construction"):
                n_rows = tiled_pairwise.stream_pairwise_tsv(
                    index, prefix, device="cpu" if device is None else device,
                    panel=panel, min_shared=min_shared, device_pack=device_pack,
                    echo_progress=echo_timers,
                )
            if echo_timers:
                print(f"streamed {n_rows} pair rows to {prefix}_kSpider_pairwise.tsv")
            return None
        with step("kspider.matrix", "pairwise matrix construction"):
            shared = compute_shared_matrix(index, device=device, engine=engine,
                                           device_pack=device_pack)
        if echo_timers:
            print(f"writing pairwise matrix to {prefix}_kSpider_pairwise.tsv")
        with step("kspider.tsv", "pairwise TSV written"):
            write_pairwise_tsv(prefix, index, shared, min_shared=min_shared)
        return shared
