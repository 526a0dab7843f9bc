"""The Gram product's work, counted from the drawn index, and the card's peaks.

The pairwise product is S = Aᵀ·diag(w)·A over the colors of two or more
genomes, with each weight split into base-128 int8 limbs, so one product
of one limb over one color and one pair of genomes is 2 int8 operations.
The counts below are what the inputs need, whatever implements the
product: never the kernel's launches, tiles or padding.

- :func:`dense_work`: every pair of the upper triangle, diagonal included,
  over every color of two or more genomes (one N x N product).
- :func:`panel_work`: per pair of genome panels of width ``panel``, the
  colors with members in both panels (on a diagonal pair, two or more
  members in the panel) over the pair's genomes (its upper triangle on a
  diagonal pair).

Bytes count each input bit-plane (one bit per genome and color) and limb
read once and each int32 output written once.  The least time is the
larger of operations over the peak int8 rate and bytes over the peak
memory bandwidth.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

#: published dense peaks (NVIDIA's H100 data sheet, no sparsity), by the
#: name ``torch.cuda.get_device_name()`` gives
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "bytes": 3.35e12},
}

#: the ``pairwise`` command runs the panel engine above this many genomes
#: on a device, or with ``--engine tiled`` (its documented behaviour)
DENSE_MAX_GENOMES = 16384
#: the commands' default ``--panel``
DEFAULT_PANEL = 4096


@dataclass
class Work:
    ops: float
    bytes: float

    def least_s(self, kind: str) -> Optional[float]:
        """The least time on the card named ``kind``; None if its peaks are
        not in :data:`PEAKS`."""
        peak = PEAKS.get(kind)
        if peak is None:
            return None
        return max(self.ops / peak["int8_ops"], self.bytes / peak["bytes"])


def _multi(offsets, counts):
    degrees = np.diff(offsets)
    return np.flatnonzero(degrees >= 2), degrees


def limbs(counts: np.ndarray) -> int:
    """Base-128 limbs that the largest count needs."""
    top, n = int(np.max(counts, initial=0)), 1
    while top >= 128 ** n:
        n += 1
    return n


def dense_work(offsets, members, counts, n: int) -> Work:
    keep, _ = _multi(offsets, counts)
    c = len(keep)
    if c == 0:
        return Work(0.0, 0.0)
    el = limbs(counts[keep])
    pairs = n * (n + 1) / 2
    return Work(ops=2.0 * el * c * pairs,
                bytes=c * n / 8 + c * el + 4.0 * el * pairs)


def panel_work(offsets, members, counts, n: int, panel: int) -> Work:
    keep, degrees = _multi(offsets, counts)
    if len(keep) == 0:
        return Work(0.0, 0.0)
    el = limbs(counts[keep])
    n_panels = -(-n // panel)
    widths = np.minimum(panel, n - panel * np.arange(n_panels)).astype(np.float64)
    color = np.repeat(np.arange(len(degrees), dtype=np.int64), degrees)
    # per color and panel: members in the panel
    per = np.bincount(color * n_panels + members // panel,
                      minlength=len(degrees) * n_panels)
    per = per.reshape(len(degrees), n_panels)[keep]
    present = (per > 0).astype(np.float64)
    colors = present.T @ present  # colors with members in both panels
    np.fill_diagonal(colors, (per >= 2).sum(axis=0))
    a, b = np.triu_indices(n_panels)
    c = colors[a, b]
    outputs = np.where(a == b, widths[a] * (widths[a] + 1) / 2,
                       widths[a] * widths[b])
    bits = np.where(a == b, c * widths[a] / 8, c * (widths[a] + widths[b]) / 8)
    return Work(ops=float((2.0 * el * c * outputs).sum()),
                bytes=float((bits + c * el + 4.0 * el * outputs).sum()))


def stage_work(command: str, options: dict, offsets, members, counts,
               n: int) -> Optional[Work]:
    """The Gram work of one command of a mix, or None if it runs none."""
    panel = int(options.get("--panel", DEFAULT_PANEL))
    if command == "cluster":
        if not options.get("--from-index"):
            return None
        return panel_work(offsets, members, counts, n, panel)
    if command == "pairwise":
        if options.get("--engine") == "tiled" or n > DENSE_MAX_GENOMES:
            return panel_work(offsets, members, counts, n, panel)
        return dense_work(offsets, members, counts, n)
    return None
