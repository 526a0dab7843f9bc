"""Device lists for multi-device runs.

Counterpart of ``kspider_tpu/parallel/mesh.py``.  JAX builds a one-axis
``Mesh`` over all of ``jax.devices()``; the port never picks devices on its
own, so the mesh is the explicit list the caller names.  Color blocks are
split over it in list order, as JAX splits them over its ``"shards"`` axis.

Repeated entries are allowed (``"cuda:0,cuda:0"``, ``["cpu"] * 8``): they
run several shards on one device, as JAX's tests do on virtual CPU devices.
"""

from typing import List

import torch

from kspider_tpu_torch.device import resolve_device


def make_mesh(devices) -> List[torch.device]:
    """The resolved device list for ``devices``: a ``torch.device``, a
    name, a comma-separated string of names (``"cuda:0,cuda:1"``) or a
    list of either.  Raises on an empty list and on any entry that
    ``resolve_device`` refuses."""
    if isinstance(devices, str):
        devices = [d.strip() for d in devices.split(",") if d.strip()]
    elif isinstance(devices, torch.device):
        devices = [devices]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("empty device list")
    return devices
