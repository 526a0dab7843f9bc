"""Wall-clock span timing.

The reference prints per-phase wall-clock spans around its hot loops
(kSpider/src/pairwise.cpp:131-133,155,181,239).  We provide the
same observability as a context manager plus an in-memory registry that the
bench harness can read back, and the profiler hook of the pairwise stage:
:func:`profile_trace`, a ``torch.profiler`` trace written under
``KSPIDER_PROFILE`` (kspider_tpu's hook wraps the same stage in
``jax.profiler.trace``).
"""

import contextlib
import os
import socket
import time
from typing import Dict, Iterable, Iterator, Optional

#: the environment variable naming the directory of the pairwise traces
PROFILE_ENV = "KSPIDER_PROFILE"
#: open :func:`profile_trace` contexts in this process; only the outermost
#: one runs a profiler
_profile_depth = 0


class Span:
    """Accumulates named wall-clock spans (seconds)."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, echo: bool = False) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            if echo:
                print(f"{name}: {dt:.6g} secs")


@contextlib.contextmanager
def timed(name: str, echo: bool = True, registry: Optional[Span] = None) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if registry is not None:
            registry.spans[name] = registry.spans.get(name, 0.0) + dt
        if echo:
            print(f"{name}: {dt:.6g} secs")


@contextlib.contextmanager
def profile_trace(devices: Iterable) -> Iterator[None]:
    """Trace the enclosed stage with ``torch.profiler`` when
    ``KSPIDER_PROFILE`` names a directory; an unset or empty value does
    nothing.

    CPU activity is always recorded, CUDA activity when any of ``devices``
    (the stage's explicit torch devices or names; empty for the numpy host
    engine) is a CUDA device.  On exit, also when the stage raises, one
    Chrome trace ``kspider_pairwise.<host>.<pid>.<time>.pt.trace.json`` is
    written into the directory, created if needed; Perfetto and
    TensorBoard's profiler plugin read it.  A profiler that fails to start
    or to write raises.  Reentrant: a call inside another is a no-op, so a
    stage that calls another traced stage still writes one trace."""
    global _profile_depth
    out_dir = os.environ.get(PROFILE_ENV)
    if not out_dir or _profile_depth:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if any(torch.device(d).type == "cuda" for d in devices):
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
        out_dir, worker_name=f"kspider_pairwise.{socket.gethostname()}.{os.getpid()}"))
    _profile_depth += 1
    try:
        prof.start()
        try:
            yield
        finally:
            prof.stop()
    finally:
        _profile_depth -= 1
