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
from typing import Dict, Iterable, Iterator, List, Optional

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


#: the CUDA runtime calls by which the host waits for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def host_waits(events: List[dict], ranges: Iterable[str]) -> Dict[str, List[dict]]:
    """The host waits inside each occurrence of the named ranges of a
    Chrome trace (``traceEvents`` of a :func:`profile_trace` file).

    Returns, per range name, one dict per occurrence in time order, mapping
    each of :data:`HOST_WAITS` to the number of such runtime calls that the
    range's thread made inside it."""
    ranges = set(ranges)
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name") in ranges), key=lambda e: e["ts"])
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("name") in HOST_WAITS]
    out: Dict[str, List[dict]] = {name: [] for name in ranges}
    for span in spans:
        lo, hi = span["ts"], span["ts"] + span["dur"]
        counts = dict.fromkeys(HOST_WAITS, 0)
        for c in calls:
            if (c.get("pid"), c.get("tid")) == (span.get("pid"), span.get("tid")) \
                    and lo <= c["ts"] <= hi:
                counts[c["name"]] += 1
        out[span["name"]].append(counts)
    return out


def union_ms(spans: Iterable) -> float:
    """Length of the union of ``(start us, duration us)`` intervals, in ms."""
    total, end = 0.0, None
    for lo, dur in sorted(spans):
        hi = lo + dur
        if end is None or lo > end:
            total, end = total + dur, hi
        elif hi > end:
            total, end = total + hi - end, hi
    return total / 1000.0


def _spans(events: List[dict], cats, name: str = "") -> List[tuple]:
    return [(e["ts"], e["dur"]) for e in events if e.get("ph") == "X"
            and e.get("cat") in cats and name in e.get("name", "")]


def pipeline_numbers(events: List[dict], kernel: str,
                     ranges: Iterable[str]) -> Dict[str, object]:
    """The device pipeline in a Chrome trace's events: the device's busy ms
    (the union of kernels, copies and sets), the ms of the kernels whose
    name holds ``kernel``, the H2D bytes from pinned and from pageable
    memory, the H2D ms and the part of it under such a kernel, and per
    range of ``ranges`` its :func:`host_waits`."""
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    h_spans = [(e["ts"], e["dur"]) for e in h2d]
    k_spans = _spans(events, ("kernel",), kernel)
    return {
        "busy_ms": union_ms(_spans(events, ("kernel", "gpu_memcpy",
                                            "gpu_memset"))),
        "kernel_ms": sum(d for _, d in k_spans) / 1000.0,
        "kernel_events": len(k_spans),
        "h2d_pinned_bytes": sum(e.get("args", {}).get("bytes", 0) for e in h2d
                                if "Pinned" in e["name"]),
        "h2d_pageable_bytes": sum(e.get("args", {}).get("bytes", 0)
                                  for e in h2d if "Pageable" in e["name"]),
        "h2d_ms": union_ms(h_spans),
        "h2d_under_kernels_ms": union_ms(h_spans) + union_ms(k_spans)
        - union_ms(h_spans + k_spans),
        "waits": host_waits(events, ranges),
    }
