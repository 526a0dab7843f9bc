"""Wall-clock span timing.

The reference prints per-phase wall-clock spans around its hot loops
(kSpider/src/pairwise.cpp:131-133,155,181,239).  :func:`timed` opens a
``torch.profiler`` range around each host step of a stage and, when asked,
prints that line from the same two clock reads; :func:`profile_trace` writes
a stage's ``torch.profiler`` trace under ``KSPIDER_PROFILE`` (kspider_tpu's
hook wraps its pairwise stage in ``jax.profiler.trace``).
"""

import contextlib
import os
import socket
import time
from typing import Dict, Iterable, Iterator, List, Optional

from torch.profiler import record_function

#: the environment variable naming the directory of the stage traces
PROFILE_ENV = "KSPIDER_PROFILE"
#: open :func:`profile_trace` contexts in this process; only the outermost
#: one runs a profiler
_profile_depth = 0


@contextlib.contextmanager
def timed(name: str, label: Optional[str] = None) -> Iterator[None]:
    """Run the enclosed step under the ``record_function`` range ``name``.

    With ``label``, print the reference's ``"<label>: <secs> secs"`` line
    when the step returns; the seconds are read around the range.  Wrap the
    call that produces a generator's item, never a ``yield``: a range held
    across one charges the consumer's work to the producer."""
    t0 = time.perf_counter()
    with record_function(name):
        yield
    if label is not None:
        print(f"{label}: {time.perf_counter() - t0:.6g} secs")


def _all_threads_config():
    """The profiler setting that records ranges opened on every thread (a
    worker's ``kspider.pack``), or None where this torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(devices: Iterable, stage: str = "pairwise") -> Iterator[None]:
    """Trace the enclosed stage with ``torch.profiler`` when
    ``KSPIDER_PROFILE`` names a directory; an unset or empty value does
    nothing.

    CPU activity is always recorded, on every thread where this torch can,
    CUDA activity when any of ``devices`` (the stage's explicit torch
    devices or names; empty for the numpy host engine) is a CUDA device.
    On exit, also when the stage raises, one Chrome trace
    ``kspider_<stage>.<host>.<pid>.<time>.pt.trace.json`` is written into
    the directory, created if needed; Perfetto and TensorBoard's profiler
    plugin read it.  A profiler that fails to start or to write raises.
    Reentrant: a call inside another is a no-op, so a stage that calls
    another traced stage still writes one trace."""
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
        out_dir, worker_name=f"kspider_{stage}.{socket.gethostname()}.{os.getpid()}"),
        experimental_config=_all_threads_config())
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
