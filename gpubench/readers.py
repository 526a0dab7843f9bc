"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each reader takes a :class:`gpubench.trace.Window` and returns its number
per job of the window, or None when the trace holds nothing for it (the
harness then leaves the metric out of the result line).
"""

from typing import Iterable, Optional

from gpubench import trace as tr


def roofline_share(win: tr.Window, stage: str,
                   kernels: Iterable[str]) -> Optional[float]:
    """The Gram kernel's share of its roofline in ``stage``, in %: the least
    time that the stage's Gram work needs on this card (``roofline.py``,
    counted from the drawn index) over the summed device time of the
    kernel events (names holding one of ``kernels``) in the stage's jobs."""
    work = win.context.get("work", {}).get(stage)
    if work is None:
        return None
    least = work.least_s(win.context.get("kind", ""))
    spans = [s for k in kernels for s in win.device(k, cats=("kernel",))]
    per_job = win.within(stage, spans)
    kernel_s = sum(d for job in per_job for _, d in job) / 1e6
    if least is None or not per_job or kernel_s <= 0:
        return None
    return 100.0 * least / (kernel_s / len(per_job))


def idle_share(win: tr.Window, stage: str) -> Optional[float]:
    """The share of ``stage``'s wall in which no kernel, copy or set ran on
    the device, in %."""
    wall_ms = win.stage_ms(stage)
    if wall_ms <= 0:
        return None
    busy_ms = sum(tr.union_ms(job) for job in win.within(stage, win.device()))
    return 100.0 * (1.0 - busy_ms / wall_ms)


def range_ms(win: tr.Window, stage: str, names: Iterable[str]) -> Optional[float]:
    """Host ms per job in the program's ranges ``names`` in ``stage``."""
    found = [e for n in names for job in win.ranges_in(stage, n) for e in job]
    jobs = len(win.stages.get(stage, []))
    if not found or not jobs:
        return None
    return sum(e["dur"] for e in found) / jobs / 1000.0
