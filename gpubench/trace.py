"""Reading a ``torch.profiler`` Chrome trace of the measured window.

``union_ms`` and ``_spans`` are frozen copies of the program's
``kspider_tpu_torch/utils/timing.py`` trace arithmetic, so that a later
change to the program cannot change how the benchmark reads its trace.
:class:`Window` holds the trace's events with the benchmark's own stage
spans (``gpubench.<stage>`` ranges that ``run.py`` opens around each
command) and answers the questions the per-layer metric readers ask.
"""

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the prefix of the benchmark's own stage ranges
STAGE_PREFIX = "gpubench."


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


def load_events(path: str) -> List[dict]:
    """The complete events (``ph`` X) of a Chrome trace file."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def clip(spans: Iterable[Tuple[float, float]], lo: float, hi: float):
    """``(start, dur)`` spans cut to ``[lo, hi]`` (microseconds)."""
    out = []
    for s, d in spans:
        a, b = max(s, lo), min(s + d, hi)
        if b > a:
            out.append((a, b - a))
    return out


@dataclass
class Window:
    """The measured window's trace.

    ``events`` are the Chrome trace's complete events; ``stages`` maps a
    stage name to its ``(start us, duration us)`` spans, one per job, from
    the ``gpubench.<stage>`` ranges inside ``[lo, hi]``, the window.
    ``context`` carries what a reader needs besides the trace: the card's
    name (``kind``) and each stage's Gram work (``work``, see ``run.py``)."""

    events: List[dict]
    lo: float
    hi: float
    context: dict = field(default_factory=dict)
    stages: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)

    def __post_init__(self):
        for e in self.annotations():
            name = e["name"]
            if name.startswith(STAGE_PREFIX) and self.lo <= e["ts"] <= self.hi:
                self.stages.setdefault(name[len(STAGE_PREFIX):], []).append(
                    (e["ts"], e["dur"]))
        for spans in self.stages.values():
            spans.sort()

    def annotations(self, name: Optional[str] = None) -> List[dict]:
        """The ``record_function`` ranges (of one name), in time order."""
        return sorted((e for e in self.events if e.get("cat") == "user_annotation"
                       and (name is None or e.get("name") == name)),
                      key=lambda e: e["ts"])

    def device(self, name: str = "", cats=DEVICE_CATS) -> List[Tuple[float, float]]:
        """Device activity spans (of names holding ``name``)."""
        return _spans(self.events, cats, name)

    def within(self, stage: str, spans) -> List[List[Tuple[float, float]]]:
        """Per job of ``stage``: the given spans cut to that job's span."""
        return [clip(spans, s, s + d) for s, d in self.stages.get(stage, [])]

    def ranges_in(self, stage: str, name: str) -> List[List[dict]]:
        """Per job of ``stage``: the program's ``name`` ranges that start in it."""
        found = self.annotations(name)
        return [[e for e in found if s <= e["ts"] <= s + d]
                for s, d in self.stages.get(stage, [])]

    def stage_ms(self, stage: str) -> float:
        return sum(d for _, d in self.stages.get(stage, [])) / 1000.0

    def busy_ms(self) -> float:
        """The window's device busy time: the union of its activity."""
        return union_ms(clip(self.device(), self.lo, self.hi))


def innermost(marks: List[dict]) -> List[Tuple[float, float, str]]:
    """``(start, end, name)`` segments of the innermost open range of
    properly nested ranges (one thread's ``record_function`` ranges)."""
    edges = sorted([(e["ts"], 1, -e["dur"], e["name"]) for e in marks]
                   + [(e["ts"] + e["dur"], 0, 0, e["name"]) for e in marks])
    out, stack, at = [], [], None
    for t, opening, _, name in edges:
        if stack and t > at:
            out.append((at, t, stack[-1]))
        if opening:
            stack.append(name)
        elif name in stack:  # the last one opened of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        at = t
    return out


def idle_gaps(win: Window, top: int = 10) -> List[List[object]]:
    """The window's device idle time by what the host was doing: each
    stretch with no device activity is split by the innermost range then
    open on the thread of the stage ranges; seconds summed per range name,
    largest first."""
    busy = sorted(clip(win.device(), win.lo, win.hi))
    gaps, end = [], win.lo
    for s, d in busy:
        if s > end:
            gaps.append((end, s))
        end = max(end, s + d)
    if win.hi > end:
        gaps.append((end, win.hi))
    marks = win.annotations()
    stage_tids = {(e.get("pid"), e.get("tid")) for e in marks
                  if e["name"].startswith(STAGE_PREFIX)}
    segments = innermost([e for e in marks
                          if (e.get("pid"), e.get("tid")) in stage_tids])
    by_name: Dict[str, float] = {}
    k = 0
    for a, b in gaps:
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            lo, hi, name = segments[j]
            overlap = min(hi, b) - max(lo, a)
            if overlap > 0:
                by_name[name] = by_name.get(name, 0.0) + overlap / 1e6
            j += 1
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(win: Window, top: int = 10) -> List[List[object]]:
    """The device operations that took most time in the window (seconds)."""
    by_name: Dict[str, float] = {}
    for e in win.events:
        if e.get("cat") in DEVICE_CATS and win.lo <= e["ts"] <= win.hi:
            name = e.get("name", "")[:160]
            by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
