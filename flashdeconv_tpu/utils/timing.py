"""Structured per-stage timing + optional JAX profiler trace hooks.

The reference has no tracing/profiling subsystem (SURVEY.md §5: bare prints
under ``verbose``); this is the package's observability layer. A
:class:`StageTimer` collects wall-clock per pipeline stage into a plain dict
(surfaced as ``FlashDeconv.timings_``), and :func:`trace` wraps a block in a
``jax.profiler`` trace when a trace directory is configured — viewable in
TensorBoard / Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Collects named wall-clock stage timings.

    Usage::

        timer = StageTimer()
        with timer.stage("sketch"):
            ...
        timer.timings  # {"sketch": 0.42, ...}
    """

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def total(self) -> float:
        return sum(self.timings.values())

    def report(self) -> str:
        """Aligned multi-line report, slowest stage first."""
        if not self.timings:
            return "(no stages timed)"
        width = max(len(k) for k in self.timings)
        lines = [
            f"  {name:<{width}}  {secs:8.3f}s  ({100 * secs / max(self.total, 1e-12):5.1f}%)"
            for name, secs in sorted(
                self.timings.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines + [f"  {'total':<{width}}  {self.total:8.3f}s"])


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Wrap a block in a ``jax.profiler`` trace when tracing is enabled.

    Tracing is enabled by passing ``trace_dir`` or setting the
    ``FLASHDECONV_TRACE_DIR`` environment variable; otherwise this is a
    zero-overhead no-op. Traces are written one subdirectory per ``name``.
    """
    trace_dir = trace_dir or os.environ.get("FLASHDECONV_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, name)):
        yield
