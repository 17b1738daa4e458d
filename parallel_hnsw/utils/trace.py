"""Structured tracing: per-phase timers + JAX profiler hooks.

The reference has no structured tracing — build phases narrate through
pervasive ``eprintln!`` (reference: src/lib.rs:687-874, promotion logging
src/lib.rs:1280-1359) and its one real instrumentation channel is
``search_layers_instrumented``'s index-distance sum (src/search.rs:93-140),
which this framework keeps as ``Hnsw.search_instrumented``.  SURVEY §5
prescribes the upgrade implemented here: structured phase events with wall
times and counters, nestable, plus an on-demand ``jax.profiler`` trace
context for XLA-level analysis.

Design notes:
* A phase's wall time only means something if the device work launched inside
  it has retired; XLA dispatch is async.  ``span(..., sync=x)`` accepts an
  array (or pytree) to ``block_until_ready`` on before closing the timer.
* Tracing must stay zero-cost when disabled: the global tracer defaults to
  disabled and ``span`` short-circuits.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class PhaseEvent:
    """One completed phase: name, nesting depth, wall seconds, counters."""

    name: str
    depth: int
    seconds: float
    counters: Dict[str, float] = field(default_factory=dict)


def _sync(x: Any) -> None:
    """Wait until the device work producing ``x`` (a pytree) has retired."""
    import jax

    jax.block_until_ready(x)


class Tracer:
    """Collects nested phase timings as structured events.

    >>> t = Tracer(enabled=True)
    >>> with t.span("build"):
    ...     with t.span("layer0", n_nodes=100):
    ...         pass
    >>> t.events[0].name, t.events[1].name
    ('layer0', 'build')
    """

    def __init__(self, enabled: bool = False, log=None):
        self.enabled = enabled
        self.log = log
        self.events: List[PhaseEvent] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, sync: Any = None, **counters: float) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        self._depth += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self._depth -= 1
            ev = PhaseEvent(name, self._depth, dt, dict(counters))
            self.events.append(ev)
            if self.log is not None:
                pad = "  " * ev.depth
                extra = "".join(f" {k}={v}" for k, v in ev.counters.items())
                self.log(f"[trace] {pad}{name}: {dt*1e3:.1f}ms{extra}")

    def count(self, name: str, **counters: float) -> None:
        """Record an instantaneous counter event (zero duration)."""
        if self.enabled:
            self.events.append(PhaseEvent(name, self._depth, 0.0, dict(counters)))

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate totals per phase name: total seconds + call count."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            row = out.setdefault(ev.name, {"seconds": 0.0, "calls": 0.0})
            row["seconds"] += ev.seconds
            row["calls"] += 1.0
        return out

    def format_summary(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["seconds"])
        lines = [f"{'phase':<32} {'calls':>6} {'total_s':>9}"]
        for name, row in rows:
            lines.append(f"{name:<32} {int(row['calls']):>6} {row['seconds']:>9.2f}")
        return "\n".join(lines)


#: Global tracer; disabled (zero-cost) unless a caller enables it.
TRACER = Tracer(enabled=False)


def enable_tracing(log=print) -> Tracer:
    """Turn on the global tracer (optionally routing events to ``log``)."""
    TRACER.enabled = True
    TRACER.log = log
    return TRACER


@contextlib.contextmanager
def jax_profile(logdir: str) -> Iterator[None]:
    """On-demand XLA profiler capture around a code region.

    Produces a TensorBoard-loadable trace (host + device timelines, HLO ops).
    Replaces the reference's profiler-symbol affordance
    (Cargo.toml:7-8, ``profile.release.debug = true``).
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
