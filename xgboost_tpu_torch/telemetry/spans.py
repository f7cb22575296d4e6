"""Span tracer: named wall-clock brackets over the serving hot path (port of
xgboost_tpu/telemetry/spans.py:42-172).

``span("serve.execute")`` is a context manager that, when telemetry is
enabled, records its ``time.perf_counter_ns`` duration into the registry
histogram ``xtb_phase_seconds{phase=...}`` and opens a
``torch.profiler.record_function`` range, so the same label shows up in a
``torch.profiler`` trace.  The reference's flight ring and JSONL trace
sinks are not ported (ROADMAP Queue 1 item 11).

Disabled by default, and then cheap: one module-level flag, and the
disabled path returns a shared no-op context manager.
"""
from __future__ import annotations

import time
from typing import Dict

from .registry import get_registry

__all__ = ["span", "enable", "disable", "enabled", "record_phase", "Span",
           "phase_totals", "PHASE_HISTOGRAM"]

PHASE_HISTOGRAM = "xtb_phase_seconds"

_ENABLED = False
_phase_hist = None  # created on first use
_children: Dict[str, object] = {}  # phase name -> histogram child


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn span bookkeeping on or off (process-wide)."""
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def _child(name: str):
    global _phase_hist
    child = _children.get(name)
    if child is None:
        if _phase_hist is None:
            _phase_hist = get_registry().histogram(
                PHASE_HISTOGRAM,
                "wall-clock seconds per instrumented phase", ("phase",))
        child = _children.setdefault(name, _phase_hist.labels(name))
    return child


def record_phase(name: str, t0_ns: int, dur_ns: int) -> None:
    """Feed one finished bracket (start ``t0_ns``, ``dur_ns`` long) into the
    phase histogram."""
    del t0_ns  # the reference's trace sink reads it; the histogram does not
    _child(name).observe(dur_ns / 1e9)


class Span:
    """One enabled bracket (a context manager)."""

    __slots__ = ("name", "t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = 0
        self._range = None

    def begin(self) -> "Span":
        import torch.profiler

        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def end(self) -> int:
        dur = time.perf_counter_ns() - self.t0
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(None, None, None)
        record_phase(self.name, self.t0, dur)
        return dur

    def __enter__(self) -> "Span":
        return self.begin()

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """Shared no-op: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


def span(name: str):
    """A live Span when telemetry is enabled, the shared no-op otherwise."""
    return Span(name) if _ENABLED else _NULL


def phase_totals() -> Dict[str, Dict[str, float]]:
    """{phase: {"count": n, "seconds": s}} accumulated so far."""
    hist = get_registry().get(PHASE_HISTOGRAM)
    if hist is None:
        return {}
    return {values[0]: {"count": c, "seconds": s}
            for values, (c, s) in hist.snapshot_sums().items()}
