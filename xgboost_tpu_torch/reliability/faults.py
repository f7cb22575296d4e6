"""Deterministic fault injection (port of xgboost_tpu/reliability/faults.py:
155-410, as far as the serving tests drive it).

A *seam* is a named call site that consults the installed
:class:`FaultPlan` before its real work; the serving batcher's worker loop
is the seam ``serve.worker``.  A plan is a list of :class:`FaultSpec`, each
matching a seam by name and optionally by ``rank``, ``round`` or ``at``
(the Nth invocation of that seam in this process), firing at most
``times`` times.  Every matcher is an explicit value and the invocation
counters advance in program order, so a plan replays identically.

Kinds: ``kill`` (``os._exit(exit_code)``), ``exception`` (raise
:class:`FaultInjected`), ``delay`` (sleep ``seconds``).  The reference's
resource and network kinds wait for the seams that use them.

Plans install with :func:`install` or through ``XGBOOST_TPU_FAULT_PLAN``
(inline JSON or a path to a JSON file).  With no plan every seam costs one
module-attribute read.  Every fired fault counts into
``xtb_faults_injected_total{site,kind}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Union

__all__ = ["FaultInjected", "FaultSpec", "FaultPlan", "install", "clear",
           "active", "maybe_inject", "ENV_VAR"]

ENV_VAR = "XGBOOST_TPU_FAULT_PLAN"

_KINDS = ("kill", "exception", "delay")


class FaultInjected(RuntimeError):
    """Raised at a seam by an ``exception`` fault spec."""


@dataclasses.dataclass
class FaultSpec:
    """One planned fault.  ``site`` and ``kind`` are required; the rest are
    matchers and parameters (``None`` matches any)."""

    site: str
    kind: str
    rank: Optional[int] = None       # fire only on this worker rank
    round: Optional[int] = None      # fire only at this training round
    at: Optional[int] = None         # fire only on the Nth seam hit (0-based)
    times: int = 1                   # fire at most this many times
    seconds: float = 0.0             # delay duration
    exit_code: int = 43              # kill exit status
    message: str = "injected fault"

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")

    def matches(self, invocation: int, rank: Optional[int],
                round: Optional[int]) -> bool:
        if self.at is not None and invocation != self.at:
            return False
        if self.round is not None and round != self.round:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        return True


class FaultPlan:
    """An installed set of :class:`FaultSpec` with per-site invocation and
    per-spec fired counters (process-local, lock-guarded)."""

    def __init__(self, specs: List[FaultSpec]) -> None:
        self.specs = list(specs)
        self._fired: Dict[int, int] = {}    # spec index -> times fired
        self._calls: Dict[str, int] = {}    # site -> invocation counter
        self._lock = threading.Lock()

    @classmethod
    def from_dict(cls, obj: Union[dict, list]) -> "FaultPlan":
        raw = obj.get("faults", []) if isinstance(obj, dict) else obj
        known = {fld.name for fld in dataclasses.fields(FaultSpec)}
        specs = []
        for f in raw:
            unknown = set(f) - known
            if unknown:
                raise ValueError(f"unknown fault-spec keys {sorted(unknown)}")
            specs.append(FaultSpec(**f))
        return cls(specs)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def fired(self, site: Optional[str] = None) -> int:
        """Faults fired so far (only at ``site`` where given)."""
        with self._lock:
            return sum(n for i, n in self._fired.items()
                       if site is None or self.specs[i].site == site)

    def _claim(self, site: str, rank, round) -> Optional[FaultSpec]:
        """Count the seam's invocation and claim the first spec that
        matches it and has firings left."""
        with self._lock:
            inv = self._calls.get(site, 0)
            self._calls[site] = inv + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site or self._fired.get(i, 0) >= spec.times:
                    continue
                if spec.matches(inv, rank, round):
                    self._fired[i] = self._fired.get(i, 0) + 1
                    return spec
        return None


_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_counter = None  # xtb_faults_injected_total, created on first use


def install(plan: Union[FaultPlan, dict, list, str, None]
            ) -> Optional[FaultPlan]:
    """Install a fault plan process-wide (a plan, dict, list or JSON text);
    ``None`` clears.  Returns the installed :class:`FaultPlan`."""
    global _PLAN, _ENV_CHECKED
    if plan is None or isinstance(plan, FaultPlan):
        _PLAN = plan
    elif isinstance(plan, str):
        _PLAN = FaultPlan.from_json(plan)
    else:
        _PLAN = FaultPlan.from_dict(plan)
    _ENV_CHECKED = True  # a programmatic install wins over the env var
    return _PLAN


def clear() -> None:
    """Remove the installed plan and forget that the env var was read."""
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = False


def active() -> Optional[FaultPlan]:
    """The installed plan, loading ``XGBOOST_TPU_FAULT_PLAN`` on first use;
    None when fault injection is off."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        raw = os.environ.get(ENV_VAR, "").strip()
        if raw:
            if not raw.startswith(("{", "[")):
                with open(raw) as fh:
                    raw = fh.read()
            _PLAN = FaultPlan.from_json(raw)
    return _PLAN


def _count(site: str, kind: str) -> None:
    global _counter
    if _counter is None:
        from ..telemetry.registry import get_registry

        _counter = get_registry().counter(
            "xtb_faults_injected_total", "faults fired by the injection "
            "harness", ("site", "kind"))
    _counter.labels(site, kind).inc()


def maybe_inject(site: str, *, rank: Any = None,
                 round: Optional[int] = None) -> Optional[FaultSpec]:
    """The seam's entry point: applies a matching ``kill``, ``exception``
    or ``delay`` spec and returns it (None when nothing fired).  ``rank``
    may be an int or a zero-argument callable, called only when a spec of
    this site constrains the rank."""
    plan = _PLAN  # the fast path: one global read
    if plan is None:
        plan = active()
        if plan is None:
            return None
    if callable(rank):
        rank = rank() if any(s.site == site and s.rank is not None
                             for s in plan.specs) else None
    spec = plan._claim(site, rank, round)
    if spec is None:
        return None
    _count(site, spec.kind)
    if spec.kind == "kill":
        print(f"[faults] kill at {site} (rank={rank} round={round}): "
              f"{spec.message}", file=sys.stderr, flush=True)
        os._exit(spec.exit_code)
    if spec.kind == "exception":
        raise FaultInjected(f"{site}: {spec.message}")
    time.sleep(spec.seconds)  # delay
    return spec
