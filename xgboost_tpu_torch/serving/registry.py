"""Model registry: versioned snapshots with LRU residency and pinning (port
of xgboost_tpu/serving/registry.py).

The hot-model residency policy of arXiv:1603.02754's cache-conscious design
applied at model granularity: at most ``max_models`` snapshots keep their
stacked tree tensors device-resident; the least-recently-served unpinned
entry is evicted when a new model loads.  Versions are monotonically
numbered per name; ``pin`` freezes the version ``get`` resolves to (the
rollout/rollback knob) and pinned entries are never evicted.

Every exit from residency, LRU eviction for capacity and explicit
``remove()`` alike, funnels through one path:
``xtb_serve_evicted_total{model,reason}`` counts it and the registered
retirement hooks (:meth:`ModelRegistry.add_retire_hook`) fire.  The
serving engine's hook releases the snapshot's captured graphs, static
buffers and pinned staging there, so card memory does not grow with every
version.  Snapshots live on the registry's ``device`` (None: a Booster's
own device; a model path loads onto the card unless told otherwise).
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from .snapshot import InferenceSnapshot

_evicted = None  # xtb_serve_evicted_total family, created lazily


def _evicted_counter():
    global _evicted
    if _evicted is None:
        from ..telemetry.registry import get_registry

        _evicted = get_registry().counter(
            "xtb_serve_evicted_total",
            "snapshots leaving registry residency, by cause "
            "(lru = capacity eviction, retired = explicit remove)",
            ("model", "reason"))
    return _evicted


class _Entry:
    __slots__ = ("snapshot", "pinned", "tick")

    def __init__(self, snapshot: InferenceSnapshot) -> None:
        self.snapshot = snapshot
        self.pinned = False
        self.tick = 0


def _load_booster(source, device=None):
    """Booster passthrough, or load from a JSON/UBJSON model file onto
    ``device`` (None: the card)."""
    from ..core import Booster

    if isinstance(source, Booster):
        return source
    if isinstance(source, (str, os.PathLike)):
        return Booster(model_file=os.fspath(source), device=device)
    raise TypeError(
        f"model source must be a Booster or a .json/.ubj path, got "
        f"{type(source).__name__}")


class ModelRegistry:
    def __init__(self, max_models: int = 8, device=None) -> None:
        if max_models < 1:
            raise ValueError("max_models must be >= 1")
        self.max_models = int(max_models)
        self.device = device
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, int], _Entry] = {}
        self._latest: Dict[str, int] = {}
        self._pinned_version: Dict[str, int] = {}
        self._retire_hooks: List[Callable] = []
        self._clock = 0
        self.evictions = 0

    # ----------------------------------------------------------------- util
    def _touch(self, e: _Entry) -> None:
        self._clock += 1
        e.tick = self._clock

    def add_retire_hook(self, fn: Callable[[str, int, str, InferenceSnapshot],
                                           None]) -> None:
        """Register ``fn(name, version, reason, snapshot)`` to fire whenever
        a snapshot leaves residency (``reason`` = ``"lru"`` / ``"retired"``).
        Hooks run under the registry lock (RLock: re-entrant registry calls
        are fine) and must be cheap and non-blocking."""
        with self._lock:
            self._retire_hooks.append(fn)

    def _retire_entry(self, key: Tuple[str, int], entry: _Entry,
                      reason: str) -> None:
        """The ONE exit path from residency (caller holds the lock): count
        it, fire the retirement hooks, keep get(name) resolving to the
        highest surviving version."""
        del self._entries[key]
        name, version = key
        _evicted_counter().labels(name, reason).inc()
        for fn in self._retire_hooks:
            try:
                fn(name, version, reason, entry.snapshot)
            except Exception as e:  # a broken hook must not corrupt residency
                warnings.warn(f"registry retire hook failed for "
                              f"{key}: {e!r}", RuntimeWarning, stacklevel=3)
        # retiring the latest version must not orphan still-resident older
        # ones: keep get(name) resolving to the highest surviving version
        if self._latest.get(name) == version:
            remaining = [v for n, v in self._entries if n == name]
            if remaining:
                self._latest[name] = max(remaining)
            else:
                self._latest.pop(name, None)

    def _evict_for_capacity(self) -> None:
        while len(self._entries) >= self.max_models:
            victims = [(e.tick, key) for key, e in self._entries.items()
                       if not e.pinned]
            if not victims:
                raise RuntimeError(
                    f"registry full ({self.max_models} models, all pinned); "
                    "unpin or raise ServeConfig.max_models")
            _, key = min(victims)
            self.evictions += 1
            self._retire_entry(key, self._entries[key], "lru")

    # ------------------------------------------------------------------ API
    def register(self, name: str, source, version: Optional[int] = None,
                 ) -> int:
        """Snapshot ``source`` (Booster or model path) under ``name``.
        Returns the version number (auto-incremented when not given)."""
        # replacing a pinned version keeps the pin (the replacement is
        # what get() now resolves to; it must not become LRU-evictable)
        booster = _load_booster(source, self.device)
        return self.register_snapshot(
            name, InferenceSnapshot.from_booster(booster, self.device),
            version)

    def register_snapshot(self, name: str, snap: InferenceSnapshot,
                          version: Optional[int] = None) -> int:
        """Register an already-built snapshot."""
        with self._lock:
            if version is None:
                version = self._latest.get(name, 0) + 1
            version = int(version)
            if (name, version) not in self._entries:
                self._evict_for_capacity()
            e = _Entry(snap)
            e.pinned = self._pinned_version.get(name) == version
            self._entries[(name, version)] = e
            self._latest[name] = max(self._latest.get(name, 0), version)
            self._touch(e)
            return version

    def get(self, name: str, version: Optional[int] = None,
            ) -> Tuple[InferenceSnapshot, int]:
        with self._lock:
            if version is None:
                version = self._pinned_version.get(
                    name, self._latest.get(name))
            if version is None:
                raise KeyError(f"unknown model {name!r}")
            e = self._entries.get((name, int(version)))
            if e is None:
                raise KeyError(
                    f"model {name!r} version {version} is not resident "
                    "(never registered, or LRU-evicted); re-register it")
            self._touch(e)
            return e.snapshot, int(version)

    def pin(self, name: str, version: int) -> None:
        """Resolve ``get(name)`` to ``version`` and shield it from eviction."""
        with self._lock:
            key = (name, int(version))
            if key not in self._entries:
                raise KeyError(f"cannot pin absent model {key}")
            # at most one pinned version per name
            old = self._pinned_version.get(name)
            if old is not None and (name, old) in self._entries:
                self._entries[(name, old)].pinned = False
            self._pinned_version[name] = int(version)
            self._entries[key].pinned = True

    def unpin(self, name: str) -> None:
        with self._lock:
            v = self._pinned_version.pop(name, None)
            if v is not None and (name, v) in self._entries:
                self._entries[(name, v)].pinned = False

    def remove(self, name: str, version: Optional[int] = None) -> None:
        with self._lock:
            keys = [k for k in self._entries
                    if k[0] == name and (version is None or k[1] == version)]
            for k in keys:
                # same single exit path as LRU eviction: the retirement
                # hooks + counter fire identically for a lifecycle retire
                self._retire_entry(k, self._entries[k], "retired")
            if version is None or self._pinned_version.get(name) == version:
                self._pinned_version.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._entries})

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(v for n, v in self._entries if n == name)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.snapshot.nbytes for e in self._entries.values())

    def snapshots(self) -> List[InferenceSnapshot]:
        """The resident snapshots."""
        with self._lock:
            return [e.snapshot for e in self._entries.values()]
