"""Lock-cheap metrics registry: Counter / Gauge / Histogram with labels
(port of xgboost_tpu/telemetry/registry.py, as far as serving registers
its metrics into it).

The Prometheus client's data model (counter, gauge and histogram families
keyed by label sets), stripped to what a serving process needs: one lock
per family, held for a dict lookup and a few float adds; label children
cached on first use, so steady increments never allocate.
``render_prometheus()`` gives the text exposition format (``# HELP`` /
``# TYPE`` and one line a sample).  The reference's exemplars, bucketed
merges and cross-process snapshots are not ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "render_prometheus", "DEFAULT_BUCKETS"]

# seconds-scale exponential buckets: 100us .. ~100s
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-4 * (4.0 ** i)
                                           for i in range(10))


def _validate_name(name: str) -> None:
    # Prometheus exposition: [a-zA-Z_:][a-zA-Z0-9_:]*
    if (not name or not name.isascii() or name[0].isdigit()
            or not all(c.isalnum() or c in "_:" for c in name)):
        raise ValueError(f"invalid metric name {name!r}")


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Family:
    """A metric family: a name, label names and cached label children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = (),
                 ) -> None:
        _validate_name(name)
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._child())
        return child

    def _child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def collect(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _label_str(self, values: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.label_names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class _Value:
    """One float cell guarded by its family's lock."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self.value = 0.0

    def get(self) -> float:
        return self.value


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _ScalarFamily(_Family):
    def get(self, *values, **kv) -> float:
        return self.labels(*values, **kv).get()

    def render(self) -> Iterable[str]:
        for values, child in sorted(self.collect()):
            yield f"{self.name}{self._label_str(values)} {_fmt(child.value)}"


class Counter(_ScalarFamily):
    kind = "counter"

    def _child(self) -> _CounterChild:
        return _CounterChild(self._lock)


class _GaugeChild(_Value):
    def set_max(self, v: float) -> None:
        """Atomic monotonic raise (a high-water mark)."""
        with self._lock:
            if v > self.value:
                self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge(_ScalarFamily):
    kind = "gauge"

    def _child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set_max(self, v: float) -> None:
        self.labels().set_max(v)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]):
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, label_names)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or not all(math.isfinite(x) for x in b):
            raise ValueError("histogram needs at least one finite bucket "
                             "and no non-finite bounds")
        self.buckets = b

    def _child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self.buckets)

    def snapshot_sums(self) -> Dict[Tuple[str, ...], Tuple[int, float]]:
        """{label values: (count, sum)}."""
        with self._lock:
            return {values: (child.count, child.sum)
                    for values, child in self._children.items()}

    def render(self) -> Iterable[str]:
        for values, child in sorted(self.collect()):
            cum = 0
            for bound, c in zip(self.buckets, child.counts):
                cum += c
                le = self._label_str(values, f'le="{_fmt(bound)}"')
                yield f"{self.name}_bucket{le} {cum}"
            cum += child.counts[-1]
            le = self._label_str(values, 'le="+Inf"')
            yield f"{self.name}_bucket{le} {cum}"
            yield (f"{self.name}_sum{self._label_str(values)} "
                   f"{_fmt(child.sum)}")
            yield f"{self.name}_count{self._label_str(values)} {cum}"


class Registry:
    """Named metric families; get-or-create is idempotent per (name, kind)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()

    def _get_or_create(self, cls, name: str, help: str, label_names,
                       **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != tuple(
                        label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                if "buckets" in kw and fam.buckets != tuple(
                        sorted(float(x) for x in kw["buckets"])):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = cls(name, help, label_names, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def render_prometheus(self) -> str:
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


_default = Registry()


def get_registry() -> Registry:
    return _default


def render_prometheus() -> str:
    """Text exposition of the process-default registry."""
    return _default.render_prometheus()
