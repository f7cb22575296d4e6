"""Telemetry for the port (as far as serving uses it): the metrics
registry (``registry.py``) and the span tracer (``spans.py``).  The rest
of the reference's ``xgboost_tpu/telemetry/`` is ROADMAP Queue 1 item 11."""
from .registry import (Counter, Gauge, Histogram, Registry, get_registry,
                       render_prometheus)
from .spans import enable, enabled, phase_totals, record_phase, span

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "render_prometheus", "span", "enable", "enabled", "record_phase",
           "phase_totals"]
