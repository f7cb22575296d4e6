"""Diff-friendly debug dumps (port of xgboost_tpu/utils/observer.py, as far
as ``serving/metrics.py:ServingMetrics.export`` uses it).

Reference: src/common/observer.h:38 prints internals under
XGBOOST_USE_DEBUG_OUTPUT for cross-build diffing.  Enable with
XGBOOST_TPU_DEBUG_OBSERVER=1.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

_ENABLED: Optional[bool] = None


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("XGBOOST_TPU_DEBUG_OBSERVER",
                                  "0") in ("1", "true")
    return _ENABLED


def observe_serving(snapshot: dict, tag: str = "serving") -> None:
    """Stream a ServingMetrics snapshot (serving/metrics.py), one line per
    signal, to stderr."""
    if not enabled():
        return
    print(f"[observer] {tag}: queue_depth={snapshot.get('queue_depth')} "
          f"queue_peak={snapshot.get('queue_peak')} "
          f"compiles_warmup={snapshot.get('compiles_warmup')} "
          f"compiles_steady={snapshot.get('compiles_steady')}",
          file=sys.stderr, flush=True)
    for name, m in sorted(snapshot.get("models", {}).items()):
        lat = m.get("latency_ms") or {}

        def fmt(v):
            return "n/a" if v is None else f"{v:.3f}"

        print(f"[observer] {tag}.{name}: requests={m.get('requests')} "
              f"rows={m.get('rows')} errors={m.get('errors')} "
              f"batches={m.get('batches')} "
              f"p50={fmt(lat.get('p50'))}ms p95={fmt(lat.get('p95'))}ms "
              f"p99={fmt(lat.get('p99'))}ms",
              file=sys.stderr, flush=True)
