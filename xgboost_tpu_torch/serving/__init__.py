"""xgboost_tpu_torch.serving: batched, multi-model inference on the card
(port of xgboost_tpu/serving/, its engine half).

- :class:`ServingEngine`: a CUDA graph captured per (model, row bucket,
  output kind) and replayed, dynamic micro-batching, per-model metrics
  with latency quantiles.
- :class:`ServeConfig`: SLO knobs (max_batch, max_delay_us, residency cap,
  warm-up buckets, deadline, queue bound, device).
- :class:`ModelRegistry`: versioned LRU model residency with pinning.
- :class:`InferenceSnapshot`: immutable device-resident view of a trained
  Booster (``Booster.inference_snapshot()``).
- :class:`MicroBatcher` / :class:`ServingMetrics`: the coalescing and
  observability building blocks, usable alone.

Quick start::

    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.serving import ServingEngine

    eng = ServingEngine(max_delay_us=1000)
    eng.add_model("ctr", booster)           # or a .json/.ubj path
    probs = eng.predict("ctr", rows)        # N threads may call this
    print(eng.metrics_snapshot()["models"]["ctr"]["latency_ms"])

The reference's fleet, replicas, wire protocol, model store and warm
program cache are not ported yet (ROADMAP Queue 1 item 10).
"""
from .batcher import MicroBatcher, QueueFullError, WorkerDiedError
from .engine import ServeConfig, ServingEngine
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .snapshot import InferenceSnapshot

__all__ = [
    "ServingEngine",
    "ServeConfig",
    "ModelRegistry",
    "InferenceSnapshot",
    "MicroBatcher",
    "ServingMetrics",
    "WorkerDiedError",
    "QueueFullError",
]
