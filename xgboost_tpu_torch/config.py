"""Global configuration (port of xgboost_tpu/config.py; reference
python-package/xgboost/config.py, include/xgboost/global_config.h:16-35):
thread-local ``{verbosity, use_rmm, nthread}``."""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    "verbosity": 1,
    "use_rmm": False,  # accepted as the reference accepts it; read by nothing
    "nthread": None,
}

_local = threading.local()


def _store() -> Dict[str, Any]:
    if not hasattr(_local, "config"):
        _local.config = dict(_DEFAULTS)
    return _local.config


def set_config(**new_config: Any) -> None:
    store = _store()
    for k, v in new_config.items():
        if k not in _DEFAULTS:
            raise ValueError(f"Unknown global config key: {k}")
        store[k] = v


def get_config() -> Dict[str, Any]:
    return dict(_store())


@contextlib.contextmanager
def config_context(**new_config: Any):
    old = get_config()
    set_config(**new_config)
    try:
        yield
    finally:
        _store().update(old)
