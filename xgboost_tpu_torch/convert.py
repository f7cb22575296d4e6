"""Carrying a model between xgboost_tpu and xgboost_tpu_torch.

Both packages persist the same reference JSON schema; the model dict of
``xgboost_tpu.Booster.save_raw_dict()`` holds Python and numpy values.
``booster_from_dict`` builds a port Booster from such a dict, and
``booster_to_dict`` gives the dict that ``xgboost_tpu.Booster().
load_model_dict`` accepts, so both packages predict from the same trees:
categorical splits (``split_type`` and the categories of each node) and
the training frame's categories (the ``cat_categories`` attribute)
included.
"""
from __future__ import annotations

import json

import numpy as np

from .core import Booster


def _plain(obj):
    """numpy scalars/arrays -> Python values (the dict as JSON would hold
    it)."""
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(f"not JSON-serialisable: {type(o)}")

    return json.loads(json.dumps(obj, default=default))


def booster_from_dict(model: dict, device=None) -> Booster:
    bst = Booster(device=device)
    bst.load_model_dict(_plain(model))
    return bst


def booster_to_dict(bst: Booster) -> dict:
    return _plain(bst.save_raw_dict())
