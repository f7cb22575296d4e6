"""Frozen inference snapshot of a trained Booster (port of
xgboost_tpu/serving/snapshot.py).

Everything prediction needs (the stacked padded tree tensors, the output
group of each tree, the base score and the objective's transform) is copied
out of the live Booster onto its device, so serving never races later
training or attribute writes and never touches a DMatrix cache.  The
stacked layout is the structure-of-arrays form of arXiv:1603.02754 §4
applied to inference: one (T, M) tensor per node field, resident for the
model's lifetime in the registry.  The serving engine's per-snapshot
program (its captured CUDA graphs on the card) rides on the snapshot as
``_serve_prog`` and dies with it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.predict import bucket_rows, pad_margin, pad_rows, run_stacked_margin
from ..utils.device import resolve_device


class InferenceSnapshot:
    """Immutable view of one model version, on one device."""

    def __init__(self, *, stacked, groups, depth: int, n_groups: int,
                 base_score: np.ndarray, objective, num_features: int,
                 device: torch.device, feature_names=None,
                 cat_categories=None, n_trees: int = 0) -> None:
        self.stacked = stacked          # dict of device tensors, or None
        self.groups = groups            # output group of each tree
        self.depth = depth
        self.n_groups = n_groups
        self.base_score = np.asarray(base_score, np.float32).reshape(-1)
        self.objective = objective
        self.num_features = num_features
        self.device = device
        self.feature_names = list(feature_names) if feature_names else None
        self.cat_categories = cat_categories  # train-time {feat -> values}
        self.n_trees = n_trees

    @classmethod
    def from_booster(cls, booster, device=None) -> "InferenceSnapshot":
        """Snapshot ``booster`` onto ``device`` (None: the booster's own).
        DART's tree weights are folded into the leaf values, and the base
        score is broadcast to the output groups."""
        booster._configure()
        if booster.booster_kind == "gblinear":
            raise NotImplementedError(
                "serving snapshots cover tree boosters (gbtree/dart); "
                "gblinear is a single matmul — serve it directly")
        dev = booster.device if device is None else resolve_device(device)
        n_trees = len(booster.trees)
        if n_trees:
            # fresh tensors from the trees' host arrays: later training,
            # which appends or rewrites trees, cannot reach them
            stacked, groups, depth = booster._stacked(slice(0, n_trees))
            stacked = {k: v.to(dev) for k, v in stacked.items()}
            groups = list(groups)
        else:
            stacked, groups, depth = None, None, 0
        base = np.broadcast_to(
            np.asarray(booster.base_score, np.float32).reshape(-1),
            (booster.n_groups,)).copy()
        return cls(
            stacked=stacked, groups=groups, depth=depth,
            n_groups=booster.n_groups, base_score=base,
            objective=booster.objective,
            num_features=booster.num_features(), device=dev,
            feature_names=booster.feature_names,
            cat_categories=booster._cat_categories, n_trees=n_trees)

    # -------------------------------------------------------------- predict
    def margin_padded(self, X, init=None):
        """Raw ensemble margin (B, K) of a bucket-padded (B, F) batch on the
        snapshot's device, through ``run_stacked_margin`` as
        ``Booster.predict`` goes, so both give the same bits."""
        if self.stacked is None:
            base = torch.zeros((X.shape[0], self.n_groups),
                               dtype=torch.float32, device=X.device)
            return base if init is None else base + init
        return run_stacked_margin(X, self.stacked, self.groups, self.depth,
                                  self.n_groups, init)

    def margin(self, X, init=None):
        """Bucket-pad, predict, slice: the direct (non-engine) entry."""
        R = X.shape[0]
        bucket = bucket_rows(R)
        out = self.margin_padded(pad_rows(X, bucket), pad_margin(init, bucket))
        return out if bucket == R else out[:R]

    def transform(self, margin):
        return self.objective.pred_transform(margin)

    @property
    def nbytes(self) -> int:
        if self.stacked is None:
            return 0
        return int(sum(v.numel() * v.element_size()
                       for v in self.stacked.values()))

    def host_dense_recoded(self, dmat) -> np.ndarray:
        """DMatrix -> dense rows with categorical codes remapped onto the
        training frame's categories (the Recode step ``Booster.predict``
        applies): a frame whose category order differs from training's
        must not mis-route codes."""
        from ..data.dmatrix import recode_dense

        return recode_dense(dmat.host_dense(), self.cat_categories,
                            dmat.cat_categories)

    def get_categories(self) -> Optional[dict]:
        """Train-time category values keyed by feature name (or index)."""
        from ..data.dmatrix import categories_by_name

        return categories_by_name(self.cat_categories, self.feature_names)
