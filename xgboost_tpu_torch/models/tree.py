"""RegTree: the persisted tree model, struct-of-arrays (port of the scalar,
numeric part of xgboost_tpu/models/tree.py).

Arrays are numpy columns in the reference's JSON field layout
(left_children, right_children, parents, split_indices, split_conditions,
default_left, base_weights, loss_changes, sum_hessian), so ``to_json_dict``
emits the schema the reference reads.  Node numbering is creation order
(root 0, children appended in level order), matching the depthwise updater.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class RegTree:
    left_children: np.ndarray  # (n,) int32, -1 for leaf
    right_children: np.ndarray
    parents: np.ndarray
    split_indices: np.ndarray  # int32 feature, 0 for leaf
    split_conditions: np.ndarray  # f32 threshold; LEAF VALUE for leaves
    default_left: np.ndarray  # bool
    base_weights: np.ndarray  # f32
    loss_changes: np.ndarray  # f32
    sum_hessian: np.ndarray  # f32

    @property
    def n_nodes(self) -> int:
        return len(self.left_children)

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(1, self.n_nodes):
            depth[i] = depth[self.parents[i]] + 1
        return int(depth.max()) if self.n_nodes else 0

    @staticmethod
    def from_grown(gt) -> "RegTree":
        """Compact a tree/grow.py GrownTree (heap arrays) into creation
        order."""
        id_of = {0: 0}
        order: List[int] = []
        queue = [0]
        while queue:
            h = queue.pop(0)
            order.append(h)
            if gt.feat[h] >= 0 and not gt.is_leaf[h]:
                for c in (2 * h + 1, 2 * h + 2):
                    id_of[c] = len(order) + len(queue)
                    queue.append(c)
        n = len(order)
        t = RegTree(
            left_children=np.full(n, -1, np.int32),
            right_children=np.full(n, -1, np.int32),
            parents=np.full(n, -1, np.int32),
            split_indices=np.zeros(n, np.int32),
            split_conditions=np.zeros(n, np.float32),
            default_left=np.zeros(n, bool),
            base_weights=np.zeros(n, np.float32),
            loss_changes=np.zeros(n, np.float32),
            sum_hessian=np.zeros(n, np.float32),
        )
        for h in order:
            i = id_of[h]
            t.base_weights[i] = gt.base_weight[h]
            t.sum_hessian[i] = gt.sum_hess[h]
            t.default_left[i] = gt.dleft[h]
            if gt.feat[h] >= 0 and not gt.is_leaf[h]:
                t.left_children[i] = id_of[2 * h + 1]
                t.right_children[i] = id_of[2 * h + 2]
                t.parents[id_of[2 * h + 1]] = i
                t.parents[id_of[2 * h + 2]] = i
                t.split_indices[i] = gt.feat[h]
                t.split_conditions[i] = gt.thr[h]
                t.loss_changes[i] = gt.gain[h]
            else:
                t.split_conditions[i] = gt.leaf_val[h]
        return t

    def padded_arrays(self, width: int) -> dict:
        """Node arrays padded to ``width`` for the stacked predictor."""
        n = self.n_nodes
        leaf = self.left_children == -1

        def pad(a, fill=0):
            out = np.full(width, fill, dtype=a.dtype)
            out[:n] = a
            return out

        return dict(
            feat=pad(np.where(leaf, -1, self.split_indices).astype(np.int32), -1),
            thr=pad(np.where(leaf, np.float32(0), self.split_conditions)),
            dleft=pad(self.default_left.astype(np.bool_)),
            left=pad(self.left_children, -1),
            right=pad(self.right_children, -1),
            value=pad(np.where(leaf, self.split_conditions, 0.0).astype(np.float32)),
        )

    # ---- xgboost JSON schema (tree_model.cc SaveModel) ----
    def to_json_dict(self, n_features: int, tree_id: int = 0) -> dict:
        n = self.n_nodes
        return {
            "id": int(tree_id),
            "tree_param": {
                "num_nodes": str(n),
                "num_feature": str(n_features),
                "size_leaf_vector": "1",
            },
            "left_children": self.left_children.tolist(),
            "right_children": self.right_children.tolist(),
            "parents": self.parents.tolist(),
            "split_indices": self.split_indices.tolist(),
            "split_conditions": [float(x) for x in self.split_conditions],
            "split_type": [0] * n,
            "default_left": self.default_left.astype(np.int32).tolist(),
            "categories": [],
            "categories_nodes": [],
            "categories_segments": [],
            "categories_sizes": [],
            "base_weights": [float(x) for x in self.base_weights],
            "loss_changes": [float(x) for x in self.loss_changes],
            "sum_hessian": [float(x) for x in self.sum_hessian],
        }

    @staticmethod
    def from_json_dict(d: dict) -> "RegTree":
        if d.get("categories_nodes") or any(d.get("split_type", [])):
            raise NotImplementedError(
                "categorical trees are not supported by xgboost_tpu_torch yet")
        if int(d.get("tree_param", {}).get("size_leaf_vector", "1") or 1) > 1:
            raise NotImplementedError(
                "vector-leaf trees are not supported by xgboost_tpu_torch yet")
        n = len(d["left_children"])
        return RegTree(
            left_children=np.asarray(d["left_children"], np.int32),
            right_children=np.asarray(d["right_children"], np.int32),
            parents=np.asarray(d["parents"], np.int32),
            split_indices=np.asarray(d["split_indices"], np.int32),
            split_conditions=np.asarray(d["split_conditions"], np.float32),
            default_left=np.asarray(d["default_left"]).astype(bool),
            base_weights=np.asarray(d.get("base_weights", np.zeros(n)), np.float32),
            loss_changes=np.asarray(d.get("loss_changes", np.zeros(n)), np.float32),
            sum_hessian=np.asarray(d.get("sum_hessian", np.zeros(n)), np.float32),
        )
