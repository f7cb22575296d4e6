"""RegTree: the persisted tree model, struct-of-arrays (port of the scalar
part of xgboost_tpu/models/tree.py, categorical splits included).

Arrays are numpy columns in the reference's JSON field layout
(left_children, right_children, parents, split_indices, split_conditions,
default_left, base_weights, loss_changes, sum_hessian, split_type and the
categories of each categorical split), so ``to_json_dict`` emits the
schema the reference reads.  Node numbering is creation order (root 0,
children appended in level order), matching the depthwise updater.  A
categorical node sends the categories of its set right, every other
category left (common/categorical.h Decision).

A vector-leaf tree (``multi_strategy="multi_output_tree"``, K targets)
carries ``leaf_vector`` and ``base_weight_vec`` (n, K) and writes the
reference's vector-leaf schema (multi_target_tree_model.cc SaveModel):
``size_leaf_vector`` K, ``base_weights`` n x K row-major, ``leaf_weights``
n_leaves x K, each leaf's index into them in its ``right_children`` slot;
its leaves' ``split_conditions`` are 0.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

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
    split_type: Optional[np.ndarray] = None  # int32: 0 numeric, 1 categorical
    categories: Optional[dict] = None  # node -> int32 categories routed right
    # vector leaves: (n, K) leaf values and node weights; None when scalar
    leaf_vector: Optional[np.ndarray] = None
    base_weight_vec: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return len(self.left_children)

    @property
    def n_targets(self) -> int:
        return 1 if self.leaf_vector is None else self.leaf_vector.shape[1]

    def is_leaf(self, nid: int) -> bool:
        return self.left_children[nid] == -1

    @property
    def has_categorical(self) -> bool:
        return bool(self.categories)

    @property
    def max_category(self) -> int:
        """The largest category any split names, -1 without any."""
        if not self.categories:
            return -1
        return max((int(c.max()) for c in self.categories.values() if len(c)),
                   default=-1)

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(1, self.n_nodes):
            depth[i] = depth[self.parents[i]] + 1
        return int(depth.max()) if self.n_nodes else 0

    @staticmethod
    def _creation_order(gt):
        """The heap ids of a grown tree's nodes in creation order, and each
        one's creation id."""
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
        return order, id_of

    @staticmethod
    def from_grown(gt) -> "RegTree":
        """Compact a tree/grow.py GrownTree (heap arrays) into creation
        order."""
        order, id_of = RegTree._creation_order(gt)
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
            split_type=np.zeros(n, np.int32),
            categories={},
        )
        has_cat = getattr(gt, "is_cat", None) is not None
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
                if has_cat and gt.is_cat[h]:
                    t.split_type[i] = 1
                    t.categories[i] = np.nonzero(gt.cat_set[h])[0].astype(
                        np.int32)
            else:
                t.split_conditions[i] = gt.leaf_val[h]
        return t

    @staticmethod
    def from_grown_multi(gt) -> "RegTree":
        """Compact a tree/grow_multi.py GrownMultiTree (heap arrays, K-wide
        values) into creation order (reference models/tree.py:123-171)."""
        order, id_of = RegTree._creation_order(gt)
        n, K = len(order), gt.leaf_val.shape[1]
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
            split_type=np.zeros(n, np.int32),
            categories={},
            leaf_vector=np.zeros((n, K), np.float32),
            base_weight_vec=np.zeros((n, K), np.float32),
        )
        for h in order:
            i = id_of[h]
            t.base_weight_vec[i] = gt.base_weight[h]
            t.base_weights[i] = gt.base_weight[h][0]
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
                t.leaf_vector[i] = gt.leaf_val[h]
        # a leaf's right_children slot holds its index into leaf_weights
        # (multi_target_tree_model.cc SetLeaves)
        leaves = t.left_children == -1
        t.right_children[leaves] = np.arange(int(leaves.sum()), dtype=np.int32)
        return t

    def padded_arrays(self, width: int) -> dict:
        """Node arrays padded to ``width`` for the stacked predictor;
        ``is_cat`` marks the categorical splits."""
        n = self.n_nodes
        leaf = self.left_children == -1
        st = (self.split_type if self.split_type is not None
              else np.zeros(n, np.int32))

        def pad(a, fill=0):
            out = np.full(width, fill, dtype=a.dtype)
            out[:n] = a
            return out

        out = dict(
            feat=pad(np.where(leaf, -1, self.split_indices).astype(np.int32), -1),
            thr=pad(np.where(leaf, np.float32(0), self.split_conditions)),
            dleft=pad(self.default_left.astype(np.bool_)),
            left=pad(self.left_children, -1),
            right=pad(self.right_children, -1),
            value=pad(np.where(leaf, self.split_conditions, 0.0).astype(np.float32)),
            is_cat=pad(st == 1),
        )
        if self.leaf_vector is not None:  # (width, K) leaf vectors
            vv = np.zeros((width, self.n_targets), np.float32)
            vv[:n] = self.leaf_vector
            out["value_vec"] = vv
        return out

    def cat_matrix(self, width: int, n_cats: int) -> np.ndarray:
        """(width, n_cats) bool: the categories each node routes right."""
        out = np.zeros((width, max(n_cats, 1)), dtype=bool)
        for nid, cats in (self.categories or {}).items():
            out[nid, cats[cats < n_cats]] = True
        return out

    # ---- xgboost JSON schema (tree_model.cc SaveModel) ----
    def to_json_dict(self, n_features: int, tree_id: int = 0) -> dict:
        n = self.n_nodes
        st = (self.split_type if self.split_type is not None
              else np.zeros(n, np.int32))
        cat_nodes, cat_segs, cat_sizes, cat_flat = [], [], [], []
        for nid in sorted(self.categories or {}):
            cats = self.categories[nid]
            cat_nodes.append(int(nid))
            cat_segs.append(len(cat_flat))
            cat_sizes.append(len(cats))
            cat_flat.extend(int(c) for c in cats)
        out = {
            "id": int(tree_id),
            "tree_param": {
                "num_nodes": str(n),
                "num_feature": str(n_features),
                "size_leaf_vector": str(self.n_targets),
            },
            "left_children": self.left_children.tolist(),
            "right_children": self.right_children.tolist(),
            "parents": self.parents.tolist(),
            "split_indices": self.split_indices.tolist(),
            "split_conditions": [float(x) for x in self.split_conditions],
            "split_type": st.tolist(),
            "default_left": self.default_left.astype(np.int32).tolist(),
            "categories": cat_flat,
            "categories_nodes": cat_nodes,
            "categories_segments": cat_segs,
            "categories_sizes": cat_sizes,
            "base_weights": [float(x) for x in self.base_weights],
            "loss_changes": [float(x) for x in self.loss_changes],
            "sum_hessian": [float(x) for x in self.sum_hessian],
        }
        if self.leaf_vector is not None:
            out["base_weights"] = [float(x)
                                   for x in self.base_weight_vec.reshape(-1)]
            leaf_ids = np.nonzero(self.left_children == -1)[0]
            lw = np.zeros((len(leaf_ids), self.n_targets), np.float32)
            lw[self.right_children[leaf_ids]] = self.leaf_vector[leaf_ids]
            out["leaf_weights"] = [float(x) for x in lw.reshape(-1)]
        return out

    @staticmethod
    def from_json_dict(d: dict) -> "RegTree":
        cats = {}
        flat = d.get("categories", [])
        for nid, seg, size in zip(d.get("categories_nodes", []),
                                  d.get("categories_segments", []),
                                  d.get("categories_sizes", [])):
            cats[int(nid)] = np.asarray(flat[seg: seg + size], np.int32)
        n = len(d["left_children"])
        K = int(d.get("tree_param", {}).get("size_leaf_vector", "1") or 1)
        base_weights = np.asarray(d.get("base_weights", np.zeros(n)),
                                  np.float32)
        leaf_vector = base_weight_vec = None
        if K > 1:  # the vector-leaf schema (reference models/tree.py:287)
            base_weight_vec = base_weights.reshape(n, K)
            base_weights = base_weight_vec[:, 0]
            leaf_ids = np.nonzero(np.asarray(d["left_children"]) == -1)[0]
            lw = np.asarray(d.get("leaf_weights", []), np.float32).reshape(
                len(leaf_ids), K)
            leaf_vector = np.zeros((n, K), np.float32)
            # right_children holds each leaf's index into leaf_weights
            leaf_vector[leaf_ids] = lw[np.asarray(
                d["right_children"], np.int64)[leaf_ids]]
        return RegTree(
            leaf_vector=leaf_vector, base_weight_vec=base_weight_vec,
            left_children=np.asarray(d["left_children"], np.int32),
            right_children=np.asarray(d["right_children"], np.int32),
            parents=np.asarray(d["parents"], np.int32),
            split_indices=np.asarray(d["split_indices"], np.int32),
            split_conditions=np.asarray(d["split_conditions"], np.float32),
            default_left=np.asarray(d["default_left"]).astype(bool),
            base_weights=base_weights,
            loss_changes=np.asarray(d.get("loss_changes", np.zeros(n)), np.float32),
            sum_hessian=np.asarray(d.get("sum_hessian", np.zeros(n)), np.float32),
            split_type=np.asarray(d.get("split_type", np.zeros(n))).astype(
                np.int32),
            categories=cats or None,
        )

    # ---- dumps (tree_model.cc DumpModel) ----
    def _missing(self, nid: int) -> int:
        return int(self.left_children[nid] if self.default_left[nid]
                   else self.right_children[nid])

    def dump_text(self, feature_names: Optional[List[str]] = None,
                  with_stats: bool = False) -> str:
        """The text dump: ``[f<c]`` for a numeric split, ``[f:{cats}]``
        for a categorical one (its categories go right, "no")."""
        lines: List[str] = []

        def fname(fid: int) -> str:
            return feature_names[fid] if feature_names else f"f{fid}"

        def rec(nid: int, depth: int):
            indent = "\t" * depth
            if self.is_leaf(nid):
                s = f"{indent}{nid}:leaf={self.split_conditions[nid]:.6g}"
                if with_stats:
                    s += f",cover={self.sum_hessian[nid]:.6g}"
            elif self.categories and nid in self.categories:
                cats = ",".join(str(c) for c in self.categories[nid])
                s = (f"{indent}{nid}:[{fname(self.split_indices[nid])}:"
                     f"{{{cats}}}] yes={self.left_children[nid]},"
                     f"no={self.right_children[nid]},"
                     f"missing={self._missing(nid)}")
            else:
                s = (f"{indent}{nid}:[{fname(self.split_indices[nid])}<"
                     f"{self.split_conditions[nid]:.6g}] "
                     f"yes={self.left_children[nid]},"
                     f"no={self.right_children[nid]},"
                     f"missing={self._missing(nid)}")
                if with_stats:
                    s += (f",gain={self.loss_changes[nid]:.6g},"
                          f"cover={self.sum_hessian[nid]:.6g}")
            lines.append(s)
            if not self.is_leaf(nid):
                rec(self.left_children[nid], depth + 1)
                rec(self.right_children[nid], depth + 1)

        rec(0, 0)
        return "\n".join(lines) + "\n"

    def dump_json(self, feature_names: Optional[List[str]] = None,
                  with_stats: bool = False) -> str:
        """The JSON dump (tree_model.cc JsonGenerator): nested nodeid /
        split / children objects; a categorical split's condition is its
        list of categories."""
        def fname(fid: int) -> str:
            return feature_names[fid] if feature_names else f"f{fid}"

        def rec(nid: int, depth: int) -> dict:
            if self.is_leaf(nid):
                d = {"nodeid": int(nid),
                     "leaf": float(self.split_conditions[nid])}
                if with_stats:
                    d["cover"] = float(self.sum_hessian[nid])
                return d
            yes = int(self.left_children[nid])
            no = int(self.right_children[nid])
            d = {"nodeid": int(nid), "depth": int(depth),
                 "split": fname(int(self.split_indices[nid]))}
            if self.categories and nid in self.categories:
                d["split_condition"] = [int(c) for c in self.categories[nid]]
            else:
                d["split_condition"] = float(self.split_conditions[nid])
            d.update(yes=yes, no=no, missing=self._missing(nid))
            if with_stats:
                d.update(gain=float(self.loss_changes[nid]),
                         cover=float(self.sum_hessian[nid]))
            d["children"] = [rec(yes, depth + 1), rec(no, depth + 1)]
            return d

        return json.dumps(rec(0, 0))
