"""Plotting: feature importance and tree diagrams (port of
xgboost_tpu/plotting.py; reference python-package/xgboost/plotting.py:
plot_importance, plot_tree, to_graphviz).

matplotlib and graphviz are imported when a function is called, never when
this module is imported.  ``to_graphviz`` returns the DOT text where
graphviz is absent.
"""
from __future__ import annotations

from io import BytesIO
from typing import Any, Optional

import numpy as np

from .core import Booster

__all__ = ["plot_importance", "plot_tree", "to_graphviz"]


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None, title: str = "Feature importance",
                    xlabel: str = "Importance score", ylabel: str = "Features",
                    fmap: str = "", importance_type: str = "weight",
                    max_num_features: Optional[int] = None, grid: bool = True,
                    show_values: bool = True, values_format: str = "{v}",
                    **kwargs: Any):
    """Horizontal bar plot of feature importance (reference:
    plotting.py:28)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plot_importance requires matplotlib") from e

    if hasattr(booster, "get_booster"):
        booster = booster.get_booster()
    if not isinstance(booster, Booster):
        raise ValueError("tree must be a Booster or XGBModel")
    importance = booster.get_score(fmap=fmap, importance_type=importance_type)
    if not importance:
        raise ValueError("Booster.get_score() results are empty")
    tuples = sorted(importance.items(), key=lambda x: x[1])
    if max_num_features is not None:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        _, ax = plt.subplots(1, 1)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    if show_values:
        for x, y in zip(values, ylocs):
            ax.text(x + 1e-6, y,
                    values_format.format(
                        v=round(x, 2) if isinstance(x, float) else x),
                    va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _attr_str(params: Optional[dict]) -> str:
    if not params:
        return ""
    return "".join(
        ', {}="{}"'.format(k, str(v).replace('"', r'\"'))
        for k, v in params.items()
    )


def to_graphviz(booster, fmap: str = "", num_trees: int = 0,
                rankdir: str = "UT",
                yes_color: str = "#0000FF", no_color: str = "#FF0000",
                condition_node_params: Optional[dict] = None,
                leaf_node_params: Optional[dict] = None, **kwargs: Any):
    """Graphviz Source of one tree (reference: plotting.py:118)."""
    if hasattr(booster, "get_booster"):
        booster = booster.get_booster()
    tree = booster.trees[num_trees]
    names = booster._fmap_names(fmap)  # get_dump's names

    def fname(fid):
        return names[fid] if names else f"f{fid}"

    cond_attrs = _attr_str(condition_node_params)
    leaf_attrs = _attr_str({"shape": "box", **(leaf_node_params or {})})
    graph_attrs = "".join(f'  {k}="{v}";\n' for k, v in kwargs.items())
    lines = [f"digraph tree_{num_trees} {{", f'  rankdir="{rankdir}";']
    if graph_attrs:
        lines.append(graph_attrs.rstrip("\n"))
    for nid in range(tree.n_nodes):
        if tree.is_leaf(nid):
            leaf = f"{tree.split_conditions[nid]:.6g}"
            lines.append(f'  n{nid} [label="leaf={leaf}"{leaf_attrs}];')
        else:
            if tree.categories and nid in tree.categories:
                cats = ",".join(str(c) for c in tree.categories[nid])
                cond = f"{fname(tree.split_indices[nid])}:{{{cats}}}"
            else:
                cond = (f"{fname(tree.split_indices[nid])}"
                        f"<{tree.split_conditions[nid]:.6g}")
            lines.append(f'  n{nid} [label="{cond}"{cond_attrs}];')
            yes, no = tree.left_children[nid], tree.right_children[nid]
            miss = yes if tree.default_left[nid] else no
            ylab = "yes, missing" if miss == yes else "yes"
            nlab = "no, missing" if miss == no else "no"
            lines.append(f'  n{nid} -> n{yes} [label="{ylab}", '
                         f'color="{yes_color}"];')
            lines.append(f'  n{nid} -> n{no} [label="{nlab}", '
                         f'color="{no_color}"];')
    lines.append("}")
    src = "\n".join(lines)
    try:
        from graphviz import Source

        return Source(src)
    except ImportError:
        return src  # raw DOT text when graphviz isn't installed


def plot_tree(booster, fmap: str = "", num_trees: int = 0, rankdir: str = "UT",
              ax=None, **kwargs: Any):
    """Render one tree with matplotlib (reference: plotting.py:186)."""
    try:
        import matplotlib.image as image
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plot_tree requires matplotlib") from e

    g = to_graphviz(booster, fmap=fmap, num_trees=num_trees, rankdir=rankdir,
                    **kwargs)
    if isinstance(g, str):
        raise ImportError("plot_tree requires graphviz")
    if ax is None:
        _, ax = plt.subplots(1, 1)
    s = BytesIO()
    s.write(g.pipe(format="png"))
    s.seek(0)
    img = image.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
