"""The reference's own f32 histogram error at a node-tiled level.

    JAX_PLATFORMS=cpu python3 scripts/node_tiled_error.py [--out FILE]

The input is phase 2f's node-tiled case (chip_smoke.py:node_tiled_level:
Covertype-shaped, 581,012 x 54, 256 bins, 7 classes, the level (127, 64,
2) with 90% of each class's rows in its first node).  For each class,
xgboost_tpu's f32 histogram on the CPU (ops/histogram.py:build_histogram,
the implementation the reference's grower takes there) and the port's
plain version (xgboost_tpu_torch/ops/histogram.py) against an f64 sum of
the same rows.  Prints the largest cell error of each and the largest
cell; chip_smoke.py phase 2f prints K1's and its class axis's error on
the card at the same input, against the same f64 sum.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xgboost_tpu.ops import histogram as ref_hist  # noqa: E402
from xgboost_tpu_torch.ops import histogram as port_hist  # noqa: E402


def f64_hist(bins, g, pos, node0, n_nodes, n_bin, stride):
    R, F = bins.shape
    local = pos.astype(np.int64) - node0
    ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = ok[:, None] & (bins < n_bin)
    idx = ((local // stride)[:, None] * F + np.arange(F)[None]) * n_bin \
        + bins.astype(np.int64)
    out = torch.zeros((n_nodes * F * n_bin, 2), dtype=torch.float64)
    vals = torch.from_numpy(g.astype(np.float64))[:, None, :].expand(R, F, 2)
    t = torch.from_numpy(take)
    out.index_add_(0, torch.from_numpy(idx)[t], vals[t])
    return out.reshape(n_nodes, F, n_bin, 2).numpy()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bins, gpair, pos = cs.node_tiled_level()
    node0, n_nodes, stride = cs.NODE_TILED
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    rows = []
    for k in range(gpair.shape[1]):
        g = np.ascontiguousarray(gpair[:, k])
        want = f64_hist(bins, g, pos[k], **kw)
        ref = np.asarray(ref_hist.build_histogram(
            jnp.asarray(bins), jnp.asarray(g), jnp.asarray(pos[k]), **kw))
        port = port_hist.build_histogram(
            torch.from_numpy(bins), torch.from_numpy(g),
            torch.from_numpy(pos[k]), **kw).numpy()
        row = dict(cls=k, reference_max_abs_err=float(np.abs(ref - want)
                                                      .max()),
                   port_plain_max_abs_err=float(np.abs(port - want).max()),
                   max_cell=float(np.abs(want).max()))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(
        level=list(cs.NODE_TILED),
        reference_impl=ref_hist._host_impl(),
        reference_max_abs_err=max(r["reference_max_abs_err"] for r in rows),
        port_plain_max_abs_err=max(r["port_plain_max_abs_err"]
                                   for r in rows),
        max_cell=max(r["max_cell"] for r in rows))
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(classes=rows, summary=summary), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
