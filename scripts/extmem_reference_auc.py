"""The JAX reference's criteo_extmem_40m row of BENCH_LADDER.json at fewer
pages, on the CPU.

Runs scripts/bench_ladder.py's own row function (bench_row_criteo_extmem:
page i of 655,360 Criteo-shaped rows from seed 7000 + i, max_bin 128,
binary:logistic, depth 8, eta 0.3, 5 rounds, AUC on the stride-8 sample)
at PAGES pages, with the host page cache at CACHE_MB (the ladder's 512 by
default) and without zstandard, as the ladder's recorded run had it (the
row reads the uncompressed pages' nbytes).  Prints the row's quality, its
page counters, and the AUC of the sampled rows below row 2**24 and from
it.

    python scripts/extmem_reference_auc.py [PAGES [CACHE_MB]]   # 8, 512
    python scripts/extmem_reference_auc.py --root-sums

The second form prints the reference's root hessian sum at 2**22, 2**24
and the row's 41,943,040 rows against the f64 sum.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

sys.modules["zstandard"] = None  # the ladder's container had none

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def root_sums() -> None:
    """The reference's root totals (ops/histogram.py node_sums, as
    init_tree_state takes them) of R rows of hessian 0.2499 against the f64
    sum: at 2**24 rows and past it the f32 sum stops at 2**22."""
    import jax.numpy as jnp

    from xgboost_tpu.ops.histogram import node_sums

    for R in (1 << 22, 1 << 24, 64 * 655_360):
        g = np.full((R, 2), 0.2499, np.float32)
        got = np.asarray(node_sums(jnp.asarray(g), jnp.zeros(R, jnp.int32),
                                   node0=0, n_nodes=1))[0, 1]
        print(f"  {R} rows: root hessian {got:.1f}, f64 sum "
              f"{g[:, 1].astype(np.float64).sum():.1f}")


def main() -> None:
    if sys.argv[1:] == ["--root-sums"]:
        root_sums()
        return
    pages = sys.argv[1] if len(sys.argv) > 1 else "8"
    cache = sys.argv[2] if len(sys.argv) > 2 else "512"
    os.environ["LADDER_CRITEO_PAGES"] = pages
    os.environ["XTB_EXTMEM_HOST_CACHE_MB"] = cache
    import bench_ladder

    seen = {}
    quality = bench_ladder.eval_quality

    def keep(metric, preds, y, groups):
        seen["preds"], seen["y"] = np.asarray(preds), np.asarray(y)
        return quality(metric, preds, y, groups)

    bench_ladder.eval_quality = keep
    row = bench_ladder.bench_row_criteo_extmem()
    print(f"reference criteo_extmem_40m row at {pages} pages, host cache "
          f"{cache} MB: AUC@stride8 {row['ours_quality']:.6f}; page "
          f"counters {row['extmem']}")
    # the stride-8 sample split at row 2**24 (sample 2**21)
    p, y = seen["preds"], seen["y"]
    cut = (1 << 24) // 8
    for name, sl in (("rows below 2**24", slice(0, cut)),
                     ("rows from 2**24", slice(cut, None))):
        if len(p[sl]) and 0 < y[sl].sum() < len(y[sl]):
            print(f"  {name}: {len(p[sl])} sampled, AUC "
                  f"{quality('auc', p[sl], y[sl], None):.6f}, "
                  f"{len(np.unique(p[sl]))} distinct predictions")


if __name__ == "__main__":
    main()
