"""Smoke run of xgboost_tpu_torch on one NVIDIA GPU.

Drives the port's training paths through its public entry points and
holds each CUDA kernel against its plain PyTorch version:

  1. device: card name and power limit; build every kernel library (one
     nvcc per source, all at once) and load it; K6's (csrc/treeshap.cu,
     minutes where the others take seconds) finishes in a thread while
     phases 2-17 run, and is loaded before phase 18
  2. K1 vs plain: the f32 histogram kernel (csrc/hist.cu) against
     build_histogram_plain at R=1,048,576 x F=28, B=256, int16 and uint8
     bins, within 1e-5 of the largest cell, at the six levels a depth-6
     round builds and a 16-node span (15, 16, 2) kept from earlier runs,
     with timings of the kernel, the plain version, one index_add_ call (a
     yardstick the port never calls) and the memory bound, K1's launch plan
     (features and nodes per block, row blocks, cluster size, threads, row
     loop) and the sum over the six levels; plus a 128-node level whose
     nodes are tiled
     and the best-first grower's launch (101, 2, 1), two consecutive nodes
     holding 2% of the rows
  2b. K2 vs plain: the exact limb histogram kernel (csrc/hist_q.cu) against
     build_histogram_q_plain at the same shapes, bitwise, with K2's launch
     plan (the same fields as K1's) and its six-level sum; plus an
     adversarial input at R=1,048,576, every row in bin 0 of every feature
     with the same extreme limbs (-128, then 127), at the root, the first
     level and 16 nodes
  2c. K3 vs plain: the split scan kernel (csrc/split_scan.cu) against
     split_scan_plain, bitwise, at the six level shapes of a depth-6 round
     (N = 1 to 32 nodes x 28 features x 256 bins) and the best-first
     grower's N = 2, unconstrained and monotone, with ties, nodes without
     a candidate, a dead slot and masked features; timings of the kernel
     (per call with the host's launch, batched, and its device time per
     launch from torch.profiler), the plain version, the cumsum
     formulation it replaced (the port's scan before it) and the bound
  2e. K3's categorical mode vs plain: the split scan with a categorical
     mask (every feature in the reference's XLA formulation; categorical
     bins stably sorted by G/H; one-hot below max_cat_to_onehot; cat_set)
     against split_scan_plain, bitwise in all seven outputs, at the levels
     of a depth-8 round (N = 1 to 64 nodes x 39 features x 128 bins, 26
     categorical features of 100 categories with empty categories and ties
     in G/H), max_cat_to_onehot 4 (partition) and 128 (one-hot), from the
     histogram and from its limb form (deterministic_histogram); timings
     of the kernel (per call, batched, device time per launch) and the
     plain version, and the bound
  2d. K4 vs plain: the sigmoid entry (csrc/sigmoid.cu) against
     sigmoid_f32 (XLA's f32 logistic as PyTorch operations), bitwise, on
     the main path's 1,000,448 margins with the f32 range's edges mixed in;
     timings of the kernel (per call, batched, device time per launch),
     the plain version, torch.sigmoid (a yardstick the port never calls)
     and the bound; then the gradient entry against
     logistic_gradient_plain, bitwise, on the same margins with and
     without weights and scale_pos_weight, timed as the sigmoid and beside
     the port's gradient before it (K4's sigmoid and nine PyTorch ops)
  3. train: 1,000,000 x 28 HIGGS-shaped rows, binary:logistic, max_bin=256,
     max_depth=6, eta=0.3, 10 rounds, evaluated on the training set; K1
     and K3 launch 6 times per round and K2 never, K4 once for the base
     score and once per round (and once more per round for the evaluation)
  3b. profile: device time by kernel over two training rounds and the
     card's idle share; every operation one get_gradient call puts on the
     stream at the main path's rows, read from a CUDA graph captured from
     the call: one launch of K4's gradient entry
  3c. the same training with deterministic_histogram=1: K2 and K3 launch 6
     times per round and K1 never, and two runs write byte-identical models
  3d. profile of 3c
  4. predict 100k rows, save JSON and UBJ, reload, predict identically
  5. small-input parity: the same small training on the card and on the CPU
     (whose histograms are the plain versions the tests hold against the
     JAX reference) must grow the same trees
  5b. phase 5 under deterministic_histogram=1, alone, with monotone and
     interaction constraints, column sampling and max_leaves, and with
     subsample=0.8: the card's model JSON must be byte-identical to the
     CPU's; the constrained model at full width must not decrease along
     feature 0
  6. lossguide at full width: the phase 3 data with grow_policy=lossguide,
     max_depth=0, max_leaves=255, subsample=0.8, colsample_bynode=0.8, 10
     rounds; AUC > 0.9, K1 and K3 launched once per tree and once per
     expansion, K4 as in phase 3; the train loop's median of 3 runs and
     expansions per second
  6b. lossguide (max_leaves=31) card vs CPU at 20,000 rows with
     feature_weights, under uniform and gradient_based sampling: the same
     trees, predictions within 1e-4, and the card's uniform row masks
     equal to the CPU's bitwise

  7. the categorical slice at full width, Criteo-shaped
     (scripts/bench_ladder.py:616-631, numpy only): 1,048,576 rows, 13
     numeric columns with 20% NaN and 26 categorical columns of up to 100
     codes, binary:logistic, max_depth=8, max_bin=128 (uint8 bins), eta=0.3,
     10 rounds, on the f32 path and under deterministic_histogram=1: ingest
     seconds, K1/K2 and K3 launched 8 times a round, K4 as in phase 3,
     categorical splits > 0, training-set AUC > 0.90, the train loop's
     median of 3 runs, a two-round profile of each, the bound of one
     round's histograms on this data (each launch's rows counted in one
     more round); the card's model JSON
     reloads and predicts identically, and two deterministic runs write
     byte-identical JSON
  7b. card vs CPU on 20,000 rows of the same generator at depth 8: under
     deterministic_histogram=1 the model JSON byte-identical with
     max_cat_to_onehot 4 and 128 and with a monotone numeric feature; the
     f32 path at depth 4 (as phase 5; deeper, f32 sums in another order
     grow other trees on the CPU too) and lossguide (max_leaves=31) growing
     the same trees (category sets included), predictions within 1e-4

  8. multiclass at full width, Covertype-shaped (scripts/bench_ladder.py:
     88-90, 106-135, numpy only): 581,012 x 54 (2% NaN), 7 classes,
     multi:softprob, max_depth=8, max_bin=256, eta=0.3, 5 rounds, on both
     histogram paths: ingest seconds, the train loop's median of 3 (M
     row-rounds/s and per tree), K1/K2 and K3 launched 7 x 8 = 56 times a
     round, merror < 0.30, two deterministic runs byte-identical, a
     two-round profile of each; the (R, 7) probabilities sum to 1 within
     1e-6 and the JSON and UBJ reload to the same predictions
  8b. card vs CPU on 20,000 rows of the same generator at depth 6: the
     deterministic model JSON byte-identical, plain and with subsample,
     colsample_bynode and weights; the f32 path at depth 4 the same trees;
     the kernels and time of one multiclass get_gradient at full width
  9. a random forest as XGBoost's tutorial sets it (num_parallel_tree=100,
     subsample=0.8, colsample_bynode=0.8, eta=1, max_depth=5, one round)
     on phase 3's matrix: 100 trees, K1 and K3 launched 500 times, the AUC
     of the margins > 0.9 and above its first tree's alone (the f32
     probabilities of a 100-tree sum at full eta round to 0 or 1 on many
     rows, so their AUC is printed beside it), trees/s; 9b: num_parallel_tree=4 card vs CPU at 20,000 rows,
     byte-identical deterministic JSON
  10. the training API on the card at phase 3's matrix under
     deterministic_histogram=1: 5 + 5 rounds through xgb_model (the
     Booster, saved UBJ) byte-identical to 10 with subsample=0.8; a custom
     squared-error objective and boost() byte-identical to
     reg:squarederror; save_raw('ubj') round trip; pred_leaf (R, T) int32
     whose leaves sum (tree order, from zero, then the base margin) to
     predict's margins bit for bit; a custom metric in the log
  11. CSR at full width: phase 3's rows beside 228 columns stored at
     density 0.02 (256 features, about 33 stored entries a row),
     binary:logistic, depth 6, max_bin 256, 10 rounds: the host sketch and
     the bins timed apart, the bins' bytes, the train loop's median of 3,
     K1 and K3 launched 6 times a round, AUC > 0.9; 11b: card vs CPU at
     20,000 rows, byte-identical deterministic JSON

  2f. K1's class axis (xtb_hist_f32_multi of csrc/hist_multi.cu; ptxas's
     registers and spills printed) against its plain versions within 1e-5
     of the largest cell: the lockstep layout at Covertype's shapes
     (581,012 x 54, 256 bins, 7 classes, a pos per class) and the
     vector-leaf layout at HIGGS shapes (1,048,576 x 28, 3 targets, one
     pos), at the root, (31, 16, 2) and the node-tiled (255, 128, 2), and
     against an f64 sum at (15, 8, 2) with 97% of the rows in one node, as
     a training's middle levels hold them, and at (127, 64, 2) with 90%,
     erring at most 1.5x K1's own launches there; each case's plan;
     timings of the kernel (per call, batched, device time a call), K
     separate K1 launches, the plain version, one index_add_ over the K
     classes (a yardstick the port never calls) and the bound
  12. _lockstep=1 at full width on phase 8's data and parameters: the
     class axis and K3 launched 8 times a round, single-class K1 never,
     merror < 0.30, the trees phase 8's sequential f32 trees or a first
     difference at a near tie (8b's rule: a split whose feature, or
     threshold or default direction moving training rows, differs, with
     the two gains within twice the noise of the same splits' gains
     before it); the train loop's median of 3
     and a two-round profile; every level of one round on its own inputs
     against an f64 sum: the class axis errs at most 1.5x K separate K1
     launches' largest cell error (each level's times and errors
     printed); 12b: card vs CPU at 20,000 rows, depth 4
  13. multi_output_tree at full width: (a) phase 8's data, one tree of
     7-vector leaves a round, the class axis (one pos) 8 times a round,
     probabilities summing to 1 within 1e-6, merror below a majority
     guess's 0.497, a two-round profile, the vector-leaf scan's kernels
     and time a call at the root and 128 nodes; (b) phase 3's 1M x 28
     rows with 3 regression targets (X W + 0.1 noise over the first 8
     columns, the reference test's 8 features), depth 6, 10 rounds, under
     both strategies, rmse below half the baseline's; the train loop's
     median of 3, JSON and UBJ reloads predicting identically; 13b: card
     vs CPU at 20,000 rows, depth 4, the same trees by 8b's rule,
     predictions within 1e-4
  14. the pointwise objectives at full width on phase 3's 1M x 28 rows
     (depth 6, 10 rounds) with targets built from them: absolute error,
     quantile (three alphas), pseudo-Huber, Poisson, gamma, Tweedie,
     reg:logistic, hinge, AFT and Cox, each timed (the train loop's median
     of 3) and gated on its final train metric against the constant
     model's; reg:logistic's get_gradient one launch of K4's gradient
     entry (as in 3b); a two-round profile of absolute error; the
     operations, device time and absence of copies to the host of one
     refit, one AFT and one Cox gradient; 14b: every objective of the
     slice card vs CPU at 20,000 rows, depth 4, byte-identical
     deterministic JSON and f32 trees the same up to a near tie

  2g. K5 (csrc/lambdarank.cu) against lambdarank_topk_plain, bitwise in
     grad and hess, at the MSLR shape (31,531 queries of 40-199 docs),
     two queries of 20,000 docs, queries of one and two docs, tied scores,
     all scores equal (the first round), k above the query size, each
     normalisation off, the pairwise weights, NaN scores, scores all +0.0
     or -0.0, queries at K5's shared-memory cap and a doc above it, both
     kinds in one launch, and k = 1, each on the path it must take (the
     sorts in the kernel where every query fits the cap, else the
     wrapper's); ptxas's registers and K5's shared memory and blocks an
     SM; utils/libm's expf, exp2f and log2f on the card against the same
     code on the CPU, bitwise, over 2^24 sampled inputs; timings of the
     kernel (per call with whatever the wrapper does, device time a
     launch and a call), the plain version and the bound from the pairs
     these inputs need
  15. learning to rank at full width, MSLR-shaped (scripts/bench_ladder.py:
     91-94, 136-143): 31,531 queries, about 3.77M x 136 (2% NaN), graded
     0-4, rank:ndcg, depth 8, eta 0.3, max_bin 256, 5 rounds, ndcg@10:
     ingest seconds, the train loop's median of 3, K1 and K3 launched 8
     times a round and K5 once a round (and once for the base score), the
     final ndcg@10 above the constant model's; rank:pairwise and rank:map
     with their default metric (map) and the mean pair method once each;
     one get_gradient's operations (graph_ops: one K5 launch, no copy to
     the host) and device time; a two-round profile; 15b: card vs CPU on
     20,000 rows of the generator at depth 6, 3 rounds: deterministic JSON
     byte-identical for the three objectives and the mean method, the f32
     trees the same up to a near tie

  16. the public API on the card: cv on phase 3's 1M x 28 rows (3 folds,
     10 rounds, depth 6, max_bin 256) on the f32 path and under
     deterministic_histogram=1, K1 or K2 and K3 launched 6 times a
     fold-round, K4 once a fold and three times a fold-round, the test AUC
     above 0.9, the seconds a round beside three of phase 3's, the card's
     memory the folds hold, two rounds profiled; cv card vs CPU at 20,000
     rows, deterministic: fold models byte-identical, results dicts
     equal; serialize -> a fresh Booster -> continuation byte-identical to
     the uninterrupted run; a pickle round trip and inplace_predict (numpy
     and a CUDA tensor) equal predict bit for bit on 100,000 rows;
     XGBClassifier(n_estimators=10, max_depth=6,
     deterministic_histogram=1)'s predict_proba equal to train()'s with
     the same parameters, bit for bit, and the fit's time beside
     train()'s; XGBRanker on 100,000 x 136 rows in 1,000 groups launching
     K5 rounds + 1 times

  17. the other boosters and updaters at phase 3's full width (1M x 28,
     binary:logistic, depth 6, max_bin 256, eta 0.3, 10 rounds):
     (a) booster="dart", rate_drop 0.1, uniform drops with the "tree"
     rescale and weighted drops with "forest", on both histogram paths:
     the rounds that dropped, the train loop's median of 3 beside phase
     3's, K1 or K2 and K3 6 times a round and K4's gradient once a round,
     AUC > 0.9, two deterministic runs byte-identical, JSON and UBJ
     reloads predicting identically, a profile of the first two rounds
     from the first that drops trees;
     (b) tree_method="approx" on both paths: K1 or K2 and K3 6 times a
     round, AUC > 0.9, two deterministic runs byte-identical; the
     hessian copy, the host sketch and the device bins of a round timed
     apart; a two-round profile; (c) booster="gblinear",
     binary:logistic (K4 once a round and once for the base score) and
     reg:squarederror, coord_descent (cyclic), shotgun (shuffle) and
     greedy (top_k 8), 10 rounds each: ms a round, the operations of one
     round (torch.profiler) and of one group's coordinate chain (a CUDA
     graph, no copy to the host), K1-K3 never, the final logloss and
     rmse below the constant model's, reloads predicting identically;
     (d) process_type="update" over a 3-round model: refresh alone
     (refresh_leaf 0) keeps every tree's structure and the predictions,
     refresh,prune with refresh_leaf 1 and 0 at the median gain of the
     splits above two leaves removes splits, K4 once a round; (e)
     tree_method="exact" on the first 2^17 rows, 2 rounds: seconds a
     round split into the host enumeration and the device gradient,
     AUC > 0.9; 17f: card vs CPU on 20,000 rows at depth 4: deterministic
     DART (both sample and normalize types, one_drop and skip_drop),
     approx, exact and refresh,prune of one model byte-identical, f32
     DART and approx the same trees up to a near tie, gblinear weights
     within 1e-5 relative, 1e-6 absolute
  18. interpretation with the models of phases 3, 6, 7, 8, 17a and 17c:
     (a) predict(pred_contribs=True) of phase 3's model over its 1M rows,
     of phase 8's Covertype model over its 581,012 rows (7 groups), and of
     the lossguide and DART models over 2^16 rows, each with K6
     (csrc/treeshap.cu) launched once a group and nothing else, its rows
     summing to the margin within rtol/atol 1e-3, K6 against its plain
     version (interpret/device.py) on the card (over all rows unless that
     would take over 20 s, then the first 2^18), K6's device time a launch
     and a call and its bound (its bytes at the HBM rate against its f32
     and f64 operations at the unfused rates); for HIGGS and Covertype the
     call's seconds split into X to the card, the path tables, K6, the f64
     buffer's adds and the copy to the host; (b) pred_interactions=True of
     phase 3's model over 2^16 rows the same way, split likewise, its rows
     summing to pred_contribs within rtol 3e-4, atol 5e-5; (c) Saabas over 1M rows
     on the card, gblinear's contributions (phase 17c's model), and the
     categorical host walk of phase 7's model over 2,000 rows (exact and
     interactions), each summing to the margin; (d) the card against the
     CPU on 20,000 rows: exact values within 1e-5 of the largest, Saabas
     bitwise
  19. out of core: (a) the criteo_extmem_40m row of BENCH_LADDER.json
     (scripts/bench_ladder.py:604-637): 64 pages of 655,360 Criteo-shaped
     rows (page i from seed 7000 + i, made by eight threads) through a
     DataIter into ExtMemQuantileDMatrix (max_bin 128: 1.64 GB of uint8
     pages pinned on the host), binary:logistic, depth 8, eta 0.3, 5
     rounds, the pages streamed to the card at every level: ingest seconds
     (the streaming sketch, the bins), the train loop's seconds and M
     row-rounds/s, page bytes streamed a round and the rate they reached
     beside one 256 MiB pinned copy's, the host's staging, wait and
     overlap seconds, the card's resident page bytes at most (at most
     lookahead + 1 = 3 pages) and max_memory_allocated; K1 launched pages
     x levels a round, K3 levels a round, K4 once a round and once for the
     base score; AUC@stride8 within 0.005 of the same rows trained in
     memory on the card; one round with _extmem_prefetch=0 beside one with
     the window, in turns; a two-round profile; (b) deterministic_histogram
     =1 on the first 24 pages (15,728,640 rows), 3 rounds, the same report
     with K2, two runs byte-identical; (c) 4 pages in memory
     (QuantileDMatrix) and out of core on its cuts: deterministic models
     byte-identical, predictions within 1e-6, the f32 models the same or
     apart at a near tie, a SparsePageDMatrix of the same batches as CSR
     predicting within 1e-6 of the in-memory predictions; (d) 20,000 rows
     in 4 pages under deterministic_histogram=1: the card's model JSON
     byte-identical to the CPU's
  20. data-parallel training across ranks on the one card, the HIGGS
     shape (28 features, max_bin=256, depth 6, binary:logistic): (a) two
     in-memory ranks (threads) of 1,048,576 rows each, 5 rounds, on both
     histogram paths: the distributed sketch, the ranks' models
     byte-identical, each rank's own launches (K1 or K2 and K3 6 a round,
     K4 once a round and once for the base score), the AUC on the union
     within 0.005 of one rank trained on the union, a round's time at two
     ranks beside one rank on the union, one on a shard and two threads
     training their shards alone at once, the host exchange's parts
     (device-to-host, gather, sum, host-to-device) and share of the
     round, the same ranks on a CUDA stream each at a 0.2 ms switch
     interval, and a profile of two rounds at two ranks; (b) two ranks of
     16,384 rows on the card and on the CPU, deterministic: the same
     bytes; (c) train_distributed with two worker processes on the card,
     ranked by its tracker and gathering through gloo at the tracker's
     coordinator, 262,144 rows a rank, deterministic, 3 rounds: the bytes
     of two in-memory ranks on the same shards
  21. out of core, exact and process_type="update" across ranks on the
     one card: (a) train(params, ExtMemConfig(...)) at two in-memory ranks
     on phase 19a's 64 pages, a shard a page (32 a rank, round robin),
     f32, depth 8, 5 rounds: the ranks' cuts 19a's one-rank cuts, their
     models byte-identical, each rank's own launches (K1 its pages x 8
     levels a round, K3 8 a round, K4 once a round and once for the base
     score), every rank's pages streamed (depth + 1) times a round,
     AUC@stride8 over the 64 pages within 0.005 of 19a's, the round beside
     19a's and the host exchange's parts and share of it; (b) the same on
     19b's 24 pages under deterministic_histogram=1, 3 rounds, K2: 19b's
     model JSON byte for byte; (c) exact (2 rounds) and
     refresh,prune,sync over a 5-round model at two ranks of 16,384 HIGGS
     rows each: the ranks' models byte-identical, exact's one rank's on
     the union, K4 only; (d) 20,000 rows in 4 pages at two ranks,
     deterministic: the card's model JSON the CPU's, one rank's, and
     train_distributed's with two tracker-ranked workers building their
     pages in a callable part
  22. the tracker and the launcher on the one card, 20c's shards and
     settings: (a) launcher.run_distributed with a worker function
     training its shard, over the tracker's socket relay, over gloo at
     the tracker's coordinator (each job alone) and over gloo directly
     (run_distributed's default on the card): the three jobs' model bytes
     equal each other and 20c's in-memory ranks', each worker K2 6 a
     round, K3 6 a round and K4 once a round and once for the base
     score; the jobs' seconds and their round times side by side; (b),
     beside the direct job, one worker
     raises after the rendezvous while its peer waits in its first
     collective: the job ends with WorkerFailedError within 60 s, the
     peer aborted by the tracker (exit 255), the failing worker's
     traceback in the error

Phase 2 and 2b also give each case's device time a launch (torch.profiler),
and phases 7, 8 and 9 the bound, the kernel and the index_add_ yardstick on
each launch's inputs of a round (8 also K3's bound; 9 a one-round profile
of the forest).  The script prints its total seconds.

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero if
any phase fails or no CUDA device is present.  Each phase prints its
seconds.  The last three lines are the card's name and power limit, the
kernels JSON line and the device JSON line.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM f32 outside the tensor cores; K2's int32 adds are counted at the
# same 32-bit rate (the bound is the bytes either way)
F32_FLOPS = 67e12
HIST_RTOL = 1e-5  # of the histogram's largest cell: f32 sums in other orders


def make_data(n: int, f: int, seed: int = 0):
    """HIGGS-like: informative low-order interactions + noise features
    (the workload formula of bench.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = (
        1.5 * X[:, 0]
        + X[:, 1] * X[:, 2]
        - 0.8 * np.abs(X[:, 3])
        + 0.5 * X[:, 4]
        + 0.3 * rng.normal(size=n)
    )
    y = (logits > 0).astype(np.float32)
    return X, y


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label, fn, *args):
    """``fn(*args)``, its wall seconds logged as phase ``label``'s."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label} took {time.perf_counter() - t0:.3f} s")
    return out


def _in_thread(fn, *args):
    """Start ``fn(*args)`` in a thread; the returned call joins it and
    gives its result or raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised by the join
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join(timeout=600)
        if "err" in box:
            raise box["err"]
        if "out" not in box:
            raise AssertionError(f"{fn.__name__} is still running")
        return box["out"]

    return join


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def batched_ms(fn, reps: int = 20) -> float:
    """``reps`` back-to-back calls between two CUDA events, over ``reps``."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_per_call(fn, reps: int = 20):
    """Device time and kernel launches of one call of ``fn``, from
    torch.profiler over ``reps`` calls: (ms a call, launches a call,
    {kernel: launches a call}).  The ms is the device time of the
    launches the profiler saw over their number, times the launches a
    call (it may miss the first); None where it saw no device time (not
    measured)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count, kernels = 0.0, 0, {}
    for r in prof.key_averages():
        if r.device_type != DeviceType.CUDA:
            continue
        t = getattr(r, "self_device_time_total", None)
        us += r.self_cuda_time_total if t is None else t
        count += r.count
        kernels[r.key[:60]] = kernels.get(r.key[:60], 0) + r.count
    per_call = round(count / reps)
    if not per_call:  # the profiler saw (almost) nothing
        return None, 0, {}
    return (us / 1e3 / count * per_call, per_call,
            {k: round(n / reps, 2) for k, n in kernels.items()})


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


class _Memcpy3D(ctypes.Structure):
    # CUDA_MEMCPY3D of cuda.h
    _side = [("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t),
             ("Z", ctypes.c_size_t), ("LOD", ctypes.c_size_t),
             ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
             ("Device", ctypes.c_void_p), ("Array", ctypes.c_void_p),
             ("reserved", ctypes.c_void_p), ("Pitch", ctypes.c_size_t),
             ("Height", ctypes.c_size_t)]
    _fields_ = ([("src" + k, t) for k, t in _side]
                + [("dst" + k, t) for k, t in _side]
                + [("WidthInBytes", ctypes.c_size_t),
                   ("Height", ctypes.c_size_t), ("Depth", ctypes.c_size_t)])


# CUgraphNodeType of cuda.h, by value
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "semaphore_signal",
               "semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


def graph_ops(fn) -> list:
    """Every operation one call of ``fn`` puts on its stream, read from a
    CUDA graph captured from that call rather than from the profiler,
    which in a long run may stop seeing events: a list of (node type,
    detail), the detail a kernel's name (None where the driver gives
    none) or a copy's destination, "host" or "device".  A call that waits
    on the host (a copy back to pageable memory, an ``.item()``) cannot be
    captured and raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    ops = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        name = None
        if kind.value == 0:
            p = _KernelNodeParams()
            name_p = ctypes.c_char_p()
            check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                   ctypes.byref(p)),
                  "cuGraphKernelNodeGetParams")
            if p.func and not cu.cuFuncGetName(ctypes.byref(name_p),
                                               ctypes.c_void_p(p.func)):
                name = name_p.value.decode()
            elif p.kern and not cu.cuKernelGetName(ctypes.byref(name_p),
                                                   ctypes.c_void_p(p.kern)):
                name = name_p.value.decode()
        elif kind.value == 1:
            m = _Memcpy3D()
            check(cu.cuGraphMemcpyNodeGetParams(ctypes.c_void_p(node),
                                                ctypes.byref(m)),
                  "cuGraphMemcpyNodeGetParams")
            # CU_MEMORYTYPE_HOST 1, DEVICE 2, UNIFIED 4; an unregistered
            # host pointer has no attribute
            dst = m.dstHost if m.dstMemoryType == 1 else m.dstDevice
            mem = ctypes.c_uint(1)
            rc = cu.cuPointerGetAttribute(ctypes.byref(mem), 2,
                                          ctypes.c_void_p(dst))
            name = "device" if not rc and mem.value == 2 else "host"
        ops.append((_NODE_TYPES[kind.value]
                    if 0 <= kind.value < len(_NODE_TYPES) else kind.value,
                    name))
    graph.reset()
    return ops


# K6's source builds in about three minutes, every other in under half a
# minute (one nvcc each, all at once, on the H100's host): main() leaves it
# to a thread while the phases before 18 run
LATE_BUILD = ("treeshap",)


def start_build(hist_cuda, names):
    """Start the nvcc of each library of ``names`` in a thread; the returned
    call waits for them, loads them and logs the seconds since the start.
    The thread is not a daemon: a run that fails before the call still
    waits for its nvcc at exit rather than leave it running."""
    t0 = time.perf_counter()
    errs = []

    def build():
        try:
            hist_cuda._build(list(names))
        except BaseException as e:  # noqa: BLE001 - raised by wait()
            errs.append(e)

    thread = threading.Thread(target=build)
    thread.start()

    def wait():
        t1 = time.perf_counter()
        thread.join()
        if errs:
            raise errs[0]
        for name in names:
            hist_cuda.load_library(name)
        log(f"phase 1 late build: {sorted(names)} built and loaded "
            f"{time.perf_counter() - t0:.3f} s after their start, "
            f"{time.perf_counter() - t1:.3f} s of it waited for")

    return wait


def phase_device(hist_cuda, later=()):
    """The card's name and power limit; every kernel library built (one nvcc
    a source, all at once) and loaded but those of ``later``, which a
    start_build beside this one builds."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    names = [n for n in hist_cuda.SOURCES if n not in later]
    hist_cuda._build(names)
    for name in names:
        hist_cuda.load_library(name)
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; kernels "
        f"{sorted(names)} built and loaded in {build_s:.3f} s")
    return smi


def _limbs(gpair):
    from xgboost_tpu_torch.ops.quantise import local_rho, quantise_gpair

    valid = torch.ones(gpair.shape[0], dtype=torch.bool, device=gpair.device)
    return quantise_gpair(gpair, local_rho(gpair, valid))


def _index_add_ms(name, bins, vals, pos, *, node0, n_nodes, n_bin, stride,
                  reps: int = 20):
    """The yardstick of a histogram launch: one index_add_ over
    precomputed flat indices into a flat tensor of the kernel's
    accumulator type (f32 for K1, int32 for K2's limbs), its median time
    (CUDA events)."""
    ch, acc = (2, torch.float32) if name == "hist_f32" else (6, torch.int32)
    R, F = bins.shape
    local = pos.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = inl[:, None] & (bins.long() < n_bin)
    idx = ((local // stride)[:, None] * F
           + torch.arange(F, device="cuda")[None, :]) * n_bin + bins.long()
    flat_idx = idx[take]
    flat_val = vals.reshape(R, 1, ch).to(acc).expand(R, F, ch)[take]
    flat = torch.zeros(n_nodes * F * n_bin, ch, dtype=acc, device="cuda")
    return cuda_ms(lambda: flat.index_add_(0, flat_idx, flat_val), reps)


def _case(hist_cuda, name, bins, vals, pos, *, node0, n_nodes, n_bin,
          stride):
    """One kernel-vs-plain case on the card: agreement, the kernel's, the
    plain version's and one index_add_'s times, the kernel's device
    time a launch (torch.profiler), and the bound."""
    if name == "hist_f32":
        kernel = hist_cuda.build_histogram_cuda
        plain = hist_cuda.build_histogram_plain
        ch, row_bytes = 2, 8
    else:
        kernel = hist_cuda.build_histogram_q_cuda
        plain = hist_cuda.build_histogram_q_plain
        ch, row_bytes = 6, 6
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
    got = kernel(bins, vals, pos, **kw)
    torch.cuda.synchronize()
    want = plain(bins, vals, pos, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    scale = float(want.abs().max().item())
    # K1: f32 sums in another order; K2: exact integers, bitwise
    ok = err <= HIST_RTOL * scale if name == "hist_f32" else err == 0.0

    R, F = bins.shape
    local = pos.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = inl[:, None] & (bins.long() < n_bin)

    kernel_ms = cuda_ms(lambda: kernel(bins, vals, pos, **kw))
    for _ in range(3):  # the profiler now and then sees no events at all
        device_ms, _, _ = device_per_call(
            lambda: kernel(bins, vals, pos, **kw), reps=10)
        if device_ms is not None:
            break
    plain_ms = cuda_ms(lambda: plain(bins, vals, pos, **kw), reps=5)
    library_ms = _index_add_ms(name, bins, vals, pos, **kw)

    # least work these inputs need: pos of every row, bins and gradients of
    # the rows in the level, the histogram written once; one 32-bit add per
    # (row, feature, channel) present
    n_in = int(inl.sum().item())
    n_bytes = (4 * R + n_in * (F * bins.element_size() + row_bytes)
               + n_nodes * F * n_bin * ch * 4)
    n_ops = ch * int(take.sum().item())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    if name == "hist_f32":
        plan = list(hist_cuda.plan_f32(
            R, F, n_nodes, n_bin,
            hist_cuda.card_max_clusters(bins.device, bins.dtype), stride))
    else:
        plan = list(hist_cuda.plan_q(
            R, F, n_nodes, n_bin, ch,
            hist_cuda.card_max_clusters(bins.device, bins.dtype, name),
            stride))
    return dict(kernel=name, dtype=str(bins.dtype).split(".")[-1],
                node0=node0, n_nodes=n_nodes, stride=stride,
                max_abs_err=err, max_rel_err=err / scale if scale else 0.0,
                ok=ok, kernel_ms=kernel_ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                plan=plan)


# (node0, n_nodes, stride): the six levels a depth-6 round builds (the root,
# then the left children of depths 1-5); the 16 nodes from 15, which is no
# level of a tree but was timed from the first slice on; and a 128-node
# level of a depth-9 tree, whose nodes the kernels split over blocks
LEVELS = ((0, 1, 1), (1, 1, 2), (3, 2, 2), (7, 4, 2), (15, 8, 2),
          (31, 16, 2))
SHAPES = LEVELS + ((15, 16, 2),)
TILED = (255, 128, 2)
# a best-first expansion: both children of one split, consecutive ids, at
# stride 1, with 2% of the rows (the rest sit on other leaves)
BEST_FIRST = (101, 2, 1)
# the shapes the kernels line sums, as it has since the first slice
LINE_SHAPES = ((0, 1, 1), (15, 16, 2), (31, 16, 2))


def _shape(case):
    return case["node0"], case["n_nodes"], case["stride"]


def _level_sum(cases, key):
    return sum(c[key] for c in cases
               if c["dtype"] == "int16" and _shape(c) in LEVELS)


def phase_kernels(hist_cuda, name: str, label: str):
    """K1 or K2 against its plain version at the bench shapes, int16 and
    uint8 bins, plus the node-tiled level at int16."""
    R, F = 1 << 20, 28
    rng = np.random.default_rng(1)
    cases = []
    for dtype, n_bin in ((torch.int16, 256), (torch.uint8, 254)):
        b = rng.integers(0, n_bin, size=(R, F), dtype=np.int64)
        b[rng.random((R, F)) < 0.05] = n_bin  # ~5% missing -> sentinel
        bins = torch.from_numpy(b).to(dtype).cuda()
        gpair = torch.from_numpy(np.stack(
            [rng.normal(size=R), rng.random(R)], 1).astype(np.float32)).cuda()
        vals = gpair if name == "hist_f32" else _limbs(gpair)
        shapes = SHAPES + ((TILED, BEST_FIRST) if dtype == torch.int16
                           else ())
        for node0, n_nodes, stride in shapes:
            p = rng.integers(node0, node0 + stride * n_nodes, size=R)
            if (node0, n_nodes, stride) == BEST_FIRST:
                p = rng.integers(0, 2 * node0, size=R)
            p[rng.random(R) < 0.02] = -1  # pad rows
            pos = torch.from_numpy(p.astype(np.int32)).cuda()
            case = _case(hist_cuda, name, bins, vals, pos, node0=node0,
                         n_nodes=n_nodes, n_bin=n_bin, stride=stride)
            cases.append(case)
            log(f"phase {label} kernel vs plain: " + json.dumps(case))
    if name == "hist_q":
        _adversarial_q(hist_cuda, R, F, label)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version: {bad}")
    device = [c["device_ms"] for c in cases
              if c["dtype"] == "int16" and _shape(c) in LEVELS]
    log(f"phase {label} six-level sum (one depth-6 round's histograms, "
        f"int16): kernel {_level_sum(cases, 'kernel_ms'):.4f} ms, device "
        f"{sum(device) if None not in device else 'not measured'} ms, "
        f"index_add_ "
        f"{_level_sum(cases, 'library_ms'):.4f} ms, plain "
        f"{_level_sum(cases, 'plain_ms'):.4f} ms, bound "
        f"{_level_sum(cases, 'bound_ms'):.4f} ms")
    return cases


def _adversarial_q(hist_cuda, R, F, label):
    """K2 bitwise against its plain version where one cell per feature
    takes every row with the same extreme limbs, in every block."""
    bins = torch.zeros((R, F), dtype=torch.int16, device="cuda")
    for limb in (-128, 127):
        gq = torch.full((R, 2, 3), limb, dtype=torch.int8, device="cuda")
        for node0, n_nodes, stride in ((0, 1, 1), (1, 1, 2), (31, 16, 2)):
            pos = torch.full((R,), node0, dtype=torch.int32, device="cuda")
            kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
            got = hist_cuda.build_histogram_q_cuda(bins, gq, pos, **kw)
            want = hist_cuda.build_histogram_q_plain(bins, gq, pos, **kw)
            plan = list(hist_cuda.plan_q(
                R, F, n_nodes, 256, 6,
                hist_cuda.card_max_clusters(bins.device, bins.dtype,
                                            "hist_q"), stride))
            same = torch.equal(got, want)
            log(f"phase {label} adversarial: limbs all {limb}, every row in "
                f"bin 0 of node {node0} (level {node0, n_nodes, stride}), "
                f"cell sum {int(want[0, 0, 0, 0, 0])}; plan {plan}; bitwise "
                f"equal: {same}")
            if not same:
                raise AssertionError(f"phase {label}: K2 disagrees with its "
                                     "plain version on adversarial limbs")


BASE = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 256,
        "eta": 0.3, "tree_method": "hist"}
DET = dict(BASE, deterministic_histogram=1)


def _model_bytes(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _train_main_path(xtt, hist_cuda, params, dtrain, n_rows, rounds, kernel,
                     label, repeats: int = 3, auc_gate: float = 0.9,
                     want_fn=None, metrics=("logloss", "auc")):
    """One path as a user runs it: train with the training-set eval, then
    the train loop alone ``repeats`` times (as bench.py times it: no evals,
    bins already built), each run with the launch counts set to 0 just
    before and read just after; the histogram kernel and K3 launch once per
    level that splits (max_depth a round).  ``want_fn(evals)``: the launch
    counts of a run with that many evaluation sets (binary:logistic's by
    default).  Returns the first two boosters, the first run's launches,
    the metrics and the timed loops' median rate."""
    if want_fn is None:
        def want_fn(evals):
            want = _sigmoid_launches(hist_cuda, rounds, evals=evals)
            want[kernel] = want["split_scan"] = params["max_depth"] * rounds
            return want
    want = want_fn(1)
    hist_cuda.reset_launches()
    evals_result: dict = {}
    t0 = time.perf_counter()
    bst = xtt.train(dict(params, eval_metric=list(metrics)), dtrain,
                    rounds, evals=[(dtrain, "train")],
                    evals_result=evals_result, verbose_eval=False)
    torch.cuda.synchronize()
    with_eval_s = time.perf_counter() - t0
    launches = dict(hist_cuda.launches)
    if launches != want:
        raise AssertionError(f"phase {label}: launches {launches} in "
                             f"{rounds} rounds, want {want}")
    want = want_fn(0)  # no evaluation in the timed runs
    times = []
    for _ in range(repeats):
        hist_cuda.reset_launches()
        t0 = time.perf_counter()
        run = xtt.train(params, dtrain, rounds, verbose_eval=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if hist_cuda.launches != want:
            raise AssertionError(f"phase {label}: timed run launched "
                                 f"{hist_cuda.launches}, want {want}")
        if len(times) == 1:
            timed = run  # the first timed booster, for the bytes check
    final = {m: v[-1] for m, v in evals_result["train"].items()}
    train_s = statistics.median(times)
    if "auc" in final and not final["auc"] > auc_gate:
        raise AssertionError(f"phase {label}: AUC {final['auc']} <= "
                             f"{auc_gate}")
    return dict(bst=bst, timed=timed, launches=launches[kernel],
                scan_launches=launches["split_scan"],
                sigmoid_launches=launches["sigmoid"],
                lambdarank_launches=launches["lambdarank"],
                logloss=final.get("logloss"), auc=final.get("auc"),
                final=final, train_s=train_s,
                rate=n_rows * rounds / train_s / 1e6,
                times=" ".join(f"{t:.3f}" for t in times),
                with_eval_s=with_eval_s)


def phase_train(xtt, hist_cuda, X, y, rounds: int):
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)  # the device sketch, then the bins
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    r = _train_main_path(xtt, hist_cuda, BASE, dtrain, X.shape[0], rounds,
                         "hist_f32", "3")
    r["same_bytes"] = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
    log(f"phase 3 train: {X.shape[0]} x {X.shape[1]}, {rounds} rounds; "
        f"ingest (device sketch + bins) {ingest_s:.3f} s; train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s "
        f"(runs {r['times']} s); with eval "
        f"{r['with_eval_s']:.3f} s; logloss {r['logloss']:.6f} auc "
        f"{r['auc']:.6f}; K1 and K3 launches {r['launches']} each, K4 "
        f"{r['sigmoid_launches']}; two f32 "
        f"runs gave byte-identical models: {r['same_bytes']}")
    return r, dtrain


def phase_train_det(xtt, hist_cuda, dtrain, n_rows, rounds, f32):
    """deterministic_histogram=1: every level histogram by K2, and two
    runs must write byte-identical models."""
    r = _train_main_path(xtt, hist_cuda, DET, dtrain, n_rows, rounds,
                         "hist_q", "3c")
    if _model_bytes(r["bst"]) != _model_bytes(r["timed"]):
        raise AssertionError("phase 3c: two deterministic runs wrote "
                             "different models")
    log(f"phase 3c deterministic train: {rounds} rounds; train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s (runs "
        f"{r['times']} s; f32 path, phase 3: {f32['rate']:.3f}); with eval "
        f"{r['with_eval_s']:.3f} s; "
        f"logloss {r['logloss']:.6f} auc {r['auc']:.6f}; K2 and K3 launches "
        f"{r['launches']} each, K4 {r['sigmoid_launches']}, K1 0; two runs "
        "byte-identical: True")
    return r


def phase_profile(xtt, dtrain, params, label, rounds: int = 2, top: int = 8):
    """Where a training round's time goes: device time by kernel name over
    ``rounds`` rounds (torch.profiler), and the card's idle share of the
    profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    xtt.train(params, dtrain, 1, verbose_eval=False)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        xtt.train(params, dtrain, rounds, verbose_eval=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall_ms, label, f"{rounds} rounds", top)


def _log_profile(prof, wall_ms, label, what, top: int = 8):
    """Device time by kernel name and the idle share of ``wall_ms``."""
    from torch.profiler import DeviceType

    rows = []
    for r in prof.key_averages():
        if r.device_type != DeviceType.CUDA:
            continue
        us = getattr(r, "self_device_time_total", None)
        if us is None:
            us = r.self_cuda_time_total
        rows.append((us / 1e3, r.count, r.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    rows.sort(reverse=True)
    if not rows:
        log(f"phase {label} profile: the profiler saw no device time (not "
            "measured)")
        return
    log(f"phase {label} profile: {what}, wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    for ms, n, name in rows[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:6.2f}% x{n:<5d} {name[:90]}")
    # K1's class axis: its histogram and bucketing kernels together
    axis = [(ms, n) for ms, n, name in rows if "hist_multi" in name]
    if axis:
        axis_ms = sum(ms for ms, _ in axis)
        log(f"  class axis (csrc/hist_multi.cu, {len(axis)} kernels, "
            f"{sum(n for _, n in axis)} launches): {axis_ms:.3f} ms, "
            f"{100 * axis_ms / busy_ms:.2f}% of busy")


def phase_predict(xtt, bst, X):
    dtest = xtt.DMatrix(X[:100_000])
    pred = bst.predict(dtest)
    if pred.shape != (100_000,) or not np.all(np.isfinite(pred)):
        raise AssertionError(f"bad predictions: shape {pred.shape}")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for ext in ("json", "ubj"):
            path = os.path.join(tmp, f"model.{ext}")
            bst.save_model(path)
            again = xtt.Booster(model_file=path).predict(dtest)
            if not np.array_equal(pred, again):
                raise AssertionError(
                    f"{ext} round trip changed predictions by "
                    f"{np.abs(pred - again).max()}")
    log("phase 4 predict: 100000 rows finite; JSON and UBJ reloads predict "
        "identically")


def _card_vs_cpu(xtt, params, X, y, rounds, atol, label, identical=False,
                 **dm):
    """Train the same small input on the card and on the CPU (whose
    histograms are the plain versions the tests hold against the JAX
    reference): the cuts (device sketch on the card, host grid on the CPU)
    must agree bitwise at this size, the trees must be the same and the
    predictions within ``atol``; with ``identical`` the model JSON must be
    byte-identical."""
    d_card = xtt.DMatrix(X, label=y, **dm)
    d_cpu = xtt.DMatrix(X, label=y, device="cpu", **dm)
    cuts = [d.ensure_ellpack(params["max_bin"]).cuts.cut_values
            for d in (d_card, d_cpu)]
    if not np.array_equal(cuts[0].view(np.uint32), cuts[1].view(np.uint32)):
        raise AssertionError(f"phase {label}: the device sketch and the host "
                             "grid gave different cuts")
    got = xtt.train(params, d_card, rounds, verbose_eval=False)
    ref = xtt.train(params, d_cpu, rounds, verbose_eval=False, device="cpu")
    for a, b in zip(got.trees, ref.trees):
        ca, cb = a.categories or {}, b.categories or {}
        if not (np.array_equal(a.split_indices, b.split_indices)
                and np.array_equal(a.left_children, b.left_children)
                and sorted(ca) == sorted(cb)
                and all(np.array_equal(ca[k], cb[k]) for k in ca)):
            raise AssertionError(f"phase {label}: card and CPU grew "
                                 "different trees")
    ft = dm.get("feature_types")
    diff = np.abs(got.predict(xtt.DMatrix(X, feature_types=ft)) -
                  ref.predict(xtt.DMatrix(X, device="cpu",
                                          feature_types=ft))).max()
    if diff > atol:
        raise AssertionError(f"phase {label}: card and CPU predictions "
                             f"differ by {diff}")
    leaves = max(int((t.left_children == -1).sum()) for t in got.trees)
    same = _model_bytes(got) == _model_bytes(ref)
    n_cat = sum(len(t.categories or {}) for t in got.trees)
    log(f"phase {label} parity: card vs CPU on {X.shape[0]} rows, same "
        f"trees (at most {leaves} leaves, {n_cat} categorical splits), max "
        f"|pred diff| {diff:.3g}; model JSON byte-identical: {same}")
    if identical and not same:
        raise AssertionError(f"phase {label}: the card's model JSON is not "
                             "the CPU's")


SMALL = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
         "eta": 0.3}
# monotone on feature 0, two interaction sets, every column sampler and a
# leaf budget that binds at depth 6 (64 leaves otherwise)
CONSTRAINED = {"monotone_constraints": "(" + ",".join(["1"] + ["0"] * 27)
               + ")",
               "interaction_constraints": [[0, 1, 2], [3, 4]],
               "colsample_bytree": 0.8, "colsample_bylevel": 0.8,
               "colsample_bynode": 0.8, "max_leaves": 24, "max_depth": 6}


def phase_parity(xtt):
    X, y = make_data(20_000, 28, seed=3)
    _card_vs_cpu(xtt, SMALL, X, y, 5, 1e-4, "5")


def phase_parity_det(xtt, dtrain, X):
    """Phase 5 under deterministic_histogram=1, then with the constraints;
    the constrained model at full width must not decrease along feature 0."""
    Xs, ys = make_data(20_000, 28, seed=3)
    det = dict(SMALL, deterministic_histogram=1)
    _card_vs_cpu(xtt, det, Xs, ys, 5, 1e-5, "5b", identical=True)
    _card_vs_cpu(xtt, dict(det, **CONSTRAINED), Xs, ys, 5, 1e-5,
                 "5b constrained", identical=True)
    _card_vs_cpu(xtt, dict(det, subsample=0.8, seed=7), Xs, ys, 5, 1e-5,
                 "5b subsample", identical=True)
    bst = xtt.train(dict(DET, **CONSTRAINED), dtrain, 10, verbose_eval=False)
    grid = np.linspace(-3, 3, 20, dtype=np.float32)
    rows = np.repeat(X[:2000], len(grid), axis=0)
    rows[:, 0] = np.tile(grid, 2000)
    margin = bst.predict(xtt.DMatrix(rows), output_margin=True)
    steps = np.diff(margin.reshape(2000, len(grid)), axis=1)
    if (steps < 0).any():
        raise AssertionError(f"phase 5b: the monotone model decreases along "
                             f"feature 0 by up to {-steps.min()}")
    log(f"phase 5b monotone: {X.shape[0]} x {X.shape[1]} constrained model, "
        f"10 rounds; margins of 2000 rows over 20 values of feature 0 never "
        f"decrease (largest step {steps.max():.4g})")


# ------------------------------------------------------------------ K3
SCAN_LEVELS = (1, 2, 4, 8, 16, 32)  # nodes at depths 0-5 of a depth-6 tree
SCAN_F, SCAN_B = 28, 256


def _scan_inputs(N, F, B, seed):
    """A level's split-scan inputs: histograms with ~5% missing mass and
    n_bins below B, repeated bins and features (ties), a node whose every
    bin fails min_child_weight (no candidate), a dead slot, 30% of the
    features masked per node, monotone bounds and constraints."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, F, B, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1]) * 2
    h[:, :, 1::2] = h[:, :, ::2][:, :, : B // 2]
    h[:, 1::2] = h[:, ::2][:, : F // 2]
    nb = rng.integers(B // 2, B + 1, size=F).astype(np.int32)
    for f in range(F):
        h[:, f, nb[f]:] = 0.0
    tot = (h[:, 0].sum(1) * np.float32(1.05)).astype(np.float32)
    if N > 2:
        h[0, :, :, 1] = 1e-4
        tot[0, 1] = np.float32(B * 1e-4 + 1e-3)
    if N > 1:
        h[-1] = 0.0
        tot[-1] = 0.0
    fm = rng.random((N, F)) < 0.7
    bounds = np.stack([rng.normal(size=N) - 1.5, rng.normal(size=N) + 1.5],
                      1).astype(np.float32)
    mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    T = torch.from_numpy
    return T(h), T(tot), T(nb), T(fm), T(bounds), mono


def _cumsum_scan(hist, totals, n_bins, p, fm):
    """The port's unconstrained split scan before K3 (torch.cumsum and
    about 40 elementwise PyTorch ops a level): a timing yardstick only."""
    N, F, B, _ = hist.shape
    cum = hist.cumsum(dim=2)
    miss = totals[:, None, :] - cum[:, :, -1, :]

    def gain(G, H):
        t = torch.sign(G) * torch.clamp(G.abs() - p.alpha, min=0.0)
        return torch.where(H <= 0.0, 0.0, t * t / (H + p.lambda_))

    parent = gain(totals[:, 0], totals[:, 1])[:, None, None]

    def side(GL, HL):
        GR = totals[:, None, None, 0] - GL
        HR = totals[:, None, None, 1] - HL
        ok = (HL >= p.min_child_weight) & (HR >= p.min_child_weight) \
            & (HL > 0.0) & (HR > 0.0)
        return torch.where(ok, gain(GL, HL) + gain(GR, HR) - parent,
                           -torch.inf)

    g_r = side(cum[..., 0], cum[..., 1])
    g_l = side(cum[..., 0] + miss[:, :, None, 0],
               cum[..., 1] + miss[:, :, None, 1])
    b = torch.arange(B, device=hist.device)
    nb = n_bins.long()
    ok = (b[None, :] < nb[:, None] - 1)[None] | (
        (b[None, None, :] == nb[None, :, None] - 1)
        & (miss[:, :, 1:2].abs() > 1e-6))
    ok = ok & fm[:, :, None]
    g_r = torch.where(ok, g_r, -torch.inf)
    g_l = torch.where(ok, g_l, -torch.inf)
    left = g_l >= g_r
    best = torch.where(left, g_l, g_r).reshape(N, -1).argmax(1)
    return best, left.reshape(N, -1).gather(1, best[:, None])


def phase_split_scan(hist_cuda):
    """K3 against its plain version, bitwise, on the card's inputs and on
    their CPU copies, at the depth-6 level shapes and N = 2."""
    from xgboost_tpu_torch.ops.split import (SplitParams, is_monotone,
                                             monotone_vec, split_scan_plain)
    from xgboost_tpu_torch.ops.split_cuda import split_scan_cuda

    cases = []
    for mode in ("native", "monotone"):
        for N in SCAN_LEVELS:
            h, tot, nb, fm, bounds, mono = _scan_inputs(N, SCAN_F, SCAN_B,
                                                        seed=N)
            p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0,
                            lambda_=1.0, alpha=0.0, max_delta_step=0.0,
                            monotone=mono if mode == "monotone" else None)
            args = [t.cuda() for t in (h, tot, nb, fm, bounds)]
            args.append(monotone_vec(mono, args[0].device)
                        if is_monotone(p) else None)
            got = split_scan_cuda(*args[:3], p, *args[3:])
            torch.cuda.synchronize()
            want = split_scan_plain(h, tot, nb, p, fm, bounds)
            on_card = split_scan_plain(*args[:3], p, args[3], args[4])
            err, same, same_card = 0.0, True, True
            for a, b, c in zip(got, want, on_card):
                a, c = a.cpu(), c.cpu()
                if a.dtype == torch.float32:
                    fin = torch.isfinite(b)
                    if fin.any():
                        err = max(err, float((a[fin] - b[fin]).abs().max()))
                    a, b, c = (t.view(torch.int32) for t in (a, b, c))
                same &= torch.equal(a, b)
                same_card &= torch.equal(c, b)
            kernel_ms = cuda_ms(lambda: split_scan_cuda(*args[:3], p,
                                                        *args[3:]))
            kernel_batched = batched_ms(lambda: split_scan_cuda(
                *args[:3], p, *args[3:]))
            device_ms, _, _ = device_per_call(lambda: split_scan_cuda(
                *args[:3], p, *args[3:]))
            plain_ms = cuda_ms(lambda: split_scan_plain(
                *args[:3], p, args[3], args[4]), reps=5)
            cumsum_ms = (cuda_ms(lambda: _cumsum_scan(*args[:3], p, args[3]))
                         if mode == "native" else None)
            # the histogram read once, the totals, n_bins, mask and bounds,
            # six outputs per node; about 30 f32 operations per (node,
            # feature, bin) for both directions' gains
            n_bytes = (h.numel() * 4 + N * 8 + SCAN_F * 4 + N * SCAN_F
                       + N * 8 + N * 30)
            t_bytes = n_bytes / HBM_BYTES_PER_S
            t_ops = 30 * N * SCAN_F * SCAN_B / F32_FLOPS
            case = dict(kernel="split_scan", mode=mode, n_nodes=N, F=SCAN_F,
                        B=SCAN_B, bitwise=same, plain_on_card_bitwise=same_card,
                        max_abs_err=err, kernel_ms=kernel_ms,
                        batched_ms=kernel_batched, device_ms=device_ms,
                        plain_ms=plain_ms, cumsum_scan_ms=cumsum_ms,
                        bound_ms=max(t_bytes, t_ops) * 1e3,
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
            cases.append(case)
            log("phase 2c kernel vs plain: " + json.dumps(case))
    bad = [c for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError(f"split_scan disagrees with its plain version: "
                             f"{bad}")
    lv = [c for c in cases if c["mode"] == "native"]
    log(f"phase 2c six-level sum (one depth-6 round's scans, unconstrained):"
        f" kernel {sum(c['kernel_ms'] for c in lv):.4f} ms (batched "
        f"{sum(c['batched_ms'] for c in lv):.4f}, device "
        f"{_sum_device(lv)}), cumsum "
        f"formulation {sum(c['cumsum_scan_ms'] for c in lv):.4f} ms, plain "
        f"{sum(c['plain_ms'] for c in lv):.4f} ms, bound "
        f"{sum(c['bound_ms'] for c in lv):.4f} ms")
    mv = [c for c in cases if c["mode"] == "monotone"]
    log(f"phase 2c six-level sum, monotone: kernel "
        f"{sum(c['kernel_ms'] for c in mv):.4f} ms (batched "
        f"{sum(c['batched_ms'] for c in mv):.4f}, device {_sum_device(mv)})")
    return cases


def _sum_device(cases) -> str:
    """The cases' device ms summed, or "not measured"."""
    if any(c["device_ms"] is None for c in cases):
        return "not measured"
    return f"{sum(c['device_ms'] for c in cases):.4f} ms"


# ------------------------------------------------- K3, categorical mode
CAT_LEVELS = (1, 2, 4, 8, 16, 32, 64)  # nodes at depths 0-6 of a depth-8 tree
CAT_F, CAT_B, CAT_NUM = 39, 128, 13  # Criteo: 13 numeric, 26 categorical


def _cat_scan_inputs(N, seed):
    """A categorical level's split-scan inputs at the Criteo shape: 13
    numeric features of 128 bins and 26 categorical ones of 100 categories,
    10% of the categories empty, repeated bins (ties in G/H), ~5% missing
    mass, 80% of the features allowed per node; each numeric feature's
    bins a shuffle of a categorical one's, so that every feature holds the
    node's rows and both kinds of split win somewhere; the histogram as
    comb * scale, the limb form deterministic_histogram scans."""
    rng = np.random.default_rng(seed)
    comb = rng.integers(-4000, 4000, size=(N, CAT_F, CAT_B, 2)).astype(
        np.float32)
    comb[..., 1] = np.abs(comb[..., 1]) + 1
    comb[:, :, 1::4] = comb[:, :, ::4][:, :, : CAT_B // 4]
    nb = np.full(CAT_F, CAT_B, np.int32)
    nb[CAT_NUM:] = 100
    comb[:, CAT_NUM:, 100:] = 0.0
    comb[rng.random((N, CAT_F, CAT_B)) < 0.1] = 0.0
    for f in range(CAT_NUM):
        comb[:, f] = 0.0
        comb[:, f, rng.permutation(CAT_B)[:100]] = comb[:, CAT_NUM + f, :100]
    scale = torch.tensor([3e-4, 1e-4])
    comb = torch.from_numpy(comb)
    h = comb * scale
    tot = (h[:, CAT_NUM].sum(1) * 1.05).float()
    fm = torch.from_numpy(rng.random((N, CAT_F)) < 0.8)
    cm = torch.zeros(CAT_F, dtype=torch.bool)
    cm[CAT_NUM:] = True
    return h, tot, torch.from_numpy(nb), fm, cm, (comb, scale)


def phase_split_scan_cat():
    """K3's categorical mode against its plain version, bitwise, at the
    levels of a depth-8 round, partition and one-hot, from the histogram
    and from its limb form."""
    from xgboost_tpu_torch.ops.split import SplitParams, split_scan_plain
    from xgboost_tpu_torch.ops.split_cuda import split_scan_cuda

    cases = []
    for onehot in (4, 128):
        for N in CAT_LEVELS:
            h, tot, nb, fm, cm, dq = _cat_scan_inputs(N, seed=N + onehot)
            p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0,
                            lambda_=1.0, alpha=0.0, max_delta_step=0.0,
                            max_cat_to_onehot=onehot)
            card = [t.cuda() for t in (h, tot, nb, fm, cm)]
            dq_card = tuple(t.cuda() for t in dq)
            same, err, n_cat = True, 0.0, 0
            for limbs in (False, True):
                got = split_scan_cuda(*card[:3], p, card[3], None, None,
                                      card[4], dq_card if limbs else None)
                torch.cuda.synchronize()
                want = split_scan_plain(h, tot, nb, p, fm, None, cm,
                                        dq if limbs else None)
                for a, b in zip(got, want):
                    a = a.cpu()
                    if a.dtype == torch.float32:
                        fin = torch.isfinite(b)
                        if fin.any():
                            err = max(err, float((a[fin] - b[fin]).abs()
                                                 .max()))
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    same &= torch.equal(a, b)
                n_cat = int(cm[want.feature].sum())
            kernel_ms = cuda_ms(lambda: split_scan_cuda(
                *card[:3], p, card[3], None, None, card[4]))
            kernel_batched = batched_ms(lambda: split_scan_cuda(
                *card[:3], p, card[3], None, None, card[4]))
            device_ms, _, _ = device_per_call(lambda: split_scan_cuda(
                *card[:3], p, card[3], None, None, card[4]))
            plain_ms = cuda_ms(lambda: split_scan_plain(
                *card[:3], p, card[3], None, card[4]), reps=5)
            # the histogram read once, totals, n_bins, mask and cat mask,
            # seven outputs per node (cat_set B bytes); about 30 f32
            # operations per (node, feature, bin) and a sort's B log2 B
            # comparisons per categorical (node, feature)
            n_bytes = (h.numel() * 4 + N * 8 + CAT_F * 5 + N * CAT_F
                       + N * (30 + CAT_B))
            n_ops = (30 * N * CAT_F * CAT_B
                     + N * (CAT_F - CAT_NUM) * CAT_B * 7)
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
            case = dict(kernel="split_scan", mode="categorical",
                        max_cat_to_onehot=onehot, n_nodes=N, F=CAT_F,
                        B=CAT_B, categorical_features=CAT_F - CAT_NUM,
                        nodes_split_on_categorical=n_cat, bitwise=same,
                        max_abs_err=err, kernel_ms=kernel_ms,
                        batched_ms=kernel_batched, device_ms=device_ms,
                        plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops) * 1e3,
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
            cases.append(case)
            log("phase 2e kernel vs plain: " + json.dumps(case))
    bad = [c for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError("split_scan's categorical mode disagrees with "
                             f"its plain version: {bad}")
    part = [c for c in cases if c["max_cat_to_onehot"] == 4]
    log(f"phase 2e seven-level sum (one depth-8 round's scans, partition): "
        f"kernel {sum(c['kernel_ms'] for c in part):.4f} ms (batched "
        f"{sum(c['batched_ms'] for c in part):.4f}, device "
        f"{_sum_device(part)}), plain "
        f"{sum(c['plain_ms'] for c in part):.4f} ms, bound "
        f"{sum(c['bound_ms'] for c in part):.4f} ms")
    return cases


# ------------------------------------------------------------------ K4
SIGMOID_N = 1_000_448  # the main path's margins: 1,000,000 rows padded


def _sigmoid_launches(hist_cuda, rounds, evals):
    """Launch counts with K4's for a binary:logistic training: once for the
    base score, once per round for the gradients and once per round for
    each evaluation set; the other kernels' are filled in by the caller."""
    want = {name: 0 for name in hist_cuda.launches}
    want["sigmoid"] = 1 + rounds * (1 + evals)
    return want


def _margins(n: int, seed: int = 5):
    """The main path's margins of a logistic model, with the f32 range's
    edges (the clamps at -104 and 88.8, overflow, infinities, NaN) mixed
    in."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 4).astype(np.float32)
    k = rng.choice(n, size=n // 8, replace=False)
    x[k] = rng.uniform(-120, 120, size=k.size)
    edges = np.float32([0.0, -0.0, 1e-30, -1e-30, 88.37, -88.37, 88.8, -88.8,
                        89.0, -89.0, 104.0, -104.0, 105.0, -105.0, np.inf,
                        -np.inf, np.nan])
    x[:edges.size] = edges
    return x


def _same_bits(a, want) -> bool:
    """Bitwise equal, NaN where ``want`` has NaN."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(a), nan) and torch.equal(
        a[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _parent_gradient(x, y, w, spw):
    """The port's binary:logistic gradient before K4 took it whole: K4's
    sigmoid and about nine PyTorch operations (a timing yardstick only)."""
    from xgboost_tpu_torch.ops.sigmoid_cuda import sigmoid_cuda

    p = sigmoid_cuda(x)
    wp = torch.where(y == 1.0, spw, 1.0)
    g, h = (p - y) * wp, torch.clamp(p * (1 - p), min=1e-16) * wp
    if w is not None:
        g, h = g * w, h * w
    return torch.stack([g, h], dim=-1)[:, None, :].to(torch.float32)


def phase_sigmoid(hist_cuda):
    """K4's two entries against their plain versions, bitwise, on the main
    path's shape: the sigmoid of the margins, and the binary:logistic
    gradient pairs with and without weights and scale_pos_weight."""
    from xgboost_tpu_torch.ops.sigmoid_cuda import (logistic_gradient_cuda,
                                                    logistic_gradient_plain,
                                                    sigmoid_cuda)
    from xgboost_tpu_torch.utils.fp import sigmoid_f32

    x_cpu = torch.from_numpy(_margins(SIGMOID_N))
    x_card = x_cpu.cuda()
    got = sigmoid_cuda(x_card).cpu()
    want = sigmoid_f32(x_cpu)
    on_card = sigmoid_f32(x_card).cpu()
    nan = torch.isnan(want)
    err = float((got[~nan] - want[~nan]).abs().max())
    # each margin read once and each probability written once; about 30
    # f32 operations per element (nine multiply-adds, the clamps, scaling,
    # the division and the flushes)
    t_bytes = 8 * SIGMOID_N / HBM_BYTES_PER_S
    t_ops = 30 * SIGMOID_N / F32_FLOPS
    case = dict(kernel="sigmoid", n=SIGMOID_N, bitwise=_same_bits(got, want),
                plain_on_card_bitwise=_same_bits(on_card, want),
                max_abs_err=err, kernel_ms=cuda_ms(lambda: sigmoid_cuda(x_card)),
                batched_ms=batched_ms(lambda: sigmoid_cuda(x_card)),
                device_ms=device_per_call(lambda: sigmoid_cuda(x_card))[0],
                plain_ms=cuda_ms(lambda: sigmoid_f32(x_card), reps=5),
                library_ms=cuda_ms(lambda: torch.sigmoid(x_card)),
                library_batched_ms=batched_ms(lambda: torch.sigmoid(x_card)),
                library_device_ms=device_per_call(
                    lambda: torch.sigmoid(x_card))[0],
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    log("phase 2d kernel vs plain: " + json.dumps(case))
    cases = [case]
    rng = np.random.default_rng(6)
    y_cpu = torch.from_numpy((rng.random(SIGMOID_N) < 0.4).astype(np.float32))
    w_cpu = torch.from_numpy((rng.random(SIGMOID_N) + 0.01).astype(
        np.float32))
    y_card, w_card = y_cpu.cuda(), w_cpu.cuda()
    for weighted, spw in ((False, 1.0), (True, 1.0), (True, 2.5)):
        wc, wk = (w_cpu, w_card) if weighted else (None, None)
        got = logistic_gradient_cuda(x_card, y_card, wk, spw).cpu()
        want = logistic_gradient_plain(x_cpu, y_cpu, wc, spw)
        nan = torch.isnan(want)
        err = float((got[~nan] - want[~nan]).abs().max())

        def kernel():
            return logistic_gradient_cuda(x_card, y_card, wk, spw)
        device_ms, n_kernels, _ = device_per_call(kernel)
        _, parent_kernels, _ = device_per_call(
            lambda: _parent_gradient(x_card, y_card, wk, spw))
        # margin and label (and weight) read once, the pairs written once;
        # about 40 f32 operations per element
        t_bytes = (16 + 4 * weighted) * SIGMOID_N / HBM_BYTES_PER_S
        t_ops = 40 * SIGMOID_N / F32_FLOPS
        case = dict(kernel="logistic_grad", n=SIGMOID_N, weighted=weighted,
                    scale_pos_weight=spw, bitwise=_same_bits(got, want),
                    max_abs_err=err, kernel_ms=cuda_ms(kernel),
                    batched_ms=batched_ms(kernel), device_ms=device_ms,
                    launches_per_call=n_kernels,
                    plain_ms=cuda_ms(lambda: logistic_gradient_plain(
                        x_card, y_card, wk, spw), reps=5),
                    parent_ms=cuda_ms(lambda: _parent_gradient(
                        x_card, y_card, wk, spw)),
                    parent_launches_per_call=parent_kernels,
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("phase 2d kernel vs plain: " + json.dumps(case))
        cases.append(case)
    bad = [c for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError(f"K4 disagrees with its plain version: {bad}")
    return cases


def phase_gradient_profile(xtt, hist_cuda, objective="binary:logistic",
                           label="3b"):
    """The main path's binary:logistic gradient (and reg:logistic's, phase
    14) is one launch of K4's gradient entry: every operation one
    get_gradient call puts on the stream at the main path's 1,000,448
    rows, from a CUDA graph captured from the call (graph_ops), with K4's
    launch count; its device time from torch.profiler."""
    from xgboost_tpu_torch.objective import create_objective

    rng = np.random.default_rng(7)
    margin = torch.from_numpy(_margins(SIGMOID_N)[:, None]).cuda()
    y = torch.from_numpy((rng.random(SIGMOID_N) < 0.4).astype(
        np.float32)).cuda()
    obj = create_objective(objective, {})

    def call():
        return obj.get_gradient(margin, y, None)
    call()
    before = dict(hist_cuda.launches)
    ops = graph_ops(call)
    k4 = hist_cuda.launches["sigmoid"] - before["sigmoid"]
    others = {k: v - before[k] for k, v in hist_cuda.launches.items()
              if k != "sigmoid" and v != before[k]}
    for _ in range(3):  # the profiler now and then sees no events at all
        ms, n, kernels = device_per_call(call)
        if n:
            break
    profiled = (f"{ms} ms of device time (torch.profiler: {kernels})" if n
                else "device time not measured (the profiler saw no events)")
    log(f"phase {label} gradient: one {objective} get_gradient at "
        f"{SIGMOID_N} rows puts {len(ops)} operation(s) on the stream: "
        f"{ops}; K4 counts {k4} launch(es) of two calls, captured and "
        f"warm; {profiled}")
    # the capture's call and the warm call before it each launch K4 once
    if len(ops) != 1 or ops[0][0] != "kernel" or k4 != 2 or others \
            or (ops[0][1] is not None and "logistic_grad" not in ops[0][1]):
        raise AssertionError(
            f"phase {label}: get_gradient issued {ops} (K4 launches {k4} "
            f"in two calls, others {others}), want one launch of K4's "
            "gradient entry")


# ------------------------------------------------------------- lossguide
LOSSGUIDE = {"objective": "binary:logistic", "max_bin": 256,
             "grow_policy": "lossguide", "max_depth": 0, "max_leaves": 255,
             "subsample": 0.8, "colsample_bynode": 0.8, "eta": 0.3}


def _splits(bst):
    return [int((t.left_children != -1).sum()) for t in bst.trees]


def phase_lossguide(xtt, hist_cuda, dtrain, n_rows, rounds: int = 10,
                    repeats: int = 3):
    """grow_policy=lossguide at full width: K1 and K3 launched once at each
    tree's root and once per expansion, AUC > 0.9, the train loop's median
    and expansions per second."""
    hist_cuda.reset_launches()
    res: dict = {}
    bst = xtt.train(dict(LOSSGUIDE, eval_metric=["logloss", "auc"]), dtrain,
                    rounds, evals=[(dtrain, "train")], evals_result=res,
                    verbose_eval=False)
    torch.cuda.synchronize()
    splits = _splits(bst)
    want = _sigmoid_launches(hist_cuda, rounds, evals=1)
    want["hist_f32"] = want["split_scan"] = rounds + sum(splits)
    if hist_cuda.launches != want:
        raise AssertionError(f"phase 6: launches {hist_cuda.launches}, want "
                             f"{want} for splits {splits}")
    auc = res["train"]["auc"][-1]
    if not auc > 0.9:
        raise AssertionError(f"phase 6: AUC {auc} <= 0.9")
    times, expansions = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run = xtt.train(LOSSGUIDE, dtrain, rounds, verbose_eval=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        expansions.append(sum(_splits(run)))
    k = times.index(statistics.median(times))
    depth = max(t.max_depth for t in bst.trees)
    log(f"phase 6 lossguide: {n_rows} x 28, max_leaves=255, subsample=0.8, "
        f"colsample_bynode=0.8, {rounds} rounds; splits per tree {splits}; "
        f"deepest tree {depth}; K1 {want['hist_f32']} and K3 "
        f"{want['split_scan']} launches; logloss "
        f"{res['train']['logloss'][-1]:.6f} auc {auc:.6f}; train loop median "
        f"{times[k]:.3f} s (runs {' '.join(f'{t:.3f}' for t in times)}) = "
        f"{expansions[k] / times[k]:.1f} expansions/s, "
        f"{n_rows * rounds / times[k] / 1e6:.3f} M row-rounds/s")
    return bst


def phase_lossguide_parity(xtt):
    """Lossguide card vs CPU at 20,000 rows with feature_weights, under both
    sampling methods; the card's uniform row masks equal the CPU's."""
    X, y = make_data(20_000, 28, seed=3)
    fw = np.linspace(0.2, 2.0, 28).astype(np.float32)
    base = dict(LOSSGUIDE, max_leaves=31, max_bin=64, seed=5,
                colsample_bytree=0.8)
    _card_vs_cpu(xtt, dict(base, subsample=0.8), X, y, 3, 1e-4,
                 "6b uniform", feature_weights=fw)
    _card_vs_cpu(xtt, dict(base, subsample=0.5,
                           sampling_method="gradient_based"), X, y, 3, 1e-4,
                 "6b gradient_based", feature_weights=fw)
    masks = []
    for dev in ("cuda", "cpu"):
        bst = xtt.Booster(dict(base, subsample=0.8), device=dev)
        bst._configure()
        g = torch.ones((1 << 20, 1, 2), device=dev)
        masks.append(bst._subsample_mask(g, 131)[:, 0, 0].cpu())
    if not torch.equal(masks[0], masks[1]):
        raise AssertionError("phase 6b: the card's row masks are not the "
                             "CPU's")
    log(f"phase 6b masks: {1 << 20} uniform row draws, card equal to CPU "
        f"bitwise ({int(masks[0].sum())} rows kept)")


# ---------------------------------------------------------- categorical
CRITEO = {"objective": "binary:logistic", "max_depth": 8, "max_bin": 128,
          "eta": 0.3}
CRITEO_DET = dict(CRITEO, deterministic_histogram=1)
CRITEO_TYPES = ["q"] * 13 + ["c"] * 26
# training-set AUC gate at full size: the CPU port's held-out AUC at 20,000
# rows of this generator, depth 8, 10 rounds, is 0.9231 (0.9223 under
# deterministic_histogram); 2**20 rows overfit less than 20,000, so the
# training AUC there should sit near the held-out one, above 0.90
CRITEO_AUC_GATE = 0.90


def make_criteo(n: int, seed: int = 7000):
    """The Criteo-shaped rows of scripts/bench_ladder.py:616-631: 13
    numeric columns (20% NaN) and 26 head-heavy categorical codes of at
    most 100 categories."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, 39), np.float32)
    X[:, :13] = rng.normal(size=(n, 13))
    X[:, :13][rng.random((n, 13)) < 0.2] = np.nan
    X[:, 13:] = np.minimum(rng.geometric(0.08, size=(n, 26)) - 1, 99)
    lin = (np.nan_to_num(X[:, 0]) * 1.2 - np.nan_to_num(X[:, 1])
           + 0.5 * np.nan_to_num(X[:, 2]) * np.nan_to_num(X[:, 3])
           + 0.3 * (X[:, 13] == 0))
    y = (lin + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _launch_bytes(kernel, bins, vals, pos, *, node0, n_nodes, n_bin,
                  stride=1, **extra):
    """The least bytes one histogram launch moves, as phase 2 counts them:
    pos of every row, bins and gradients of the level's rows (the rows in
    the nodes it builds), the histogram written once; for K1's class axis
    as phase 2f counts them: K pos arrays, or one when shared, the bins of
    the rows in any class's level once, the gradients of the (row, class)
    pairs in the level, the K histograms written once."""
    R, F = bins.shape
    local = pos.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    if kernel == "hist_f32_multi":
        K = vals.shape[1]
        n_any = int((inl if inl.dim() == 1 else inl.any(dim=0)).sum())
        n_pairs = int(inl.sum()) * (K if inl.dim() == 1 else 1)
        return (4 * pos.numel() + n_any * F * bins.element_size()
                + n_pairs * 8 + K * n_nodes * F * n_bin * 8)
    n_in = int(inl.sum())
    row_bytes = vals[0].numel() * vals.element_size()
    cell_bytes = 8 if kernel == "hist_f32" else 4 * vals[0].numel()
    return (4 * R + n_in * (F * bins.element_size() + row_bytes)
            + n_nodes * F * n_bin * cell_bytes)


def _counted_round(xtt, hist_cuda, dtrain, params, kernel, keep=None):
    """One round trained with each launch of ``kernel`` counted (the
    launch function wrapped): the least bytes of each launch, and, into
    ``keep`` where given, each launch's inputs."""
    name = {"hist_f32": "run_f32", "hist_q": "run_q",
            "hist_f32_multi": "run_f32_multi"}[kernel]
    launch = getattr(hist_cuda, name)
    sizes = []

    def counted(bins, vals, pos, plan, **kw):
        kw.setdefault("stride", 1)
        sizes.append(_launch_bytes(kernel, bins, vals, pos, **kw))
        if keep is not None:
            keep.append((bins, vals.clone(), pos.clone(), plan, kw))
        return launch(bins, vals, pos, plan, **kw)

    setattr(hist_cuda, name, counted)
    try:
        xtt.train(params, dtrain, 1, verbose_eval=False)
    finally:
        setattr(hist_cuda, name, launch)
    return sizes


def _round_hist_bound(xtt, hist_cuda, dtrain, params, kernel, label,
                      reps: int = 20):
    """The bound of one round's histograms on this data: one round trained
    with each launch's least bytes counted (_launch_bytes) at 3.35 TB/s,
    summed over the launches; then, on each launch's own inputs, the
    kernel again (CUDA events, host launch included) and the index_add_
    yardstick (over the K classes at once for the class axis), each the
    median of ``reps``, summed.  Returns (bound ms, index_add_ ms, kernel
    ms) a round."""
    launch = getattr(hist_cuda, {"hist_f32": "run_f32", "hist_q": "run_q",
                                 "hist_f32_multi": "run_f32_multi"}[kernel])
    inputs = []
    sizes = _counted_round(xtt, hist_cuda, dtrain, params, kernel, inputs)
    bound_ms = sum(sizes) / HBM_BYTES_PER_S * 1e3
    library_ms = kernel_ms = 0.0
    for bins, vals, pos, plan, kw in inputs:
        # the index_add_ yardstick and the kernel on each launch's inputs
        if kernel == "hist_f32_multi":
            kw2 = dict(kw)
            shared = kw2.pop("shared_pos", False)
            library_ms += _index_add_multi_ms(bins, vals, pos, shared, **kw2)
        else:
            library_ms += _index_add_ms(kernel, bins, vals, pos, **kw,
                                        reps=reps)
        kernel_ms += cuda_ms(lambda: launch(bins, vals, pos, plan, **kw),
                             reps)
    log(f"phase {label} bound: one round's {len(sizes)} histograms of "
        f"{kernel} on this data move at least {sum(sizes) / 1e6:.1f} MB, "
        f"{bound_ms:.4f} ms at 3.35 TB/s; on the same inputs, launch by "
        f"launch: the kernel {kernel_ms:.4f} ms, index_add_ "
        f"{library_ms:.4f} ms a round")
    return bound_ms, library_ms, kernel_ms


def _round_scan_bound(xtt, dtrain, params, label):
    """K3's bound over one round on this data: each launch's histogram,
    totals and masks read once and its outputs written once, at 3.35
    TB/s, summed over the round's launches (the wrapper the split
    evaluation calls, counted)."""
    from xgboost_tpu_torch.ops import split as split_mod

    scan = split_mod.split_scan_cuda
    sizes = []

    def counted(hist, totals, *args, **kw):
        N = hist.shape[0]
        sizes.append(hist.numel() * hist.element_size()
                     + totals.numel() * 4 + N * 6 * 8)
        return scan(hist, totals, *args, **kw)

    split_mod.split_scan_cuda = counted
    try:
        xtt.train(params, dtrain, 1, verbose_eval=False)
    finally:
        split_mod.split_scan_cuda = scan
    bound_ms = sum(sizes) / HBM_BYTES_PER_S * 1e3
    log(f"phase {label} K3 bound: one round's {len(sizes)} scans read and "
        f"write at least {sum(sizes) / 1e6:.1f} MB, {bound_ms:.4f} ms at "
        "3.35 TB/s")
    return bound_ms


def phase_categorical(xtt, hist_cuda, rounds: int = 10):
    """The categorical slice at full width on both histogram paths."""
    X, y = make_criteo(1 << 20)
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y, feature_types=CRITEO_TYPES,
                         enable_categorical=True)
    ell = dtrain.ensure_ellpack(max_bin=128)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if ell.bins.dtype != torch.uint8:
        raise AssertionError(f"phase 7: bins are {ell.bins.dtype}, not uint8")
    out = {}
    for label, params, kernel in (("7", CRITEO, "hist_f32"),
                                  ("7 deterministic", CRITEO_DET,
                                   "hist_q")):
        r = _train_main_path(xtt, hist_cuda, params, dtrain, X.shape[0],
                             rounds, kernel, label,
                             auc_gate=CRITEO_AUC_GATE)
        n_cat = sum(len(t.categories or {}) for t in r["bst"].trees)
        if n_cat == 0:
            raise AssertionError(f"phase {label}: no categorical split")
        same = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
        if params is CRITEO_DET and not same:
            raise AssertionError(f"phase {label}: two deterministic runs "
                                 "wrote different models")
        log(f"phase {label} categorical train: {X.shape[0]} x 39 (13 "
            f"numeric, 26 categorical), depth 8, max_bin 128, {rounds} "
            f"rounds; ingest (device sketch + bins) {ingest_s:.3f} s; train "
            f"loop median {r['train_s']:.3f} s = {r['rate']:.3f} M "
            f"row-rounds/s (runs {r['times']} s); with eval "
            f"{r['with_eval_s']:.3f} s; logloss {r['logloss']:.6f} auc "
            f"{r['auc']:.6f} (gate {CRITEO_AUC_GATE}); {kernel} and K3 "
            f"launches {r['launches']} each, K4 {r['sigmoid_launches']}; "
            f"categorical splits {n_cat} of "
            f"{sum(int((t.left_children != -1).sum()) for t in r['bst'].trees)}"
            f"; two runs byte-identical: {same}")
        phase_profile(xtt, dtrain, params, f"{label} (categorical)")
        r["bound_ms"], r["library_ms"], _ = _round_hist_bound(
            xtt, hist_cuda, dtrain, params, kernel, label)
        out[kernel] = r
    bst = out["hist_f32"]["bst"]
    dtest = xtt.DMatrix(X[:100_000], feature_types=CRITEO_TYPES)
    pred = bst.predict(dtest)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "criteo.json")
        bst.save_model(path)
        again = xtt.Booster(model_file=path)
        if not np.array_equal(again.predict(dtest), pred) \
                or _model_bytes(again) != _model_bytes(bst):
            raise AssertionError("phase 7: the saved categorical model does "
                                 "not reload to the same predictions")
    log("phase 7 predict: 100000 rows; the JSON saved on the card reloads "
        "and predicts identically")
    return out


def phase_categorical_parity(xtt):
    """Card vs CPU on 20,000 rows of the Criteo-shaped generator."""
    X, y = make_criteo(20_000)
    det = CRITEO_DET
    dm = dict(feature_types=CRITEO_TYPES, enable_categorical=True)
    for onehot in (4, 128):
        _card_vs_cpu(xtt, dict(det, max_cat_to_onehot=onehot), X, y, 5,
                     1e-5, f"7b max_cat_to_onehot={onehot}", identical=True,
                     **dm)
    mono = "(" + ",".join(["1"] + ["0"] * 38) + ")"
    _card_vs_cpu(xtt, dict(det, monotone_constraints=mono), X, y, 5, 1e-5,
                 "7b monotone", identical=True, **dm)
    # the f32 path at depth 4, as phase 5: deeper, f32 sums in another
    # order (K1's atomics; on the CPU, the rows permuted) already grow
    # other trees, as categories of near-equal G/H swap places in the
    # partition's sort
    _card_vs_cpu(xtt, dict(CRITEO, max_depth=4), X, y, 5, 1e-4, "7b f32",
                 **dm)
    _card_vs_cpu(xtt, dict(CRITEO, grow_policy="lossguide", max_depth=0,
                           max_leaves=31), X, y, 3, 1e-4, "7b lossguide",
                 **dm)


# ------------------------------------------------------ multiclass, forest
COVER_CLASSES = 7
COVER = {"objective": "multi:softprob", "num_class": COVER_CLASSES,
         "max_depth": 8, "max_bin": 256, "eta": 0.3}
COVER_DET = dict(COVER, deterministic_histogram=1)
# the majority class errs 0.497 on this generator, the class of the
# noiseless score about 0.17 (the noise floor)
MERROR_GATE = 0.30


def make_covertype(n: int = 581_012, seed: int = 0):
    """The covertype_softprob rows of scripts/bench_ladder.py:88-90 and
    106-135 (numpy only): 54 columns N(0, 1) with 2% NaN, 7 classes cut
    from a noisy linear score's range (shares 0.0008 to 0.503)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 54)).astype(np.float32)
    X[rng.random((n, 54)) < 0.02] = np.nan
    lin = (np.nan_to_num(X[:, 0]) * 1.2 - np.nan_to_num(X[:, 1])
           + 0.5 * np.nan_to_num(X[:, 2]) * np.nan_to_num(X[:, 3]))
    z = lin + rng.normal(scale=0.5, size=n)
    y = np.clip(((z - z.min()) / (np.ptp(z) + 1e-9)
                 * COVER_CLASSES).astype(np.int64), 0, COVER_CLASSES - 1)
    return X, y.astype(np.float32)


def _tree_launches(hist_cuda, kernel, trees, depth, sigmoid=0):
    """Launch counts of a training whose trees all build ``depth`` levels:
    the histogram kernel and K3 once a level of each tree."""
    want = {name: 0 for name in hist_cuda.launches}
    want[kernel] = want["split_scan"] = trees * depth
    want["sigmoid"] = sigmoid
    return want


def phase_multiclass(xtt, hist_cuda, rounds: int = 5):
    """multi:softprob at full width, Covertype-shaped, on both histogram
    paths: 7 class trees a round, each of 8 levels, so K1/K2 and K3 launch
    56 times a round; no K4 (softmax, no sigmoid)."""
    X, y = make_covertype()
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    K, depth = COVER_CLASSES, COVER["max_depth"]
    out = {}
    for label, params, kernel in (("8", COVER, "hist_f32"),
                                  ("8 deterministic", COVER_DET, "hist_q")):
        r = _train_main_path(
            xtt, hist_cuda, params, dtrain, X.shape[0], rounds, kernel,
            label, metrics=("mlogloss", "merror"),
            want_fn=lambda evals: _tree_launches(
                hist_cuda, kernel, K * rounds, depth))
        merror = r["final"]["merror"]
        if not merror < MERROR_GATE:
            raise AssertionError(f"phase {label}: merror {merror} >= "
                                 f"{MERROR_GATE}")
        if len(r["bst"].trees) != K * rounds:
            raise AssertionError(f"phase {label}: {len(r['bst'].trees)} "
                                 f"trees, want {K * rounds}")
        same = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
        if params is COVER_DET and not same:
            raise AssertionError(f"phase {label}: two deterministic runs "
                                 "wrote different models")
        per_round = r["launches"] // rounds
        log(f"phase {label} multiclass train: {X.shape[0]} x 54, {K} "
            f"classes, depth {depth}, max_bin 256, {rounds} rounds; ingest "
            f"(device sketch + bins) {ingest_s:.3f} s; train loop median "
            f"{r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s, "
            f"{K * rounds / r['train_s']:.2f} trees/s, "
            f"{r['train_s'] / (K * rounds) * 1e3:.2f} ms a tree (runs "
            f"{r['times']} s); with eval {r['with_eval_s']:.3f} s; {kernel} "
            f"and K3 launches {per_round} and "
            f"{r['scan_launches'] // rounds} a round ({K} x {depth} levels), "
            f"K4 {r['sigmoid_launches']}; mlogloss "
            f"{r['final']['mlogloss']:.6f} merror {merror:.6f} (gate "
            f"{MERROR_GATE}); two runs byte-identical: {same}")
        phase_profile(xtt, dtrain, params, f"{label} (multiclass)")
        r["bound_ms"], r["library_ms"], r["kernel_ms"] = _round_hist_bound(
            xtt, hist_cuda, dtrain, params, kernel, label, reps=5)
        r["scan_bound_ms"] = _round_scan_bound(xtt, dtrain, params, label)
        out[kernel] = r
    bst = out["hist_q"]["bst"]
    dtest = xtt.DMatrix(X[:100_000])
    prob = bst.predict(dtest)
    if prob.shape != (dtest.num_row(), K) or not np.all(np.isfinite(prob)) \
            or np.abs(prob.sum(axis=1) - 1).max() > 1e-6:
        raise AssertionError(f"phase 8: predictions {prob.shape}, row sums "
                             f"off by {np.abs(prob.sum(axis=1) - 1).max()}")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for ext in ("json", "ubj"):
            path = os.path.join(tmp, f"cover.{ext}")
            bst.save_model(path)
            again = xtt.Booster(model_file=path)
            if not np.array_equal(again.predict(dtest), prob) \
                    or _model_bytes(again) != _model_bytes(bst):
                raise AssertionError(f"phase 8: the {ext} model does not "
                                     "reload to the same predictions")
    log(f"phase 8 predict: {dtest.num_row()} x {K} probabilities, rows sum "
        f"to 1 within "
        f"{np.abs(prob.sum(axis=1) - 1).max():.3g}; JSON and UBJ reload and "
        "predict identically")
    return out, X, y, dtrain


def _first_difference(got, ref, X=None):
    """(tree, node) of the first split where two boosters' trees differ,
    in training order and node order: another feature, a leaf against a
    split, or another threshold or default direction; None where they are
    the same.  A threshold alone changes the rows of every node under it
    and the numbering of the nodes after it, so a later node of the same
    id is no longer the same node.  With the training rows ``X``, a
    threshold or default direction that routes each of the node's rows as
    the other does (no value between the two thresholds, no missing
    value) splits them the same, and is no difference."""
    for t, (a, b) in enumerate(zip(got.trees, ref.trees)):
        n = min(a.n_nodes, b.n_nodes)
        hard = ((a.split_indices[:n] != b.split_indices[:n])
                | (a.left_children[:n] != b.left_children[:n]))
        soft = (a.left_children[:n] != -1) & ~hard & (
            (a.split_conditions[:n] != b.split_conditions[:n])
            | (a.default_left[:n] != b.default_left[:n]))
        d = np.nonzero(hard | soft)[0]
        if X is not None and soft[d].any():
            rows = _node_rows(b, X, int(d[-1]))
            d = [c for c in d if hard[c] or _routes_apart(a, b, c, X[rows[c]])]
        if len(d) or a.n_nodes != b.n_nodes:
            return t, int(d[0]) if len(d) else n
    return None


def _node_rows(tree, X, last):
    """The rows of X at each node of ``tree`` up to node ``last``."""
    rows = {0: np.arange(X.shape[0])}
    for n in range(min(last, tree.n_nodes - 1) + 1):
        left = int(tree.left_children[n])
        if left == -1 or n not in rows:
            continue
        r = rows[n]
        x = X[r, tree.split_indices[n]]
        go = np.where(np.isnan(x), bool(tree.default_left[n]),
                      x < tree.split_conditions[n])
        rows[left], rows[int(tree.right_children[n])] = r[go], r[~go]
    return rows


def _routes_apart(a, b, n, Xn):
    """Whether node ``n``'s splits in trees a and b (one feature) send any
    of the node's rows ``Xn`` to different sides."""
    x = Xn[:, a.split_indices[n]]
    miss = np.isnan(x)
    go_a = np.where(miss, bool(a.default_left[n]), x < a.split_conditions[n])
    go_b = np.where(miss, bool(b.default_left[n]), x < b.split_conditions[n])
    return bool((go_a != go_b).any())


def _same_or_near_tie(got, ref, label, per_round, pred_diff, atol, what,
                      X=None):
    """Two f32 models where a near tie may decide a split: the trees must
    be the same, and ``pred_diff()`` within ``atol``; or else the first
    split where they differ must be a tie within the noise of f32 sums in
    two orders.  That noise, delta, is the largest relative difference
    between the two models' gains of one and the same split, over the
    splits before the first difference whose gain is at least ``ref``'s
    there (a smaller gain's relative noise is inflated by the subtraction
    that forms it).  If ``got`` chose split a and ``ref`` split b, then
    gain_a >= gain_b in ``got`` and gain_b >= gain_a in ``ref``, so |got
    gain_a - ref gain_b| <= delta (relative); the check allows 2 delta.
    ``X``, the training rows, as ``_first_difference`` takes them.
    Returns the first difference, None where the trees are the same."""
    first = _first_difference(got, ref, X)
    if first is None:
        diff = pred_diff()
        if diff > atol:
            raise AssertionError(f"phase {label}: {what}: predictions "
                                 f"differ by {diff}")
        log(f"phase {label} parity: {what}, same trees, max |pred diff| "
            f"{diff:.3g}")
        return None
    gap, delta, n_same = _tie_gap(got, ref, first)
    t, node = first
    a, b = got.trees[t], ref.trees[t]
    log(f"phase {label} parity: {what}: the {t} trees before tree {t} "
        f"(round {t // per_round}) the same; it first differs at node "
        f"{node}: feature {a.split_indices[node]} threshold "
        f"{a.split_conditions[node]!r} gain {a.loss_changes[node]!r} "
        f"against feature {b.split_indices[node]} threshold "
        f"{b.split_conditions[node]!r} gain {b.loss_changes[node]!r}, a "
        f"relative gap of {gap:.3g} against the gains' noise {delta:.3g} "
        f"over {n_same} same splits before it of at least its gain")
    if not gap <= 2 * delta:
        raise AssertionError(f"phase {label}: {what}: different trees, not "
                             f"at a near tie (gap {gap:.3g}, noise "
                             f"{delta:.3g})")
    return first


def _tie_gap(got, ref, first):
    """At the first difference (tree, node): the relative gap between the
    two models' gains there, the noise delta of ``_same_or_near_tie`` and
    the number of same splits it is taken over."""
    t, node = first
    a, b = got.trees[t], ref.trees[t]
    floor = abs(float(b.loss_changes[node]))
    noise = []
    for i in range(t + 1):
        ta, tb = got.trees[i], ref.trees[i]
        same = np.arange(node if i == t else ta.n_nodes)
        ga, gb = (ta.loss_changes[same].astype(np.float64),
                  tb.loss_changes[same].astype(np.float64))
        keep = (ta.left_children[same] != -1) & (np.abs(gb) >= floor)
        noise.append(np.abs(ga - gb)[keep] / np.abs(gb)[keep])
    noise = np.concatenate(noise)
    delta = float(noise.max()) if len(noise) else 0.0
    gap = abs(float(a.loss_changes[node]) - float(b.loss_changes[node])) \
        / max(abs(float(b.loss_changes[node])), 1e-30)
    return gap, delta, len(noise)


def _card_vs_cpu_f32_tie(xtt, params, X, y, rounds, atol, label, **dm):
    """The f32 path card vs CPU where a near tie may decide a split
    (``_same_or_near_tie``).  Returns the card's booster."""
    d_card = xtt.DMatrix(X, label=y, **dm)
    d_cpu = xtt.DMatrix(X, label=y, device="cpu", **dm)
    got = xtt.train(params, d_card, rounds, verbose_eval=False)
    ref = xtt.train(params, d_cpu, rounds, verbose_eval=False, device="cpu")
    _same_or_near_tie(
        got, ref, label, got.trees_per_round,
        lambda: np.abs(got.predict(xtt.DMatrix(X)) - ref.predict(
            xtt.DMatrix(X, device="cpu"))).max(), atol,
        f"card vs CPU on {X.shape[0]} rows", X)
    return got


def phase_multiclass_parity(xtt, X, y):
    """Card vs CPU on 20,000 rows of the Covertype-shaped generator: under
    deterministic_histogram=1 at depth 6 byte-identical model JSON, plain
    and with row and column sampling and weights; the f32 path at depth 4
    the same trees.  Then one get_gradient at full width: its kernels and
    time."""
    from xgboost_tpu_torch.objective import create_objective

    Xs, ys = make_covertype(20_000, seed=3)
    w = np.random.default_rng(4).uniform(0.5, 2.0, len(ys)).astype(np.float32)
    det = dict(COVER_DET, max_depth=6)
    _card_vs_cpu(xtt, det, Xs, ys, 3, 1e-5, "8b", identical=True)
    _card_vs_cpu(xtt, dict(det, subsample=0.8, colsample_bynode=0.8, seed=9),
                 Xs, ys, 3, 1e-5, "8b sampled", identical=True, weight=w)
    _card_vs_cpu_f32_tie(xtt, dict(COVER, max_depth=4), Xs, ys, 3, 1e-4,
                         "8b f32")
    rng = np.random.default_rng(8)
    margin = torch.from_numpy(
        (rng.normal(size=(X.shape[0], COVER_CLASSES)) * 2).astype(
            np.float32)).cuda()
    labels = torch.from_numpy(y).cuda()
    obj = create_objective("multi:softprob", {"num_class": COVER_CLASSES})
    for _ in range(3):  # the profiler now and then sees no events at all
        dev_ms, n, kernels = device_per_call(
            lambda: obj.get_gradient(margin, labels, None))
        if n:
            break
    ms = cuda_ms(lambda: obj.get_gradient(margin, labels, None))
    # least bytes: margins and labels read once, the pairs written once
    bound_ms = (margin.numel() * 4 * 3 + labels.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    log(f"phase 8b gradient: one multiclass get_gradient at {X.shape[0]} x "
        f"{COVER_CLASSES} issues {n} kernels, {dev_ms} ms of device time; "
        f"{ms:.4f} ms a call (CUDA events, median of 20); bound "
        f"{bound_ms:.4f} ms at 3.35 TB/s")


FOREST = {"objective": "binary:logistic", "num_parallel_tree": 100,
          "subsample": 0.8, "colsample_bynode": 0.8, "eta": 1.0,
          "max_depth": 5, "max_bin": 256}


def phase_forest(xtt, hist_cuda, dtrain, y, repeats: int = 3):
    """A random forest as XGBoost's tutorial sets it (doc/tutorials/rf.rst):
    100 parallel trees in one round at full width; K1 and K3 launched 5
    times a tree, K4 once for the base score, once for the gradient and
    once for the evaluation; the AUC of its margins over 0.9 and over its
    first tree's alone."""
    trees, depth = FOREST["num_parallel_tree"], FOREST["max_depth"]
    hist_cuda.reset_launches()
    res: dict = {}
    bst = xtt.train(dict(FOREST, eval_metric=["logloss", "auc"]), dtrain, 1,
                    evals=[(dtrain, "train")], evals_result=res,
                    verbose_eval=False)
    torch.cuda.synchronize()
    want = _tree_launches(hist_cuda, "hist_f32", trees, depth, sigmoid=3)
    if hist_cuda.launches != want:
        raise AssertionError(f"phase 9: launches {hist_cuda.launches}, want "
                             f"{want}")
    if len(bst.trees) != trees or bst.num_boosted_rounds() != 1:
        raise AssertionError(f"phase 9: {len(bst.trees)} trees in "
                             f"{bst.num_boosted_rounds()} rounds")
    from xgboost_tpu_torch.metric import auc as auc_of

    # the reference adds each of the 100 trees at full eta, so margins
    # reach hundreds and many f32 probabilities round to 0 or 1, tied: the
    # forest's ranking is read from its margins; against its first tree
    # alone (num_parallel_tree=1 draws the same rows and columns for it)
    prob_auc = res["train"]["auc"][-1]
    margin = bst.predict(dtrain, output_margin=True)
    prob = bst.predict(dtrain)
    saturated = float(np.mean((prob == 0.0) | (prob == 1.0)))
    auc = auc_of(margin, y)
    first = xtt.train(dict(FOREST, num_parallel_tree=1), dtrain, 1,
                      verbose_eval=False)
    one_auc = auc_of(first.predict(dtrain, output_margin=True), y)
    if not (auc > 0.9 and auc > one_auc):
        raise AssertionError(f"phase 9: AUC of the margins {auc} (first tree "
                             f"alone {one_auc})")
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        xtt.train(FOREST, dtrain, 1, verbose_eval=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    log(f"phase 9 forest: {len(y)} x 28, num_parallel_tree={trees}, "
        f"subsample=0.8, colsample_bynode=0.8, eta=1, depth {depth}, one "
        f"round; K1 {want['hist_f32']} and K3 {want['split_scan']} "
        f"launches, K4 {want['sigmoid']}; logloss "
        f"{res['train']['logloss'][-1]:.6f}; auc of the margins {auc:.6f} "
        f"(its first tree alone {one_auc:.6f}), of the f32 probabilities "
        f"{prob_auc:.6f} (exactly 0 or 1 on {saturated:.4f} of the rows); "
        "the round median "
        f"{t:.3f} s (runs {' '.join(f'{x:.3f}' for x in times)}) = "
        f"{trees / t:.1f} trees/s")
    # the forest's histograms: device time by kernel over one round, the
    # bound and index_add_ on each of its 500 launches' inputs
    phase_profile(xtt, dtrain, FOREST, "9 (forest)", rounds=1)
    _round_hist_bound(xtt, hist_cuda, dtrain, FOREST, "hist_f32", "9",
                      reps=3)
    Xs, ys = make_data(20_000, 28, seed=3)
    _card_vs_cpu(xtt, dict(FOREST, num_parallel_tree=4, max_bin=64,
                           deterministic_histogram=1, seed=5), Xs, ys, 2,
                 1e-5, "9b", identical=True)


def _squared_error(margin, dmat):
    return margin - dmat.get_label(), np.ones_like(margin)


def phase_api(xtt, dtrain, X, y):
    """The training API on the card at phase 3's matrix under
    deterministic_histogram=1: continuation byte-identical to the
    uninterrupted run (from the Booster and from saved UBJ), a custom
    squared-error objective and boost() byte-identical to
    reg:squarederror, save_raw round trips, pred_leaf's leaves summed in
    predict's order equal to its margins bit for bit, and a custom metric
    in the log."""
    params = dict(DET, subsample=0.8, seed=11)
    full = xtt.train(params, dtrain, 10, verbose_eval=False)
    half = xtt.train(params, dtrain, 5, verbose_eval=False)
    forms = {"Booster": half, "UBJ": half.save_raw("ubj")}
    for form, model in forms.items():
        cont = xtt.train(params, dtrain, 5, verbose_eval=False,
                         xgb_model=model)
        if _model_bytes(cont) != _model_bytes(full):
            raise AssertionError(f"phase 10: 5 + 5 rounds from the {form} "
                                 "differ from 10 rounds")
    reg = dict(DET, objective="reg:squarederror")
    dreg = xtt.DMatrix(X, label=y.astype(np.float32))
    builtin = xtt.train(reg, dreg, 5, verbose_eval=False)
    pairs = []

    def recorded(margin, dmat):
        pairs.append(_squared_error(margin, dmat))
        return pairs[-1]

    custom = xtt.train(reg, dreg, 5, verbose_eval=False, obj=recorded)
    boosted = xtt.Booster(reg, cache=[dreg])
    for i, (g, h) in enumerate(pairs):
        boosted.boost(dreg, g, h, i)
    if not (_model_bytes(custom) == _model_bytes(builtin)
            == _model_bytes(boosted)):
        raise AssertionError("phase 10: the custom objective or boost() "
                             "grew another model than reg:squarederror")
    dtest = xtt.DMatrix(X[:100_000])
    back = xtt.Booster()
    back.load_model(full.save_raw("ubj"))
    if not np.array_equal(back.predict(dtest), full.predict(dtest)) \
            or _model_bytes(back) != _model_bytes(full):
        raise AssertionError("phase 10: save_raw('ubj') does not reload to "
                             "the same model")
    leaves = full.predict(dtest, pred_leaf=True)
    R = dtest.num_row()
    if leaves.shape != (R, 10) or leaves.dtype != np.int32:
        raise AssertionError(f"phase 10: pred_leaf {leaves.shape} "
                             f"{leaves.dtype}")
    margin = np.zeros(R, np.float32)
    for t, tree in enumerate(full.trees):
        margin += tree.split_conditions[leaves[:, t]]
    margin += full.base_score[0]
    want = full.predict(dtest, output_margin=True)
    if not np.array_equal(margin.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("phase 10: the leaves' values do not sum to "
                             "predict's margins")
    res: dict = {}

    def mae(margin, dmat):
        return "mae", float(np.mean(np.abs(margin[:, 0] - dmat.get_label())))

    xtt.train(reg, dreg, 2, evals=[(dreg, "train")], evals_result=res,
              verbose_eval=False, custom_metric=mae)
    if list(res["train"]) != ["rmse", "mae"]:
        raise AssertionError(f"phase 10: the log holds {list(res['train'])}")
    log("phase 10 API: under deterministic_histogram=1 at "
        f"{X.shape[0]} x 28, 5 + 5 rounds (from the Booster and from UBJ) "
        "byte-identical to 10; a custom squared-error objective and boost() "
        "byte-identical to reg:squarederror; save_raw('ubj') reloads to the "
        f"same predictions; pred_leaf {leaves.shape} int32, the leaves' "
        "values summed in tree order from zero, then the base margin, equal "
        "predict's margins bit for bit; custom metric in the log: mae "
        f"{res['train']['mae'][-1]:.6f}")


CSR_EXTRA, CSR_DENSITY = 228, 0.02
CSR_PARAMS = {"objective": "binary:logistic", "max_depth": 6,
              "max_bin": 256, "eta": 0.3}


def make_csr(X, seed: int = 12):
    """Phase 3's dense columns (any NaN left out: implicit missing) beside
    228 columns of N(0, 1) values stored at density 0.02, as one CSR
    matrix of 256 features."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = X.shape[0]
    k = rng.binomial(CSR_EXTRA, CSR_DENSITY, size=n)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, CSR_EXTRA, size=k.sum())  # a repeat is summed
    extra = sp.csr_matrix((rng.normal(size=k.sum()).astype(np.float32),
                           (rows, cols)), shape=(n, CSR_EXTRA))
    extra.sum_duplicates()
    dense = np.where(np.isnan(X), 0.0, X).astype(np.float32)
    m = sp.hstack([sp.csr_matrix(dense), extra], format="csr")
    m.eliminate_zeros()
    return m


def phase_csr(xtt, hist_cuda, X, y, rounds: int = 10):
    """CSR input at full width: the host sketch of the stored entries and
    the bins on the card timed apart, then the main path's training; K1
    and K3 launched 6 times a round."""
    from xgboost_tpu_torch.data.ellpack import build_ellpack_csr
    from xgboost_tpu_torch.data.quantile import sketch_csr

    m = make_csr(X)
    F = m.shape[1]
    arrays = (m.indptr, m.indices, m.data.astype(np.float32))
    t0 = time.perf_counter()
    cuts = sketch_csr(*arrays, F, 256)
    t1 = time.perf_counter()
    ell = build_ellpack_csr(*arrays, F, cuts, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dtrain = xtt.DMatrix(m, label=y)
    if not torch.equal(dtrain.ensure_ellpack(256).bins, ell.bins):
        raise AssertionError("phase 11: the DMatrix's bins are not the "
                             "entries' bins")
    r = _train_main_path(xtt, hist_cuda, CSR_PARAMS, dtrain, X.shape[0],
                         rounds, "hist_f32", "11")
    bin_bytes = ell.bins.numel() * ell.bins.element_size()
    log(f"phase 11 CSR train: {m.shape[0]} x {F} CSR ({m.nnz} stored, "
        f"{m.nnz / m.shape[0]:.1f} a row), depth 6, max_bin 256, {rounds} "
        f"rounds; ingest: host sketch {t1 - t0:.3f} s, bins on the card "
        f"{t2 - t1:.3f} s ({bin_bytes} bytes, {ell.bins.dtype}); train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s (runs "
        f"{r['times']} s); with eval {r['with_eval_s']:.3f} s; logloss "
        f"{r['logloss']:.6f} auc {r['auc']:.6f}; K1 and K3 launches "
        f"{r['launches']} each, K4 {r['sigmoid_launches']}")
    phase_profile(xtt, dtrain, CSR_PARAMS, "11 (CSR)")
    Xs, ys = make_data(20_000, 28, seed=3)
    _card_vs_cpu(xtt, dict(CSR_PARAMS, deterministic_histogram=1,
                           max_bin=64), make_csr(Xs), ys, 5, 1e-5, "11b",
                 identical=True)


# ------------------------------------------------------ K1's class axis
# (node0, n_nodes, stride): the root, a stride-2 level of 16 nodes and a
# node-tiled level of 128 nodes (the last level a depth-8 tree builds)
CLASS_LEVELS = ((0, 1, 1), (31, 16, 2), (255, 128, 2))
CLASS_SKEWED = (15, 8, 2)
# at the f64 cases the class axis may err at most this much more than K1's
# own launches on the same input: a cell sums no more rows in one block
K1_ERR_GATE = 1.5
# a node-tiled level, the left children of depth 7, held against an f64
# sum; scripts/node_tiled_error.py sets the reference's f32 error beside it
NODE_TILED = (127, 64, 2)


def node_tiled_level(seed: int = 22):
    """Covertype-shaped input (581,012 x 54, 256 bins, 7 classes, a pos
    per class) at NODE_TILED whose rows sit as a training's deep levels
    hold them: 90% of each class's rows in the level's first node, the
    rest over the level's 128 slots (left and right children), 2% missing
    bins.  Returns numpy (bins int16 (R, F), gpair f32 (R, K, 2), pos
    int32 (K, R))."""
    rng = np.random.default_rng(seed)
    R, F, K = 581_012, 54, 7
    node0, n_nodes, stride = NODE_TILED
    bins = rng.integers(0, 256, size=(R, F), dtype=np.int16)
    bins[rng.random((R, F)) < 0.02] = 256
    gpair = np.stack([rng.normal(size=(R, K)), rng.random((R, K))],
                     -1).astype(np.float32)
    pos = np.full((K, R), node0, np.int32)
    spread = rng.random((K, R)) >= 0.9
    pos[spread] = rng.integers(node0, node0 + stride * n_nodes,
                               size=int(spread.sum()))
    return bins, gpair, pos


def _index_add_multi_ms(bins, gpair, pos, shared, *, node0, n_nodes, n_bin,
                        stride):
    """The yardstick of a class-axis launch: one index_add_ over
    precomputed flat indices of every (row, feature, class) in its class's
    level, into the K classes' histograms at once."""
    R, F = bins.shape
    K = gpair.shape[1]
    pk = pos.expand(K, R) if shared else pos  # (K, R)
    local = pk.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = inl[:, :, None] & (bins.long() < n_bin)[None]  # (K, R, F)
    cls = torch.arange(K, device="cuda")[:, None, None]
    idx = (((cls * n_nodes + (local // stride)[:, :, None]) * F
            + torch.arange(F, device="cuda")[None, None, :]) * n_bin
           + bins.long()[None])
    vals = gpair.permute(1, 0, 2)[:, :, None, :].expand(K, R, F, 2)
    flat_idx, flat_val = idx[take], vals[take]
    flat = torch.zeros(K * n_nodes * F * n_bin, 2, device="cuda")
    return cuda_ms(lambda: flat.index_add_(0, flat_idx, flat_val), 10)


def _class_hist64(bins, gpair, pos, shared, *, node0, n_nodes, n_bin,
                  stride):
    """The class axis's histograms summed in f64 on the card, in the
    kernel's layout: (K, N, F, B, 2), or (N, F, B, K, 2) with ``shared``."""
    R, F = bins.shape
    K = gpair.shape[1]
    pk = pos.expand(K, R) if shared else pos
    out = torch.zeros((K, n_nodes * F * n_bin, 2), dtype=torch.float64,
                      device="cuda")
    feat = torch.arange(F, device="cuda")
    for k in range(K):
        local = pk[k].long() - node0
        ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
        take = ok[:, None] & (bins.long() < n_bin)
        idx = ((local // stride)[:, None] * F + feat[None]) * n_bin \
            + bins.long()
        vals = gpair[:, k].double()[:, None, :].expand(R, F, 2)
        out[k].index_add_(0, idx[take], vals[take])
    out = out.reshape(K, n_nodes, F, n_bin, 2)
    return out.permute(1, 2, 3, 0, 4) if shared else out


def _class_case(hist_cuda, bins, gpair, pos, shared, *, node0, n_nodes,
                n_bin, stride, rows="spread"):
    """One class-axis case: agreement with the plain version within 1e-5 of
    the largest cell (with ``rows="one node"``, most rows in one node as a
    training's levels hold them, with an f64 sum instead, beside K1's own
    error there); the kernel's time per call, batched and on the device
    per launch; K separate K1 launches; one index_add_ over the K classes;
    the plain version; the bound."""
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
    if shared:
        kernel, plain = (hist_cuda.build_level_hist_multi_cuda,
                         hist_cuda.build_level_hist_multi_plain)
    else:
        kernel, plain = (hist_cuda.build_histogram_multi_cuda,
                         hist_cuda.build_histogram_multi_plain)
    R, F = bins.shape
    K = gpair.shape[1]
    per_class = [gpair[:, k].contiguous() for k in range(K)]
    pos_k = [pos if shared else pos[k] for k in range(K)]
    got = kernel(bins, gpair, pos, **kw)
    torch.cuda.synchronize()
    k1_err = None
    if rows == "spread":
        want = plain(bins, gpair, pos, **kw)
    else:  # the plain version's own f32 atomics would hide the kernel's
        want = _class_hist64(bins, gpair, pos, shared, **kw)
        one = torch.stack([hist_cuda.build_histogram_cuda(
            bins, per_class[k], pos_k[k], **kw) for k in range(K)],
            dim=3 if shared else 0)
        k1_err = float((one.double() - want).abs().max().item())
        del one
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max().item())
    scale = float(want.abs().max().item())
    del got, want

    def singles():
        for k in range(K):
            hist_cuda.build_histogram_cuda(bins, per_class[k], pos_k[k], **kw)

    kernel_ms = cuda_ms(lambda: kernel(bins, gpair, pos, **kw))
    batched = batched_ms(lambda: kernel(bins, gpair, pos, **kw))
    for _ in range(3):  # the profiler now and then sees no events at all
        device_ms, _, _ = device_per_call(
            lambda: kernel(bins, gpair, pos, **kw), reps=10)
        if device_ms is not None:
            break
    singles_ms = cuda_ms(singles)
    plain_ms = cuda_ms(lambda: plain(bins, gpair, pos, **kw), reps=3)
    library_ms = _index_add_multi_ms(bins, gpair, pos, shared, **kw)
    # least work: pos of every row (K arrays, or one shared), the bins of
    # the rows in any class's level once, the gradients of the (row, class)
    # pairs in the level, the K histograms written once; two f32 adds per
    # (row, feature, class) present
    pk = pos.expand(K, R) if shared else pos
    local = pk.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    n_any = int(inl.any(dim=0).sum())
    n_pairs = int(inl.sum())
    present = (bins.long() < n_bin).sum(dim=1)  # (R,)
    n_adds = 2 * int((inl.to(torch.int64) * present[None]).sum())
    n_bytes = (4 * pos.numel() + n_any * F * bins.element_size()
               + n_pairs * 8 + K * n_nodes * F * n_bin * 8)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_adds / F32_FLOPS
    p = hist_cuda.planned_multi(bins, K, n_nodes, n_bin, stride, shared)
    plan = dict(FG=p.feat_group, NT=p.node_tile, KG=p.class_group,
                feats_per_warp=p.feats_per_warp, cell_row=p.cell_row,
                cluster=p.cluster, row_blocks=p.row_blocks,
                rows_per_block=p.rows_per_block, k1_rows=p.k1_rows,
                bucketed=p.bucketed)
    return dict(kernel="hist_f32_multi",
                layout="shared pos" if shared else "pos per class", K=K,
                R=R, F=F, node0=node0, n_nodes=n_nodes, stride=stride,
                rows=rows, max_abs_err=err, k1_max_abs_err=k1_err,
                max_rel_err=err / scale if scale else 0.0,
                ok=err <= HIST_RTOL * scale
                and (k1_err is None or err <= K1_ERR_GATE * k1_err),
                kernel_ms=kernel_ms,
                batched_ms=batched, device_ms=device_ms,
                k_single_launches_ms=singles_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                plan=plan)


def _ptxas_report(hist_cuda, name, phase="2f"):
    """ptxas's registers, spills and shared memory of each kernel of
    ``name``'s source (nvcc -Xptxas -v with the library's own flags, a
    cubin in the build directory)."""
    src = hist_cuda._src_path(name)
    out = os.path.join(hist_cuda._BUILD_DIR, f"ptxas_{name}.cubin")
    os.makedirs(hist_cuda._BUILD_DIR, exist_ok=True)
    r = subprocess.run(
        [hist_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", *hist_cuda.EXTRA_FLAGS.get(name, []),
         "-Xptxas", "-v", "-cubin", "-o", out, src],
        capture_output=True, text=True, check=True)
    kernel = None
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line or "spill" in line:
            log(f"phase {phase} ptxas {os.path.basename(src)} {kernel}: "
                f"{line.split(':', 1)[-1].strip()}")
    os.unlink(out)


def phase_class_axis(hist_cuda):
    """K1's class axis against its plain versions: the lockstep layout at
    Covertype's shapes (581,012 x 54, 256 bins, 7 classes, a different pos
    per class) and the vector-leaf layout at HIGGS shapes (1,048,576 x 28,
    256 bins, 3 targets, one pos), at the root, a 16-node stride-2 level
    and a 128-node node-tiled level; and at an 8-node stride-2 level whose
    rows sit 97% in one node, as a training's middle levels hold them,
    against an f64 sum (K1's single launches beside it); at that case and
    the node-tiled one the class axis errs at most K1_ERR_GATE times K1's
    own launches.  Prints ptxas's resources of csrc/hist_multi.cu and each
    case's plan."""
    _ptxas_report(hist_cuda, "hist_f32_multi")
    rng = np.random.default_rng(21)
    cases = []
    for (R, F, K, shared) in ((581_012, 54, 7, False),
                              (1 << 20, 28, 3, True)):
        b = rng.integers(0, 256, size=(R, F), dtype=np.int64)
        b[rng.random((R, F)) < 0.02] = 256  # missing -> sentinel
        bins = torch.from_numpy(b).to(torch.int16).cuda()
        del b
        g = np.stack([rng.normal(size=(R, K)), rng.random((R, K))], -1)
        gpair = torch.from_numpy(g.astype(np.float32)).cuda()
        for node0, n_nodes, stride in CLASS_LEVELS:
            shape = (R,) if shared else (K, R)
            p = rng.integers(node0, node0 + stride * n_nodes, size=shape)
            p[rng.random(shape) < 0.02] = -1  # pad rows
            pos = torch.from_numpy(p.astype(np.int32)).cuda()
            case = _class_case(hist_cuda, bins, gpair, pos, shared,
                               node0=node0, n_nodes=n_nodes, n_bin=256,
                               stride=stride)
            cases.append(case)
            log("phase 2f kernel vs plain: " + json.dumps(case))
        node0, n_nodes, stride = CLASS_SKEWED
        shape = (R,) if shared else (K, R)
        p = np.full(shape, node0)
        spread = rng.random(shape) < 0.03
        p[spread] = rng.integers(node0, node0 + stride * n_nodes,
                                 size=int(spread.sum()))
        pos = torch.from_numpy(p.astype(np.int32)).cuda()
        case = _class_case(hist_cuda, bins, gpair, pos, shared, node0=node0,
                           n_nodes=n_nodes, n_bin=256, stride=stride,
                           rows="one node")
        cases.append(case)
        log("phase 2f kernel vs f64: " + json.dumps(case))
        del bins, gpair, pos
    # the node-tiled level against an f64 sum (ROADMAP Queue 3 item 1)
    b, g, p = node_tiled_level()
    node0, n_nodes, stride = NODE_TILED
    case = _class_case(hist_cuda, torch.from_numpy(b).cuda(),
                       torch.from_numpy(g).cuda(),
                       torch.from_numpy(p).cuda(), False, node0=node0,
                       n_nodes=n_nodes, n_bin=256, stride=stride,
                       rows="node-tiled")
    cases.append(case)
    log("phase 2f node-tiled kernel vs f64: " + json.dumps(case))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"hist_f32_multi disagrees with its plain "
                             f"version, or errs more than {K1_ERR_GATE}x "
                             f"K1's own launches against f64: {bad}")
    for layout in ("pos per class", "shared pos"):
        main = [c for c in cases
                if c["layout"] == layout and c["rows"] == "spread"]
        if not main:
            continue
        log(f"phase 2f three-level sum ({layout}, K = {main[0]['K']}): "
            f"kernel {sum(c['kernel_ms'] for c in main):.4f} ms, K single "
            f"K1 launches {sum(c['k_single_launches_ms'] for c in main):.4f}"
            f" ms, index_add_ {sum(c['library_ms'] for c in main):.4f} ms, "
            f"plain {sum(c['plain_ms'] for c in main):.4f} ms, bound "
            f"{sum(c['bound_ms'] for c in main):.4f} ms")
    return cases


# ---------------------------------------------- lockstep, vector leaves
COVER_LOCKSTEP = dict(COVER, _lockstep=1)
COVER_VECTOR = dict(COVER, multi_strategy="multi_output_tree")
MAJORITY_MERROR = 0.497  # a majority guess on the Covertype generator


def phase_lockstep(xtt, hist_cuda, dtrain, seq, X, rounds: int = 5):
    """_lockstep=1 at full width on phase 8's data and parameters: the 7
    class trees of a round in one level loop, so K1's class axis and K3
    launch once a level (8 a round) and single-class K1 never; merror <
    0.30; the trees phase 8's sequential f32 trees, or a first difference
    at a near tie (8b's rule)."""
    K, depth = COVER_CLASSES, COVER["max_depth"]
    n_rows = dtrain.num_row()

    def want_fn(evals):
        want = {name: 0 for name in hist_cuda.launches}
        want["hist_f32_multi"] = want["split_scan"] = depth * rounds
        return want

    r = _train_main_path(xtt, hist_cuda, COVER_LOCKSTEP, dtrain, n_rows,
                         rounds, "hist_f32_multi", "12",
                         metrics=("mlogloss", "merror"), want_fn=want_fn)
    merror = r["final"]["merror"]
    if not merror < MERROR_GATE:
        raise AssertionError(f"phase 12: merror {merror} >= {MERROR_GATE}")
    if len(r["bst"].trees) != K * rounds:
        raise AssertionError(f"phase 12: {len(r['bst'].trees)} trees")
    # how far two sequential f32 runs of phase 8 are from each other (the
    # card's atomics add in no fixed order), for the reader: the gate is
    # 8b's rule between lockstep and sequential, whose noise also holds
    # the two kernels' fixed rounding (their plans cut the rows apart
    # differently), which two runs of one kernel do not show
    first = _first_difference(seq["timed"], seq["bst"], X)
    if first is None:
        log("phase 12 reference noise: phase 8's two sequential f32 runs "
            "grew the same trees")
    else:
        gap, delta, n_same = _tie_gap(seq["timed"], seq["bst"], first)
        log(f"phase 12 reference noise: phase 8's two sequential f32 runs "
            f"first differ at tree {first[0]} node {first[1]}: gains "
            f"{seq['timed'].trees[first[0]].loss_changes[first[1]]!r} and "
            f"{seq['bst'].trees[first[0]].loss_changes[first[1]]!r}, a "
            f"relative gap of {gap:.3g} against their noise {delta:.3g} "
            f"over {n_same} same splits")
    _same_or_near_tie(
        r["bst"], seq["bst"], "12", K,
        lambda: np.abs(r["bst"].predict(dtrain)
                       - seq["bst"].predict(dtrain)).max(), 1e-4,
        "lockstep vs phase 8's sequential f32 trees on the card", X)
    log(f"phase 12 lockstep train: {n_rows} x 54, {K} classes, depth "
        f"{depth}, {rounds} rounds, _lockstep=1; train loop median "
        f"{r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s, "
        f"{K * rounds / r['train_s']:.2f} trees/s, "
        f"{r['train_s'] / (K * rounds) * 1e3:.2f} ms a tree (runs "
        f"{r['times']} s; phase 8 sequential: {seq['train_s']:.3f} s, "
        f"{seq['train_s'] / (K * rounds) * 1e3:.2f} ms a tree); with eval "
        f"{r['with_eval_s']:.3f} s; class-axis K1 and K3 launches "
        f"{r['launches'] // rounds} and {r['scan_launches'] // rounds} a "
        f"round, single K1 0; mlogloss {r['final']['mlogloss']:.6f} merror "
        f"{merror:.6f} (gate {MERROR_GATE}; phase 8 "
        f"{seq['final']['merror']:.6f})")
    phase_profile(xtt, dtrain, COVER_LOCKSTEP, "12 (lockstep)")
    _round_hist_bound(xtt, hist_cuda, dtrain, COVER_LOCKSTEP,
                      "hist_f32_multi", "12", reps=5)
    levels = lockstep_level_errors(xtt, hist_cuda, dtrain)
    for row in levels:
        log("phase 12 level vs f64: " + json.dumps(row))
    worse = [(row["node0"], row["n_nodes"], row["stride"]) for row in levels
             if not row["class axis"]["max_abs"]
             <= K1_ERR_GATE * row["K single K1"]["max_abs"]]
    if worse:
        raise AssertionError(f"phase 12: the class axis errs more than "
                             f"{K1_ERR_GATE}x K1's single launches against "
                             f"f64 at levels {worse}")
    log(f"phase 12 level sums: class axis "
        f"{sum(x['class axis']['ms'] for x in levels):.4f} ms a round, K "
        f"single K1 {sum(x['K single K1']['ms'] for x in levels):.4f} ms; "
        f"largest cell error over K1's by level "
        + " ".join(f"{x['class axis']['max_abs'] / x['K single K1']['max_abs']:.3f}"
                   for x in levels))
    return r


def _hist_errors(h, ref):
    """The largest cell error of ``h`` against the f64 ``ref``, and the
    largest error of one (class, node, feature)'s sum over its bins (the
    totals a split's children carry)."""
    e = h.double() - ref
    return {"max_abs": e.abs().max().item(),
            "max_bin_sum": e.sum(dim=3).abs().max().item()}


def lockstep_level_errors(xtt, hist_cuda, dtrain, variants=()):
    """Every level of one lockstep round (phase 12's parameters on
    ``dtrain``), on that level's own inputs: the class axis with its
    planned launch and K single K1 launches against an f64 sum, each with
    its largest cell error, largest bin-summed error (``_hist_errors``)
    and time a call (``cuda_ms``).  ``variants``: (name, fn(plan, bins,
    level keywords) -> another plan of the class axis, or None), held and
    timed the same way."""
    import xgboost_tpu_torch.tree.grow_lockstep as gl

    rows = []
    orig = gl.build_histogram_multi

    def probe(bins, gpair, pos, *, node0, n_nodes, n_bin, stride=1):
        out = orig(bins, gpair, pos, node0=node0, n_nodes=n_nodes,
                   n_bin=n_bin, stride=stride)
        K = gpair.shape[1]
        kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
        ref = _class_hist64(bins, gpair, pos, False, **kw)
        cols = [gpair[:, k].contiguous() for k in range(K)]
        plan = hist_cuda.planned_multi(bins, K, n_nodes, n_bin, stride,
                                       False)

        def singles():
            return torch.stack([hist_cuda.build_histogram_cuda(
                bins, cols[k], pos[k], **kw) for k in range(K)])

        row = {"node0": node0, "n_nodes": n_nodes, "stride": stride,
               "largest_cell": ref.abs().max().item()}
        runs = [("class axis", plan), ("K single K1", None)]
        runs += [(name, fn(plan, bins, kw)) for name, fn in variants]
        for name, p in runs:
            if name != "K single K1" and p is None:
                continue
            fn = singles if p is None else (
                lambda p=p: hist_cuda.run_f32_multi(bins, gpair, pos, p,
                                                    **kw))
            row[name] = dict(_hist_errors(fn(), ref), ms=cuda_ms(fn),
                             plan=None if p is None else list(p))
        del ref
        rows.append(row)
        return out

    gl.build_histogram_multi = probe
    try:
        xtt.train(COVER_LOCKSTEP, dtrain, 1, verbose_eval=False)
    finally:
        gl.build_histogram_multi = orig
    return rows


def phase_lockstep_parity(xtt, hist_cuda):
    """Lockstep card vs CPU at 20,000 rows of the Covertype-shaped
    generator, depth 4: the same trees by 8b's rule; the card's run
    launched the class axis and K3 once a level."""
    Xs, ys = make_covertype(20_000, seed=3)
    hist_cuda.reset_launches()
    _card_vs_cpu_f32_tie(xtt, dict(COVER_LOCKSTEP, max_depth=4), Xs, ys, 3,
                         1e-4, "12b")
    if hist_cuda.launches["hist_f32_multi"] != 3 * 4 \
            or hist_cuda.launches["hist_f32"] != 0:
        raise AssertionError(f"phase 12b: launches {hist_cuda.launches}")


def _reload_check(xtt, bst, dtest, label):
    """JSON and UBJ reload to the same predictions and model."""
    pred = bst.predict(dtest)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for ext in ("json", "ubj"):
            path = os.path.join(tmp, f"model.{ext}")
            bst.save_model(path)
            again = xtt.Booster(model_file=path)
            if not np.array_equal(again.predict(dtest), pred) \
                    or _model_bytes(again) != _model_bytes(bst):
                raise AssertionError(f"phase {label}: the {ext} model does "
                                     "not reload to the same predictions")
    return pred


def phase_vector_leaf(xtt, hist_cuda, dtrain, seq, X, rounds: int = 5):
    """(a) multi_output_tree at full width on phase 8's data: one tree of
    7-vector leaves a round, K1's class axis launched in the shared-pos
    layout 8 times a round, probabilities that sum to 1 within 1e-6,
    merror below a majority guess's, JSON and UBJ reloads."""
    K, depth = COVER_CLASSES, COVER["max_depth"]
    n_rows = dtrain.num_row()

    def want_fn(evals):
        want = {name: 0 for name in hist_cuda.launches}
        want["hist_f32_multi"] = depth * rounds
        return want

    r = _train_main_path(xtt, hist_cuda, COVER_VECTOR, dtrain, n_rows,
                         rounds, "hist_f32_multi", "13",
                         metrics=("mlogloss", "merror"), want_fn=want_fn)
    bst = r["bst"]
    merror = r["final"]["merror"]
    if len(bst.trees) != rounds or bst.trees[0].n_targets != K:
        raise AssertionError(f"phase 13: {len(bst.trees)} trees of "
                             f"{bst.trees[0].n_targets} outputs")
    if not merror < MAJORITY_MERROR:
        raise AssertionError(f"phase 13: merror {merror} >= "
                             f"{MAJORITY_MERROR}")
    dtest = xtt.DMatrix(X[:100_000])
    prob = _reload_check(xtt, bst, dtest, "13")
    off = float(np.abs(prob.sum(axis=1) - 1).max())
    if prob.shape != (100_000, K) or not off <= 1e-6:
        raise AssertionError(f"phase 13: probabilities {prob.shape}, row "
                             f"sums off by {off}")
    log(f"phase 13 vector-leaf train: {n_rows} x 54, {K} classes, "
        f"multi_output_tree, depth {depth}, {rounds} rounds; train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s, "
        f"{rounds / r['train_s']:.2f} trees/s (runs {r['times']} s); with "
        f"eval {r['with_eval_s']:.3f} s; class-axis K1 launches "
        f"{r['launches'] // rounds} a round, K3 {r['scan_launches']}; "
        f"mlogloss {r['final']['mlogloss']:.6f} merror {merror:.6f} (a "
        f"majority guess {MAJORITY_MERROR}; phase 8 "
        f"{seq['final']['merror']:.6f}); rows sum to 1 within {off:.3g}; "
        "JSON and UBJ reload and predict identically")
    phase_profile(xtt, dtrain, COVER_VECTOR, "13 (vector leaves)")
    _round_hist_bound(xtt, hist_cuda, dtrain, COVER_VECTOR, "hist_f32_multi",
                      "13", reps=5)
    _multi_scan_cost()
    return r


def _multi_scan_cost():
    """The vector-leaf split scan (ops/split.py evaluate_splits_multi,
    PyTorch ops, no kernel of its own) at Covertype's widths, at the root
    and at a depth-8 tree's widest scanned level (128 nodes): the kernels
    one call issues, its device time and time a call, and the bound (the
    histogram read once)."""
    from xgboost_tpu_torch.ops.split import SplitParams, evaluate_splits_multi

    p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0,
                    alpha=0.0, max_delta_step=0.0)
    rng = torch.Generator(device="cuda").manual_seed(5)
    K, F, B = COVER_CLASSES, 54, 256
    n_bins = torch.full((F,), B, dtype=torch.int32, device="cuda")
    for N in (1, 128):
        g = torch.randn((N, F, B, K), generator=rng, device="cuda")
        h = torch.rand((N, F, B, K), generator=rng, device="cuda")
        hist = torch.stack([g, h], dim=-1)
        totals = hist.sum(dim=2)[:, 0] * 1.01
        fn = lambda: evaluate_splits_multi(hist, totals, n_bins, p)  # noqa
        for _ in range(3):  # the profiler now and then sees no events
            dev_ms, n, _ = device_per_call(fn, reps=5)
            if n:
                break
        ms = cuda_ms(fn, reps=5)
        bound = hist.numel() * 4 / HBM_BYTES_PER_S * 1e3
        log(f"phase 13 vector-leaf scan: N = {N} x {F} x {B} x {K}: {n} "
            f"kernels, {dev_ms} ms of device time, {ms:.4f} ms a call (CUDA "
            f"events, median of 5); bound {bound:.4f} ms at 3.35 TB/s")


def make_targets(X, k: int = 3, seed: int = 13):
    """k regression targets of the rows, as the reference's
    tests/test_multitarget.py:10-15 builds them: X W + 0.1 noise over 8
    features, here the rows' first 8 columns (the other 20 are features
    the trees must learn to leave alone).  Over all 28 columns the linear
    function is one that 10 rounds of depth 6 fit only to 0.49-0.60 of the
    baseline, in xgboost_tpu as in this port (scripts/multi_target_fit.py,
    50,000 rows on the CPU), so the reference test's gate would judge the
    model's capacity, not the port."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(8, k)).astype(np.float32)
    return (X[:, :8] @ W + 0.1 * rng.normal(size=(X.shape[0], k))).astype(
        np.float32)


MULTI_REG = {"objective": "reg:squarederror", "num_target": 3,
             "max_depth": 6, "max_bin": 256, "eta": 0.3}


def phase_multi_target(xtt, hist_cuda, X, rounds: int = 10):
    """(b) phase 3's 1M x 28 rows with 3 regression targets, depth 6, 10
    rounds, under both strategies: one tree per target (single K1 and K3
    18 a round) and vector leaves (the class axis 6 a round); rmse below
    half the baseline's; JSON and UBJ reloads."""
    Y = make_targets(X)
    base = float(np.sqrt(np.mean((Y - Y.mean(0)) ** 2)))
    dtrain = xtt.DMatrix(X, label=Y)
    depth, K = MULTI_REG["max_depth"], Y.shape[1]
    out = {}
    for strategy in ("one_output_per_tree", "multi_output_tree"):
        params = dict(MULTI_REG, multi_strategy=strategy)
        vector = strategy == "multi_output_tree"

        def want_fn(evals, vector=vector):
            want = {name: 0 for name in hist_cuda.launches}
            if vector:
                want["hist_f32_multi"] = depth * rounds
            else:
                want["hist_f32"] = want["split_scan"] = K * depth * rounds
            return want

        kernel = "hist_f32_multi" if vector else "hist_f32"
        r = _train_main_path(xtt, hist_cuda, params, dtrain, X.shape[0],
                             rounds, kernel, f"13 {strategy}",
                             metrics=("rmse",), want_fn=want_fn)
        rmse = r["final"]["rmse"]
        if not rmse < 0.5 * base:
            raise AssertionError(f"phase 13 {strategy}: rmse {rmse} >= half "
                                 f"the baseline's {base}")
        pred = _reload_check(xtt, r["bst"], xtt.DMatrix(X[:100_000]),
                             f"13 {strategy}")
        if pred.shape != (100_000, K):
            raise AssertionError(f"phase 13 {strategy}: {pred.shape}")
        log(f"phase 13 multi-target train: {X.shape[0]} x 28, {K} targets, "
            f"{strategy}, depth {depth}, {rounds} rounds; train loop median "
            f"{r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s, "
            f"{len(r['bst'].trees) / r['train_s']:.2f} trees/s (runs "
            f"{r['times']} s); {kernel} launches {r['launches'] // rounds} "
            f"a round, K3 {r['scan_launches'] // rounds}; rmse {rmse:.6f} "
            f"(baseline {base:.6f}, gate half of it); JSON and UBJ reload "
            "and predict identically")
        out[strategy] = r
    return out


def phase_vector_parity(xtt):
    """Vector leaves card vs CPU at 20,000 rows, depth 4: 3 regression
    targets and the Covertype-shaped softprob, the same trees by 8b's
    rule, predictions within 1e-4."""
    Xs, _ = make_data(20_000, 28, seed=3)
    _card_vs_cpu_f32_tie(
        xtt, dict(MULTI_REG, max_depth=4, multi_strategy="multi_output_tree"),
        Xs, make_targets(Xs), 5, 1e-4, "13b regression")
    Xc, yc = make_covertype(20_000, seed=3)
    _card_vs_cpu_f32_tie(xtt, dict(COVER_VECTOR, max_depth=4), Xc, yc, 3,
                         1e-4, "13b softprob")


# --------------------------- the rest of the pointwise objectives (14)
P14_BASE = {"max_depth": 6, "max_bin": 256, "eta": 0.3}
P14_ROUNDS = 10
# (objective, its parameters, target, train metric, gate): "half" the
# metric at most half the constant model's; "below" below it; "majority"
# hinge's error at most half a majority guess's; "coverage" each alpha's
# share of rows at or under its prediction within 0.1 of the alpha
P14 = [
    ("reg:absoluteerror", {}, "cont", "mae", "half"),
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}, "cont",
     "quantile", "coverage"),
    # at the default slope 1 the Newton steps diverge on this target (std
    # about 3) in xgboost_tpu and the port alike (scripts/
    # phase14_settings.py); 3 is about the target's scale
    ("reg:pseudohubererror", {"huber_slope": 3.0}, "cont", "mphe", "half"),
    ("count:poisson", {}, "count", "poisson-nloglik", "below"),
    ("reg:gamma", {}, "pos", "gamma-nloglik", "below"),
    ("reg:tweedie", {}, "pos", "tweedie-nloglik@1.5", "below"),
    ("reg:logistic", {}, "binary", "rmse", "below"),
    ("binary:hinge", {}, "binary", "error", "majority"),
    ("survival:aft", {}, "time", "aft-nloglik", "below"),
    # at a million rows Cox's leaf weights grow until the margins overflow
    # in xgboost_tpu and the port alike (scripts/phase14_settings.py);
    # max_delta_step bounds them
    ("survival:cox", {"max_delta_step": 0.7}, "cox", "cox-nloglik",
     "below"),
]
# phase 14b adds the objectives and options phase 14 leaves out
P14B_EXTRA = [
    ("reg:squaredlogerror", {}, "pos"),
    ("binary:logitraw", {}, "binary"),
    ("reg:expectileerror", {"expectile_alpha": [0.2, 0.8]}, "cont"),
    ("reg:absoluteerror", {"grow_policy": "lossguide"}, "cont"),
    ("reg:quantileerror", {"quantile_alpha": [0.3, 0.7],
                           "grow_policy": "lossguide", "max_leaves": 12},
     "cont"),
    ("survival:aft", {"aft_loss_distribution": "logistic",
                      "aft_loss_distribution_scale": 0.8}, "time"),
    ("survival:aft", {"aft_loss_distribution": "extreme"}, "time"),
]


def make_pointwise_targets(X, y, seed: int = 14):
    """Targets of the HIGGS rows for phase 14: the continuous one is phase
    13b's first target (X[:, :8] W + 0.1 noise); z is it standardised;
    Poisson counts and gamma values (shape 2) of mean exp(0.3 z); the
    binary label; survival times exp(z / 2 + 0.3 noise), half of them
    uncensored, a quarter right-censored (upper bound +inf) and a quarter
    interval-censored ([0.7 t, 1.5 t]); Cox's labels the same times, a
    right-censored one negative."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    cont = make_targets(X)[:, 0]
    z = (cont - cont.mean()) / cont.std()
    mu = np.exp(0.3 * z)
    t = np.exp(z / 2 + 0.3 * rng.normal(size=n)).astype(np.float32)
    kind = rng.random(n)
    right, interval = (kind >= 0.5) & (kind < 0.75), kind >= 0.75
    lower, upper = t.copy(), t.copy()
    upper[right] = np.inf
    lower[interval] = (0.7 * t[interval]).astype(np.float32)
    upper[interval] = (1.5 * t[interval]).astype(np.float32)
    return dict(cont=cont, count=rng.poisson(mu).astype(np.float32),
                pos=rng.gamma(2.0, mu / 2.0).astype(np.float32),
                binary=y, time=t, lower=lower, upper=upper,
                cox=np.where(right, -t, t).astype(np.float32))


def _p14_set_target(dmat, T, target, name):
    """The DMatrix's label for ``target``, and AFT's bounds only for AFT."""
    dmat.set_label(T[target])
    aft = name == "survival:aft"
    dmat.label_lower_bound = T["lower"] if aft else None
    dmat.label_upper_bound = T["upper"] if aft else None


def _p14_gate(xtt, bst, dmat, T, name, target, metric, gate, final):
    """The gate of one phase 14 objective on its final train metric;
    returns (the constant model's metric, what the gate compared)."""
    from xgboost_tpu_torch.metric import create_metric

    y = T[target]
    if gate == "majority":
        majority = float(min(y.mean(), 1 - y.mean()))
        ok = final <= 0.5 * majority
        return dict(ok=ok, metric=final, majority_error=majority)
    if gate == "coverage":
        pred = bst.predict(dmat)
        alphas = bst.objective._alphas()
        shares = [float((y <= pred[:, k]).mean()) for k in range(len(alphas))]
        ok = all(abs(sh - a) <= 0.1 for sh, a in zip(shares, alphas))
        return dict(ok=ok, metric=final, alphas=alphas, shares=shares)
    K = bst.n_groups
    base = torch.tensor(np.asarray(bst.base_score, np.float32))
    const = bst.objective.pred_transform(base.expand(len(y), K)).numpy()
    fn, _ = create_metric(metric)
    c = fn(const[:, 0] if K == 1 else const, y, None,
           **bst._metric_kwargs(dmat))
    ok = final <= 0.5 * c if gate == "half" else final < c
    return dict(ok=ok, metric=final, constant=c, ratio=final / c)


def _p14_want(hist_cuda, name, K, depth, rounds):
    def want_fn(evals):
        if name == "reg:logistic":  # K4 as binary:logistic: base, rounds
            want = _sigmoid_launches(hist_cuda, rounds, evals=evals)
        else:
            want = {k: 0 for k in hist_cuda.launches}
        want["hist_f32"] = want["split_scan"] = K * depth * rounds
        return want
    return want_fn


def phase_pointwise(xtt, hist_cuda, rounds: int = P14_ROUNDS):
    """Each pointwise objective of this slice at full width: the HIGGS rows
    (make_data, 1,048,576 x 28, max_bin 256, depth 6, eta 0.3) with the
    targets of make_pointwise_targets; the train loop timed as phase 3
    (median of 3; K1 and K3 launched depth x K a round, K4 once a round
    for reg:logistic); its final train metric against the constant
    model's, gated (P14).  Then reg:logistic's gradient is one K4 launch,
    two rounds of reg:absoluteerror profiled, and one refit and one
    survival gradient of each kind timed on the device, none copying to
    the host."""
    X, y = make_data(1 << 20, 28)
    T = make_pointwise_targets(X, y)
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)
    depth, R = P14_BASE["max_depth"], X.shape[0]
    out = {}
    for name, extra, target, metric, gate in P14:
        params = dict(P14_BASE, objective=name, **extra)
        _p14_set_target(dtrain, T, target, name)
        K = len(extra.get("quantile_alpha", [0]))
        label = f"14 {name}"
        r = _train_main_path(xtt, hist_cuda, params, dtrain, R, rounds,
                             "hist_f32", label, metrics=(metric,),
                             want_fn=_p14_want(hist_cuda, name, K, depth,
                                               rounds))
        g = _p14_gate(xtt, r["bst"], dtrain, T, name, target, metric, gate,
                      r["final"][metric])
        trees = (f", {K * rounds / r['train_s']:.2f} trees/s"
                 if K > 1 else "")
        log(f"phase {label}: {R} x 28, depth {depth}, {rounds} rounds; "
            f"train loop median {r['train_s']:.3f} s = {r['rate']:.3f} M "
            f"row-rounds/s{trees} (runs {r['times']} s); with eval "
            f"{r['with_eval_s']:.3f} s; K1 and K3 launches "
            f"{r['launches'] // rounds} a round, K4 {r['sigmoid_launches']}"
            f"; gate {gate}: " + json.dumps(g))
        if not g["ok"]:
            raise AssertionError(f"phase {label}: gate {gate} failed: {g}")
        out[name] = dict(r, gate=g)
    _p14_set_target(dtrain, T, "cont", "reg:absoluteerror")
    phase_gradient_profile(xtt, hist_cuda, "reg:logistic", "14")
    phase_profile(xtt, dtrain, dict(P14_BASE, objective="reg:absoluteerror"),
                  "14 (reg:absoluteerror)")
    _p14_device_costs(T)
    return out


def _no_host_copy(ops, kernels, what):
    """None of the captured operations (graph_ops) and none of the
    profiled kernels copies to the host."""
    back = [op for op in ops if op == ("memcpy", "host")]
    back += [k for k in kernels if "DtoH" in k or "Device -> Pageable" in k]
    if back:
        raise AssertionError(f"phase 14: {what} copies to the host: {back}")


def _p14_device_costs(T):
    """Device time and kernels of one refit (depth 6: 64 leaves at heap
    slots 63-126, alpha 0.5) and of one AFT (normal) and one Cox gradient
    at 1,048,576 rows: the operations each puts on the stream (graph_ops)
    and its device time (torch.profiler); none may copy to the host."""
    from xgboost_tpu_torch.objective import create_objective
    from xgboost_tpu_torch.ops.adaptive import segment_quantile_leaf

    R = len(T["cont"])
    rng = np.random.default_rng(15)
    pos = torch.from_numpy(rng.integers(63, 127, R).astype(np.int32)).cuda()
    res = torch.from_numpy(T["cont"]).cuda()
    valid = torch.ones(R, dtype=torch.bool, device="cuda")
    leaf = torch.zeros(127, dtype=torch.bool, device="cuda")
    leaf[63:] = True
    margin = torch.from_numpy(rng.normal(size=(R, 1)).astype(
        np.float32)).cuda()
    aft = create_objective("survival:aft", {})
    aft.set_bounds(torch.from_numpy(T["lower"]).cuda(),
                   torch.from_numpy(T["upper"]).cuda())
    cox = create_objective("survival:cox", {})
    t = torch.from_numpy(T["time"]).cuda()
    ycox = torch.from_numpy(T["cox"]).cuda()
    calls = {
        "refit": lambda: segment_quantile_leaf(pos, res, valid, leaf, 0.5,
                                               0.3, max_nodes=127),
        "survival:aft gradient": lambda: aft.get_gradient(margin, t, None),
        "survival:cox gradient": lambda: cox.get_gradient(margin, ycox,
                                                          None),
    }
    for what, fn in calls.items():
        ops = graph_ops(fn)
        counts: dict = {}
        for kind, detail in ops:
            key = f"memcpy to {detail}" if kind == "memcpy" else kind
            counts[key] = counts.get(key, 0) + 1
        for _ in range(3):  # the profiler now and then sees no events
            ms, n, kernels = device_per_call(fn, reps=5)
            if n:
                break
        _no_host_copy(ops, kernels, what)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        timing = (f"{ms} ms of device time a call; most launched: {top}"
                  if n else "device time not measured (the profiler saw "
                  "no events)")
        log(f"phase 14 {what}: {R} rows, {len(ops)} operations on the "
            f"stream {counts}, no copy to the host; {timing}")


def phase_pointwise_parity(xtt):
    """Every objective of this slice card vs CPU at 20,000 rows, depth 4,
    5 rounds: under deterministic_histogram=1 byte-identical model JSON
    (best-first, which has no deterministic path, aside); the f32 path the
    same trees up to a near tie (8b's rule), the margins within 1e-4 of
    the largest (at least 1): these targets' margins reach several units,
    and a leaf's f32 sums in two orders scale with them."""
    Xs, ys = make_data(20_000, 28, seed=3)
    T = make_pointwise_targets(Xs, ys)
    runs = [(n, e, t) for n, e, t, _, _ in P14] + P14B_EXTRA
    for name, extra, target in runs:
        params = dict(P14_BASE, objective=name, max_depth=4, **extra)
        dm = {}
        if name == "survival:aft":
            dm = dict(label_lower_bound=T["lower"],
                      label_upper_bound=T["upper"])
        what = f"14b {name} {json.dumps(extra)}"
        if "max_leaves" not in extra:
            _card_vs_cpu(xtt, dict(params, deterministic_histogram=1), Xs,
                         T[target], 5, 1e-5, what + " deterministic",
                         identical=True, **dm)
        got = xtt.train(params, xtt.DMatrix(Xs, label=T[target], **dm), 5,
                        verbose_eval=False)
        ref = xtt.train(params, xtt.DMatrix(Xs, label=T[target],
                                            device="cpu", **dm),
                        5, verbose_eval=False, device="cpu")

        def margin_diff(got=got, ref=ref):
            a = got.predict(xtt.DMatrix(Xs), output_margin=True)
            b = ref.predict(xtt.DMatrix(Xs, device="cpu"),
                            output_margin=True)
            return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

        _same_or_near_tie(got, ref, what + " f32", got.trees_per_round,
                          margin_diff, 1e-4,
                          f"card vs CPU on {Xs.shape[0]} rows, margins "
                          "relative to the largest", Xs)


# ------------------------------------------------- learning to rank (15)
# f64 outside the tensor cores on an H100 SXM (NVIDIA's data sheet): K5's
# glibc expf is double arithmetic
F64_FLOPS = 34e12
# f64 operations of one glibc expf (five fused multiply-adds at two each,
# and five other double operations), and K5's f32 operations a pair
EXPF_F64_OPS = 15
PAIR_F32_OPS = 15
# the mslr_ndcg configuration of scripts/bench_ladder.py:91-94 (MSLR-WEB30K
# shaped: 31,531 queries of 40-199 docs, 136 features, graded 0-4)
MSLR_GROUPS = 31_531
MSLR_PARAMS = {"objective": "rank:ndcg", "max_depth": 8, "eta": 0.3,
               "max_bin": 256}
P15_ROUNDS = 5
LIBM_SAMPLE = 1 << 24  # phase 2g's f32 inputs of utils/libm, card vs CPU


def make_mslr(groups: int = MSLR_GROUPS, seed: int = 0, cols: int = 136):
    """The ranking data of scripts/bench_ladder.py:136-143: query sizes
    uniform in [40, 200), N(0, 1) features, relevance clip(int(x0 + 0.5
    noise + 2), 0, 4); then 2% of the features missing.  Float32 draws
    (the ladder draws float64), made in bulk."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 200, size=groups)
    R = int(sizes.sum())
    X = rng.standard_normal(size=(R, cols), dtype=np.float32)
    rel = np.clip((X[:, 0] + 0.5 * rng.standard_normal(R, dtype=np.float32)
                   + 2.0).astype(np.int64), 0, 4).astype(np.float32)
    X[rng.random((R, cols), dtype=np.float32) < 0.02] = np.nan
    return X, rel, sizes.astype(np.int64)


def _lambdarank_work(s, y, layout, k):
    """The pairs K5 computes on these inputs (top-k pairs of distinct
    gains, which for these labels are distinct labels) and the bound of
    one launch: (pairs, bytes, bound ms, what bounds it).  Bytes: scores,
    labels and the two orders read once, the (grad, hess) pairs written
    once (24 bytes a grouped row), the group pointer and the disc table."""
    from xgboost_tpu_torch.ops.lambdarank_cuda import sorted_order

    G, S, r_g = layout.G, layout.S, layout.r_g
    y_srt = y[:r_g][sorted_order(s[:r_g], layout.gid)]
    labels, code = torch.unique(y_srt, return_inverse=True)
    onehot = torch.zeros((G, S + 1, len(labels)), dtype=torch.int32,
                         device=s.device)
    onehot[:, :S][layout.vpos] = torch.nn.functional.one_hot(
        code, len(labels)).to(torch.int32)
    # suffix counts of each label from position p on
    suffix = onehot.flip(1).cumsum(1).flip(1)
    pos = torch.arange(S, device=s.device)
    kk = torch.clamp(layout.sizes, max=k)
    top = (pos[None, :] < kk[:, None]) & layout.vpos
    after = (layout.sizes[:, None] - pos[None, :] - 1).clamp(min=0)
    lab = torch.zeros((G, S), dtype=torch.int64, device=s.device)
    lab[layout.vpos] = code
    same = suffix[:, 1:].gather(2, lab[:, :, None])[:, :, 0]
    pairs = int(torch.where(top, after - same, 0).sum())
    nbytes = 24 * r_g + 4 * (G + 1) + 4 * S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * (EXPF_F64_OPS / F64_FLOPS + PAIR_F32_OPS / F32_FLOPS)
    return (pairs, nbytes, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _p2g_cases():
    """(name, group sizes, score kind, k, ndcg weight, score norm, group
    norm) of phase 2g."""
    rng = np.random.default_rng(20)
    mslr = rng.integers(40, 200, size=MSLR_GROUPS)
    return [
        ("mslr", mslr, "normal", 32, True, True, True),
        ("20k_groups", np.array([20_000, 20_000, 150]), "normal", 32, True,
         True, True),
        ("sizes_1_2", np.tile([1, 2, 1, 2, 7], 2000), "normal", 32, True,
         True, True),
        ("tied", mslr[:4000], "tied", 32, True, True, True),
        ("all_equal", mslr[:4000], "zero", 32, True, True, True),
        ("k_above_n", mslr[:4000], "normal", 256, True, True, True),
        ("no_score_norm", mslr[:4000], "normal", 32, True, False, True),
        ("no_group_norm", mslr[:4000], "normal", 32, True, True, False),
        ("pairwise", mslr[:4000], "normal", 32, False, True, True),
        ("nan_scores", mslr[:4000], "nan", 32, True, True, True),
        ("signed_zero", mslr[:4000], "signed_zero", 32, True, True, True),
        ("at_cap", np.tile([256, 199, 40], 400), "normal", 32, True, True,
         True),
        ("above_cap", np.tile([257, 120], 200), "normal", 32, True, True,
         True),
        ("mixed", np.concatenate([mslr[:2000], [300], mslr[2000:4000]]),
         "normal", 32, True, True, True),
        ("k_1", mslr[:4000], "normal", 1, True, True, True),
    ]


def _k5_plan(hist_cuda, layout):
    """K5's launch for ``layout``: (bundles, the most docs of a bundle,
    large groups, dynamic shared memory bytes, blocks an SM, query groups
    resident an SM at the mean bundle)."""
    t = layout.kernel_tables
    lib = hist_cuda.load_library("lambdarank")
    nbytes, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.xtb_lambdarank_plan(t.bundle_docs, t.max_n, t.n_bundles,
                                 t.n_big, ctypes.byref(nbytes),
                                 ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("phase 2g: K5's occupancy query failed: "
                           + lib.xtb_cuda_error_string(rc).decode())
    per = len(t.bgroups) / max(t.n_bundles, 1)
    return (t.n_bundles, t.bundle_docs, t.n_big, nbytes.value,
            blocks.value, blocks.value * per)


def k5_device_ms(fn, reps: int = 5):
    """torch.profiler over ``reps`` calls of ``fn``, each one K5 launch:
    (device ms a call, K5's device ms a launch, {kernel: launches a
    call}), both over the K5 launches the profiler saw (it may miss a
    call's events); (None, None, {}) where it saw no K5 launch in three
    tries (not measured)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = k5_us = 0.0
        k5_n = 0
        kernels: dict = {}
        for r in prof.key_averages():
            if r.device_type != DeviceType.CUDA:
                continue
            t = getattr(r, "self_device_time_total", None)
            us = r.self_cuda_time_total if t is None else t
            total += us
            kernels[r.key[:60]] = kernels.get(r.key[:60], 0) + r.count
            if "lambdarank" in r.key:
                k5_us += us
                k5_n += r.count
        if k5_n:
            return (total / 1e3 / k5_n, k5_us / 1e3 / k5_n,
                    {k: round(n / k5_n, 2) for k, n in kernels.items()})
    return None, None, {}


def phase_lambdarank(hist_cuda):
    """K5 (csrc/lambdarank.cu) against lambdarank_topk_plain on the card,
    bitwise in grad and hess, at the MSLR shape and the other cases of
    _p2g_cases, each one launch on the path it must take (the sorts in the
    kernel where every group fits K5's cap, else the wrapper's); ptxas's
    report and K5's launch (bundles, shared memory, blocks and groups an
    SM); utils/libm's expf, exp2f and log2f on the card against the same
    code on the CPU, bitwise, over 2^24 sampled inputs.  Timings of the
    kernel (CUDA events a call, whatever the wrapper does included; device
    time a call and K5's a launch) and the plain version, and the
    bound."""
    from xgboost_tpu_torch.ops import lambdarank_cuda as lr
    from xgboost_tpu_torch.ops.lambdarank_cuda import (
        GroupLayout, lambdarank_topk_cuda, lambdarank_topk_plain)
    from xgboost_tpu_torch.utils import libm

    _ptxas_report(hist_cuda, "lambdarank", "2g")

    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2**32, LIBM_SAMPLE, dtype=np.uint64).astype(
        np.uint32)
    x_cpu = torch.from_numpy(bits.view(np.float32))
    x_card = x_cpu.cuda()
    for name in ("expf", "exp2f", "log2f"):
        fn = getattr(libm, name)
        same = _same_bits(fn(x_card).cpu(), fn(x_cpu))
        log(f"phase 2g libm {name}: card vs CPU over {LIBM_SAMPLE} sampled "
            f"f32 inputs bitwise: {same}")
        if not same:
            raise AssertionError(f"phase 2g: utils/libm {name} differs "
                                 "card vs CPU")
    cases = []
    for name, sizes, scores, k, nd, sn, gn in _p2g_cases():
        gp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        R = int(gp[-1]) + 1000  # rows past the last group stay (0, 0)
        s = rng.normal(size=R).astype(np.float32)
        if scores == "tied":
            s = np.round(2 * s).astype(np.float32)
            s[::7] = -0.0
        elif scores == "zero":
            s[:] = 0.0
        elif scores == "nan":
            s[::11] = np.nan
        elif scores == "signed_zero":
            s = np.where(rng.random(R) < 0.5, -0.0, 0.0).astype(np.float32)
        y = rng.integers(0, 5, R).astype(np.float32)
        s_card, y_card = torch.from_numpy(s).cuda(), torch.from_numpy(y).cuda()
        layout = GroupLayout(gp, "cuda")
        args = (layout, k, nd, sn, gn)
        in_kernel = int(max(sizes)) <= lr.CAP
        before = hist_cuda.launches["lambdarank"]
        got = lambdarank_topk_cuda(s_card, y_card, *args)
        launched = hist_cuda.launches["lambdarank"] - before
        if launched != 1 or layout.sorts_in_kernel != in_kernel:
            raise AssertionError(
                f"phase 2g {name}: {launched} launch(es), sorts in the "
                f"{'kernel' if layout.sorts_in_kernel else 'wrapper'}, "
                f"want one launch sorting in the "
                f"{'kernel' if in_kernel else 'wrapper'}")
        bundles, bdocs, n_big, smem, blocks, resident = _k5_plan(
            hist_cuda, layout)
        t0 = time.perf_counter()
        want = lambdarank_topk_plain(s_card, y_card, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bitwise = _same_bits(got.cpu(), want.cpu())
        pairs, nbytes, bound_ms, bound_by = _lambdarank_work(
            s_card, y_card, layout, k)
        call_ms, launch_ms, call_kernels = k5_device_ms(
            lambda: lambdarank_topk_cuda(s_card, y_card, *args))
        diff = (got - want).abs()
        case = dict(case=name, groups=len(sizes), rows=int(gp[-1]),
                    largest=int(max(sizes)), k=k, ndcg_weight=nd,
                    score_norm=sn, group_norm=gn, pairs=pairs,
                    bitwise=bitwise, sorts="kernel" if in_kernel
                    else "wrapper", bundles=bundles, bundle_docs=bdocs,
                    large_groups=n_big, smem_bytes=smem,
                    blocks_per_sm=blocks, groups_per_sm=resident,
                    max_abs_err=float(diff[~torch.isnan(diff)].max()),
                    kernel_ms=cuda_ms(lambda: lambdarank_topk_cuda(
                        s_card, y_card, *args), reps=10),
                    device_ms=call_ms, launch_ms=launch_ms,
                    call_kernels=call_kernels,
                    plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)
        log("phase 2g kernel vs plain: " + json.dumps(case))
        cases.append(case)
    bad = [c["case"] for c in cases if not c["bitwise"]]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")
    return cases


def _p15_want(hist_cuda, depth, rounds, pair_method):
    def want_fn(evals):
        want = {k: 0 for k in hist_cuda.launches}
        want["hist_f32"] = want["split_scan"] = depth * rounds
        if pair_method == "topk":  # the base score's gradient, then rounds
            want["lambdarank"] = 1 + rounds
        return want
    return want_fn


def _rank_constant(bst, dmat, y, metric):
    """``metric`` of the constant model (every doc its base margin)."""
    from xgboost_tpu_torch.metric import create_metric

    fn, _ = create_metric(metric)
    const = np.full(len(y), np.float32(bst.base_score[0]))
    return fn(const, y, None, **bst._metric_kwargs(dmat))


def phase_ranking(xtt, hist_cuda, rounds: int = P15_ROUNDS):
    """rank:ndcg at full width: MSLR-shaped 31,531 queries (make_mslr,
    about 3.77M x 136), depth 8, eta 0.3, max_bin 256, ndcg@10 on the
    training set; the train loop timed as phase 3 (median of 3; K1 and K3
    launched 8 times a round, K5 once a round and once for the base
    score); the final ndcg@10 gated above the constant model's; one
    get_gradient's operations (graph_ops: no copy to the host) and K5's
    device time; two rounds profiled.  Then rank:pairwise and rank:map
    with their default metric, and lambdarank_pair_method="mean", once
    each."""
    t0 = time.perf_counter()
    X, y, sizes = make_mslr()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y, group=sizes)
    ell = dtrain.ensure_ellpack(max_bin=256)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    R, F = X.shape
    del X
    log(f"phase 15 data: {len(sizes)} queries, {R} x {F} rows (made in "
        f"{gen_s:.3f} s); ingest (device sketch + bins) {ingest_s:.3f} s; "
        f"bins {ell.bins.dtype} {ell.bins.numel() * ell.bins.element_size()}"
        f" bytes")
    depth = MSLR_PARAMS["max_depth"]
    out = {}
    runs = [("rank:ndcg", {}, ("ndcg@10",), 3),
            ("rank:pairwise", {}, ("map",), 1),
            ("rank:map", {}, ("map",), 1),
            ("rank:ndcg", {"lambdarank_pair_method": "mean"}, ("ndcg@10",),
             1)]
    for name, extra, metrics, repeats in runs:
        params = dict(MSLR_PARAMS, objective=name, **extra)
        pm = extra.get("lambdarank_pair_method", "topk")
        label = f"15 {name} {pm}"
        r = _train_main_path(xtt, hist_cuda, params, dtrain, R, rounds,
                             "hist_f32", label, repeats=repeats,
                             metrics=metrics,
                             want_fn=_p15_want(hist_cuda, depth, rounds,
                                               pm))
        metric = metrics[0]
        const = _rank_constant(r["bst"], dtrain, y, metric)
        final = r["final"][metric]
        log(f"phase {label}: {R} x {F}, {len(sizes)} queries, depth "
            f"{depth}, {rounds} rounds; train loop median "
            f"{r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s (runs "
            f"{r['times']} s); with eval {r['with_eval_s']:.3f} s; K1 and K3 "
            f"launches {r['launches'] // rounds} a round, K5 "
            f"{hist_cuda.launches['lambdarank']} in the last timed run; "
            f"train {metric} {final} against the constant model's {const}")
        if not final > const:
            raise AssertionError(f"phase {label}: {metric} {final} not "
                                 f"above the constant model's {const}")
        out[(name, pm)] = r
    _p15_gradient(hist_cuda, dtrain, y)
    phase_profile(xtt, dtrain, MSLR_PARAMS, "15 (rank:ndcg)")
    return out


def _p15_gradient(hist_cuda, dtrain, y):
    """One rank:ndcg get_gradient at the main path's rows: every operation
    it puts on the stream (graph_ops), none a copy to the host, one K5
    launch; its device time and K5's (torch.profiler)."""
    from xgboost_tpu_torch.objective import create_objective

    obj = create_objective("rank:ndcg", {})
    obj.set_group_info(dtrain.group_ptr)
    R_pad = dtrain.ensure_ellpack(max_bin=256).n_padded
    rng = np.random.default_rng(16)
    margin = torch.from_numpy(rng.normal(size=(R_pad, 1)).astype(
        np.float32)).cuda()
    labels = torch.zeros(R_pad, dtype=torch.float32, device="cuda")
    labels[:len(y)] = torch.from_numpy(y).cuda()

    def call():
        return obj.get_gradient(margin, labels, None)
    call()
    before = hist_cuda.launches["lambdarank"]
    ops = graph_ops(call)
    k5 = hist_cuda.launches["lambdarank"] - before
    counts: dict = {}
    for kind, detail in ops:
        key = f"memcpy to {detail}" if kind == "memcpy" else kind
        counts[key] = counts.get(key, 0) + 1
    k5_nodes = [d for kind, d in ops if kind == "kernel" and d
                and "lambdarank" in d]
    for _ in range(3):  # the profiler now and then sees no events
        ms, n, kernels = device_per_call(call, reps=5)
        if n:
            break
    _no_host_copy(ops, kernels, "the rank:ndcg gradient")
    k5_ms = [v for k, v in kernels.items() if "lambdarank" in k]
    timing = (f"{ms} ms of device time a call (torch.profiler: {kernels})"
              if n else "device time not measured (the profiler saw no "
              "events)")
    log(f"phase 15 gradient: one rank:ndcg get_gradient at {R_pad} rows puts "
        f"{len(ops)} operations on the stream {counts}, K5 nodes "
        f"{k5_nodes}, no copy to the host; K5 counts {k5} launch(es) of "
        f"two calls, captured and warm; {timing}")
    if k5 != 2 or len(k5_nodes) > 1:
        raise AssertionError(f"phase 15: a get_gradient launched K5 {k5} "
                             "times in two calls, want 2")


def phase_ranking_parity(xtt, rounds: int = 3):
    """Card vs CPU on 20,000 rows of the MSLR generator at depth 6: under
    deterministic_histogram=1 byte-identical model JSON for rank:ndcg,
    rank:pairwise and rank:map with top-k pairs and for rank:ndcg with the
    mean method; the f32 path the same trees up to a near tie (8b's
    rule)."""
    X, y, sizes = make_mslr(groups=200, seed=5)
    keep = int(np.searchsorted(np.cumsum(sizes), 20_000, side="right"))
    sizes = sizes[:keep]
    R = int(sizes.sum())
    X, y = X[:R], y[:R]
    base = dict(MSLR_PARAMS, max_depth=6)
    for name, extra in (("rank:ndcg", {}), ("rank:pairwise", {}),
                        ("rank:map", {}),
                        ("rank:ndcg", {"lambdarank_pair_method": "mean"})):
        params = dict(base, objective=name, **extra)
        what = f"15b {name} {json.dumps(extra)}"
        _card_vs_cpu(xtt, dict(params, deterministic_histogram=1), X, y,
                     rounds, 1e-5, what + " deterministic", identical=True,
                     group=sizes)
        if extra:
            continue
        got = xtt.train(params, xtt.DMatrix(X, label=y, group=sizes), rounds,
                        verbose_eval=False)
        ref = xtt.train(params, xtt.DMatrix(X, label=y, group=sizes,
                                            device="cpu"),
                        rounds, verbose_eval=False, device="cpu")

        def margin_diff(got=got, ref=ref):
            a = got.predict(xtt.DMatrix(X), output_margin=True)
            b = ref.predict(xtt.DMatrix(X, device="cpu"),
                            output_margin=True)
            return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

        _same_or_near_tie(got, ref, what + " f32", got.trees_per_round,
                          margin_diff, 1e-4,
                          f"card vs CPU on {R} rows, margins relative to the "
                          "largest", X)


# ------------------------------------------------- the API on the card (16)
P16_ROUNDS = 10
P16_FOLDS = 3


def _fold_recorder(xtt, prof=None):
    """A callback that keeps cv's folds (the packed model it is handed),
    the card's memory while they are alive, and the time at the start of
    each round and at the end; with ``prof`` (a torch.profiler context)
    it profiles rounds 2 and 3."""
    class Recorder(xtt.TrainingCallback):
        def before_training(self, model):
            self.packs, self.starts = model.packs, []
            return model

        def before_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            self.starts.append(time.perf_counter())
            if prof is not None and epoch == 1:
                prof.__enter__()
            elif prof is not None and epoch == 3:
                prof.__exit__(None, None, None)
            return False

        def after_training(self, model):
            torch.cuda.synchronize()
            self.end = time.perf_counter()
            self.bytes = torch.cuda.memory_allocated()
            return model

    return Recorder()


def _p16_cv(xtt, hist_cuda, dall, params, kernel, label, f32_round_s):
    """cv at full width: launches gated (K1 or K2 and K3 6 a fold-round,
    K4 once a fold for the base score and three times a fold-round: the
    gradient and the two evaluation sets), the test AUC above 0.9, the
    seconds a round (median of rounds 2-10) beside three of phase 3's, the
    card's memory the three folds hold, and rounds 2-3 profiled."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec = _fold_recorder(xtt, prof)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist_cuda.reset_launches()
    t0 = time.perf_counter()
    res = xtt.cv(dict(params, eval_metric=["logloss", "auc"]), dall,
                 P16_ROUNDS, nfold=P16_FOLDS, as_pandas=False,
                 callbacks=[rec])
    wall = time.perf_counter() - t0
    launches = dict(hist_cuda.launches)
    want = _sigmoid_launches(hist_cuda, P16_ROUNDS, evals=2)
    want["sigmoid"] *= P16_FOLDS
    want[kernel] = want["split_scan"] = \
        params["max_depth"] * P16_FOLDS * P16_ROUNDS
    if launches != want:
        raise AssertionError(f"phase {label}: cv launched {launches}, want "
                             f"{want}")
    rounds = np.diff(rec.starts + [rec.end])
    round_s = statistics.median(rounds[1:])
    auc, std = res["test-auc-mean"][-1], res["test-auc-std"][-1]
    if not auc > 0.9:
        raise AssertionError(f"phase {label}: cv test AUC {auc} <= 0.9")
    fold_bytes = rec.bytes - before
    peak = torch.cuda.max_memory_allocated() - before
    log(f"phase {label} cv: {dall.num_row()} x {dall.num_col()}, nfold "
        f"{P16_FOLDS}, {P16_ROUNDS} rounds, depth {params['max_depth']}; "
        f"wall {wall:.3f} s (folds made in {rec.starts[0] - t0:.3f} s, "
        f"first round {rounds[0]:.3f} s); a round {round_s:.4f} s, median "
        f"of rounds 2-{P16_ROUNDS} (against 3x phase 3's "
        f"{3 * f32_round_s:.4f} s), each fold's train and test evaluated; "
        f"test-auc {auc:.6f}+{std:.6f}, test-logloss "
        f"{res['test-logloss-mean'][-1]:.6f}; launches {launches}; the three "
        f"folds hold {fold_bytes} bytes of the card's memory after "
        f"training (peak {peak} above what was allocated before)")
    _log_profile(prof, (rec.starts[3] - rec.starts[1]) * 1e3, label,
                 "cv rounds 2-3 (three folds, each updated and its train "
                 "and test evaluated)")
    return dict(round_s=round_s, fold_bytes=fold_bytes, peak=peak, res=res,
                launches=launches)


def _p16_cv_parity(xtt):
    """cv card vs CPU at 20,000 rows under deterministic_histogram=1: every
    fold's model JSON byte-identical and the results dicts equal."""
    X, y = make_data(20_000, 28, seed=3)
    params = dict(SMALL, deterministic_histogram=1, subsample=0.8, seed=5,
                  eval_metric=["logloss", "auc"])
    recs, results = [], []
    for dm_kw, cv_kw in (({}, {}), ({"device": "cpu"}, {"device": "cpu"})):
        rec = _fold_recorder(xtt)
        results.append(xtt.cv(params, xtt.DMatrix(X, label=y, **dm_kw), 3,
                              nfold=P16_FOLDS, as_pandas=False,
                              callbacks=[rec], **cv_kw))
        recs.append(rec)
    same = [_model_bytes(a.bst) == _model_bytes(b.bst)
            for a, b in zip(recs[0].packs, recs[1].packs)]
    if not all(same) or results[0] != results[1]:
        raise AssertionError(f"phase 16 cv parity: fold models identical "
                             f"{same}, results {results}")
    log(f"phase 16 cv parity: card vs CPU on 20,000 rows, {P16_FOLDS} folds, "
        "deterministic: every fold's model JSON byte-identical, results "
        f"dicts equal (test-auc {results[0]['test-auc-mean'][-1]:.6f})")


def phase_api_surface(xtt, hist_cuda, f32):
    """The public API on the card at phase 3's shapes: cv on both
    histogram paths, cv card vs CPU, serialize -> a fresh Booster ->
    continuation byte-identical to the uninterrupted run, a pickle round
    trip, XGBClassifier against train(), XGBRanker's K5 launches and
    inplace_predict against predict."""
    import pickle

    X, y = make_data(1_000_000, 28)
    dall = xtt.DMatrix(X, label=y)
    f32_round_s = f32["train_s"] / 10
    out = {}
    for label, params, kernel in (("16 f32", BASE, "hist_f32"),
                                  ("16 deterministic", DET, "hist_q")):
        out[label] = _p16_cv(xtt, hist_cuda, dall, params, kernel, label,
                             f32_round_s)
    del dall
    _p16_cv_parity(xtt)

    dtrain = xtt.DMatrix(X, label=y)
    params = dict(DET, subsample=0.8, seed=13)
    full = xtt.train(params, dtrain, 10, verbose_eval=False)
    half = xtt.train(params, dtrain, 5, verbose_eval=False)
    restored = xtt.Booster()
    restored.unserialize(half.serialize())
    cont = xtt.train({}, dtrain, 5, verbose_eval=False, xgb_model=restored)
    if _model_bytes(cont) != _model_bytes(full):
        raise AssertionError("phase 16: serialize -> continuation differs "
                             "from the uninterrupted run")
    dtest = xtt.DMatrix(X[:100_000])
    pred = full.predict(dtest)
    back = pickle.loads(pickle.dumps(full))
    if back.device != full.device or not np.array_equal(
            back.predict(dtest).view(np.uint32), pred.view(np.uint32)):
        raise AssertionError("phase 16: the pickle round trip predicts "
                             "differently")
    for name, data in (("numpy", X[:100_000]),
                       ("tensor", torch.from_numpy(X[:100_000]).cuda())):
        got = full.inplace_predict(data)
        if not np.array_equal(got.view(np.uint32), pred.view(np.uint32)):
            raise AssertionError(f"phase 16: inplace_predict of a {name} "
                                 "input differs from predict")
    log("phase 16 API: serialize -> Booster() -> 5 more rounds "
        "byte-identical to 10 (deterministic, subsample 0.8, 1M x 28); "
        "pickle round trip and inplace_predict (numpy and a CUDA tensor) "
        "equal predict on 100,000 rows bit for bit")

    # the estimator against train() with its parameters, full width; the
    # deterministic path, whose models do not depend on the order of the
    # card's atomic adds, so that the two agree bit for bit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = xtt.XGBClassifier(n_estimators=10, max_depth=6,
                            deterministic_histogram=1).fit(X, y)
    proba = clf.predict_proba(X[:100_000])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst = xtt.train({"objective": "binary:logistic", "max_depth": 6,
                     "deterministic_histogram": 1},
                    xtt.DMatrix(X, label=y), 10, verbose_eval=False)
    p = bst.predict(xtt.DMatrix(X[:100_000]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    want = np.stack([1 - p, p], axis=1)
    if not np.array_equal(proba.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("phase 16: XGBClassifier.predict_proba differs "
                             "from train()'s predictions")
    imp = clf.feature_importances_
    log(f"phase 16 XGBClassifier: 10 rounds, depth 6, deterministic, "
        f"1M x 28: "
        f"predict_proba on 100,000 rows equals train()'s bit for bit; fit "
        f"and predict {fit_s:.3f} s against DMatrix, train() and predict "
        f"{train_s:.3f} s (overhead {fit_s - train_s:.3f} s, one run each; "
        f"the device sketch of each); feature_importances_ sum "
        f"{imp.sum():.6f}, top feature f{int(np.argmax(imp))}")

    rng = np.random.default_rng(16)
    sizes = np.full(1000, 100)
    R = int(sizes.sum())
    Xr = rng.standard_normal(size=(R, 136), dtype=np.float32)
    rel = np.clip((Xr[:, 0] + 0.5 * rng.standard_normal(R, dtype=np.float32)
                   + 2.0).astype(np.int64), 0, 4).astype(np.float32)
    rounds = 5
    hist_cuda.reset_launches()
    ranker = xtt.XGBRanker(n_estimators=rounds, max_depth=6).fit(
        Xr, rel, group=sizes)
    k5 = hist_cuda.launches["lambdarank"]
    if k5 != rounds + 1:
        raise AssertionError(f"phase 16: XGBRanker launched K5 {k5} times "
                             f"in {rounds} rounds, want {rounds + 1}")
    scores = ranker.predict(Xr)
    if not np.all(np.isfinite(scores)):
        raise AssertionError("phase 16: XGBRanker scores not finite")
    log(f"phase 16 XGBRanker: {R} x 136 in {len(sizes)} groups, {rounds} "
        f"rounds: K5 launched {k5} times (rounds + 1), scores finite")
    out["fit_s"], out["train_s"] = fit_s, train_s
    return out


# ------------------------------------------------------------------ 17
P17_ROUNDS = 10
P17_DART = {"uniform/tree": dict(BASE, booster="dart", rate_drop=0.1),
            "weighted/forest": dict(BASE, booster="dart", rate_drop=0.1,
                                    sample_type="weighted",
                                    normalize_type="forest")}
P17_APPROX = dict(BASE, tree_method="approx")
# the exact phase's rows: 2^18 took 68 s on the H100's host (PERF.md §6);
# cut to 2^17 to make room for phase 19 within the script's time limit
P17_EXACT_ROWS = 1 << 17
# process_type="update" over a model of this many rounds (10 until phase 19
# needed the time, 5 until phase 21 did; a round took 2.1-2.6 s)
P17D_ROUNDS = 3


def _dart_drops(xtt, params, dtrain, rounds):
    """{round: trees dropped} of a DART training, from the booster's own
    draw before each update (update() draws the same set)."""
    bst = xtt.Booster(params, cache=[dtrain])
    drops = {}
    for i in range(rounds):
        d = bst._select_dart_drops(i)
        if d:
            drops[i] = len(d)
        bst.update(dtrain, i)
    return drops


def _profile_rounds(xtt, dtrain, params, label, first: int, rounds: int = 2,
                    top: int = 8):
    """A profile of rounds ``first`` .. ``first + rounds - 1`` of one
    booster (a DART round drops trees only once there are trees), with the
    trees each dropped."""
    from torch.profiler import ProfilerActivity, profile

    bst = xtt.Booster(params, cache=[dtrain])
    for i in range(first):
        bst.update(dtrain, i)
    torch.cuda.synchronize()
    dropped = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + rounds):
            dropped.append(len(bst._select_dart_drops(i)))
            bst.update(dtrain, i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall_ms, label,
                 f"rounds {first}-{first + rounds - 1} of one booster "
                 f"(trees dropped: {dropped})", top)


def phase_dart(xtt, hist_cuda, dtrain, X, f32, det):
    """DART at phase 3's full width on both histogram paths, uniform drops
    with the "tree" rescale and weighted drops with "forest": K1 or K2
    and K3 6 times a round and K4's gradient once a round (the drop
    rounds' gradient on the reduced margin), AUC > 0.9, two deterministic
    runs byte-identical, JSON and UBJ reloads predicting identically."""
    dtest = xtt.DMatrix(X[:100_000])
    out, first_drops = {}, {}
    for name, params in P17_DART.items():
        for path, kernel, base in (("f32", "hist_f32", f32),
                                   ("deterministic", "hist_q", det)):
            p = params if path == "f32" else dict(
                params, deterministic_histogram=1)
            label = f"17a {name} {path}"
            r = _train_main_path(xtt, hist_cuda, p, dtrain, X.shape[0],
                                 P17_ROUNDS, kernel, label)
            same = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
            if path == "deterministic" and not same:
                raise AssertionError(f"phase {label}: two deterministic runs "
                                     "wrote different models")
            drops = _dart_drops(xtt, p, dtrain, P17_ROUNDS)
            if not drops:
                raise AssertionError(f"phase {label}: no round dropped a "
                                     "tree")
            _reload_check(xtt, r["bst"], dtest, label)
            w = r["bst"].tree_weights
            log(f"phase {label}: {X.shape[0]} x {X.shape[1]}, "
                f"{P17_ROUNDS} rounds, rate_drop 0.1; rounds that dropped "
                f"(trees): {drops}; train loop median {r['train_s']:.3f} s "
                f"= {r['rate']:.3f} M row-rounds/s (runs {r['times']} s; "
                f"gbtree, phase 3{'' if path == 'f32' else 'c'}: "
                f"{base['train_s']:.3f} s); logloss {r['logloss']:.6f} auc "
                f"{r['auc']:.6f}; {kernel} and K3 launches {r['launches']} "
                f"each, K4 {r['sigmoid_launches']}; tree weights "
                f"{min(w):.6f}-{max(w):.6f}; two runs byte-identical: "
                f"{same}; JSON and UBJ reload identically")
            out[(name, path)] = r
            first_drops[name] = min(drops)
    # two rounds from the first that drops trees
    _profile_rounds(xtt, dtrain, P17_DART["uniform/tree"], "17a (DART)",
                    first=first_drops["uniform/tree"])
    return out


def phase_approx(xtt, hist_cuda, dtrain, X, f32, det):
    """tree_method="approx" at phase 3's full width on both paths: each
    round's hessians to the host, the weighted host sketch, the device's
    bins; K1 or K2 and K3 6 times a round, AUC > 0.9, two deterministic
    runs byte-identical; the three steps' seconds a round."""
    from xgboost_tpu_torch.data.ellpack import build_ellpack

    t0 = time.perf_counter()
    sketch = dtrain.weighted_sketch()
    setup_s = time.perf_counter() - t0
    out = {}
    for path, kernel, p, base in (
            ("f32", "hist_f32", P17_APPROX, f32),
            ("deterministic", "hist_q",
             dict(P17_APPROX, deterministic_histogram=1), det)):
        label = f"17b {path}"
        r = _train_main_path(xtt, hist_cuda, p, dtrain, X.shape[0],
                             P17_ROUNDS, kernel, label, repeats=1)
        same = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
        if path == "deterministic" and not same:
            raise AssertionError(f"phase {label}: two deterministic runs "
                                 "wrote different models")
        log(f"phase {label}: {X.shape[0]} x {X.shape[1]}, {P17_ROUNDS} "
            f"rounds; train loop {r['train_s']:.3f} s = {r['rate']:.3f} M "
            f"row-rounds/s (one run; hist, phase "
            f"3{'' if path == 'f32' else 'c'}: {base['train_s']:.3f} s); "
            f"logloss {r['logloss']:.6f} auc {r['auc']:.6f}; {kernel} and "
            f"K3 launches {r['launches']} each, K4 {r['sigmoid_launches']}; "
            f"two runs byte-identical: {same}")
        out[path] = r
    # the round's three steps on their own, at one round's gradient
    bst = xtt.Booster(P17_APPROX, cache=[dtrain])
    cache = bst._train_cache(dtrain)
    bst._sync_margin(cache)
    gpair = bst.objective.get_gradient(cache.margin, cache.labels,
                                       cache.weights, 0)
    copy_s, sketch_s, bin_s = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hess = gpair[..., 1].cpu().numpy()
        t1 = time.perf_counter()
        cuts = sketch.cuts(256, hess.sum(axis=1)[: cache.n_real].astype(
            np.float64))
        t2 = time.perf_counter()
        page = build_ellpack(dtrain.X, cuts)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        copy_s.append(t1 - t0)
        sketch_s.append(t2 - t1)
        bin_s.append(t3 - t2)
    round_s = out["f32"]["train_s"] / P17_ROUNDS
    med = statistics.median
    log(f"phase 17b steps a round (median of 3): hessian copy to the host "
        f"{med(copy_s) * 1e3:.3f} ms, host sketch {med(sketch_s):.4f} s "
        f"(its columns' sorts once a matrix: {setup_s:.3f} s), device bins "
        f"{med(bin_s) * 1e3:.3f} ms ({page.bins.dtype}, "
        f"{page.n_padded} rows); an f32 approx round {round_s:.4f} s, the "
        f"sketch {100 * med(sketch_s) / round_s:.1f}% of it")
    out["steps"] = dict(copy_s=med(copy_s), sketch_s=med(sketch_s),
                        bin_s=med(bin_s), setup_s=setup_s, round_s=round_s)
    phase_profile(xtt, dtrain, P17_APPROX, "17b (approx)")
    return out


def _constant_loss(y, objective):
    """The final metric of the constant model (the label mean)."""
    m = float(np.mean(y))
    if objective == "binary:logistic":
        return float(-np.mean(y * np.log(m) + (1 - y) * np.log(1 - m)))
    return float(np.sqrt(np.mean((y - m) ** 2)))


def phase_gblinear(xtt, hist_cuda, X, y):
    """gblinear at phase 3's full width: binary:logistic (K4 once for the
    base score and once a round) and reg:squarederror, coord_descent
    (cyclic), shotgun (shuffle) and greedy (top_k 8), 10 rounds each;
    K1, K2 and K3 never launch; the final logloss and rmse below the
    constant model's; a reload predicts identically; ms a round, and the
    operations of one round and of one group's coordinate chain."""
    from xgboost_tpu_torch.models import gblinear

    yr = (1.5 * X[:, 0] + X[:, 1] * X[:, 2] - 0.8 * np.abs(X[:, 3])
          + 0.5 * X[:, 4]).astype(np.float32)
    dtest = xtt.DMatrix(X[:100_000])
    configs = (("coord_descent cyclic", {}),
               ("shotgun shuffle", {"updater": "shotgun"}),
               ("coord_descent greedy top_k 8",
                {"feature_selector": "greedy", "top_k": 8}))
    out = {}
    for objective, labels in (("binary:logistic", y),
                              ("reg:squarederror", yr)):
        d = xtt.DMatrix(X, label=labels)
        const = _constant_loss(labels, objective)
        for name, extra in configs:
            label = f"17c {objective} {name}"
            p = dict(booster="gblinear", objective=objective, eta=0.5,
                     **extra)
            want = {k: 0 for k in hist_cuda.launches}
            if objective == "binary:logistic":
                want["sigmoid"] = 1 + P17_ROUNDS
            hist_cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = xtt.train(p, d, P17_ROUNDS, verbose_eval=False)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            k4 = hist_cuda.launches["sigmoid"]
            if hist_cuda.launches != want:
                raise AssertionError(f"phase {label}: launches "
                                     f"{hist_cuda.launches}, want {want}")
            pred = bst.predict(d)
            if objective == "binary:logistic":
                pc = np.clip(pred, 1e-7, 1 - 1e-7)
                loss = float(-np.mean(labels * np.log(pc)
                                      + (1 - labels) * np.log(1 - pc)))
            else:
                loss = float(np.sqrt(np.mean((pred - labels) ** 2)))
            if not loss < const:
                raise AssertionError(f"phase {label}: final loss {loss} not "
                                     f"below the constant model's {const}")
            _reload_check(xtt, bst, dtest, label)
            # one more round's device operations (torch.profiler)
            rounds = iter(range(P17_ROUNDS, P17_ROUNDS + 100))
            ms, ops, kernels = device_per_call(
                lambda: bst.update(d, next(rounds)), reps=5)
            log(f"phase {label}: {X.shape[0]} x {X.shape[1]}, "
                f"{P17_ROUNDS} rounds {train_s:.3f} s = "
                f"{train_s / P17_ROUNDS * 1e3:.3f} ms a round; final "
                f"{'logloss' if objective == 'binary:logistic' else 'rmse'} "
                f"{loss:.6f} (constant model {const:.6f}); K4 {k4}, "
                f"K1/K2/K3 0; one more round puts {ops} operations on the "
                f"stream, device "
                f"{'not measured' if ms is None else f'{ms:.3f} ms'}; JSON "
                f"and UBJ reload identically")
            out[label] = dict(train_s=train_s, loss=loss, const=const,
                              ops=ops, device_ms=ms, bst=bst)
        del d
    # one group's coordinate chain, captured as a CUDA graph
    d = xtt.DMatrix(X, label=yr)
    bst = xtt.train(dict(booster="gblinear"), d, 1, verbose_eval=False)
    XT = bst._linear_XT(bst._caches[id(d)])
    g = torch.randn(X.shape[0], device=XT.device)
    h = torch.rand(X.shape[0], device=XT.device)
    w = torch.zeros(X.shape[1], device=XT.device)
    b = torch.zeros((), device=XT.device)
    order = np.arange(X.shape[1])
    chain = graph_ops(lambda: gblinear.linear_update(
        XT, g, h, w, b, order, eta=0.5, lambda_=0.0, alpha=0.0))
    greedy = graph_ops(lambda: gblinear.linear_update_greedy(
        XT, g, h, w, b, steps=8, eta=0.5, lambda_=0.0, alpha=0.0))
    for what, ops in (("cyclic", chain), ("greedy top_k 8", greedy)):
        if any(op == ("memcpy", "host") for op in ops):
            raise AssertionError(f"phase 17c: the {what} chain copies to the "
                                 "host")
    log(f"phase 17c chain: one group's coordinate chain over "
        f"{X.shape[1]} features is {len(chain)} operations (cyclic), "
        f"{len(greedy)} (greedy, 8 steps), read from CUDA graphs; none "
        f"copies to the host")
    out["chain_ops"] = (len(chain), len(greedy))
    return out


def phase_update(xtt, hist_cuda, dtrain, X):
    """process_type="update" over a P17D_ROUNDS-round model of phase
    3's data on the card: refresh alone (refresh_leaf 0) keeps every
    tree's structure and the predictions; refresh,prune with
    refresh_leaf 1 and 0 at a positive gamma removes splits; K4 once a
    round (each round's gradient, on the card, copied to the host once),
    K1-K3 never."""
    base = xtt.train(BASE, dtrain, P17D_ROUNDS, verbose_eval=False)
    raw = bytes(base.save_raw("json"))
    dtest = xtt.DMatrix(X[:100_000])
    p0 = base.predict(dtest)
    splits = lambda b: sum(int((t.left_children != -1).sum())  # noqa: E731
                           for t in b.trees)
    # the median gain of the base model's splits above two leaves
    gains = [float(t.loss_changes[n]) for t in base.trees
             for n in range(t.n_nodes) if t.left_children[n] != -1
             and t.left_children[t.left_children[n]] == -1
             and t.left_children[t.right_children[n]] == -1]
    gamma = float(np.median(gains))
    out = {}
    for updater, rl, g in (("refresh", 0, 0.0),
                           ("refresh,prune", 1, gamma),
                           ("refresh,prune", 0, gamma)):
        label = f"17d {updater} refresh_leaf={rl}"
        p = dict(BASE, process_type="update", updater=updater,
                 refresh_leaf=rl, gamma=g)
        want = {k: 0 for k in hist_cuda.launches}
        want["sigmoid"] = P17D_ROUNDS  # one gradient a round
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = xtt.train(p, dtrain, P17D_ROUNDS, verbose_eval=False,
                        xgb_model=bytearray(raw))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if hist_cuda.launches != want:
            raise AssertionError(f"phase {label}: launches "
                                 f"{hist_cuda.launches}, want {want}")
        if bst.num_boosted_rounds() != P17D_ROUNDS:
            raise AssertionError(f"phase {label}: {bst.num_boosted_rounds()} "
                                 "rounds after the update")
        pred = bst.predict(dtest)
        if updater == "refresh":
            for a, b in zip(base.trees, bst.trees):
                if not np.array_equal(a.left_children, b.left_children) or \
                        not np.array_equal(a.split_indices, b.split_indices):
                    raise AssertionError(f"phase {label}: refresh changed a "
                                         "tree's structure")
            if rl == 0 and not np.array_equal(pred, p0):
                raise AssertionError(f"phase {label}: refresh_leaf=0 moved "
                                     "the predictions")
        elif not splits(bst) < splits(base):
            raise AssertionError(f"phase {label}: prune at gamma {g} removed "
                                 "no split")
        log(f"phase {label}: {P17D_ROUNDS} rounds of a {P17D_ROUNDS}-round "
            f"model on {X.shape[0]} x {X.shape[1]}, gamma {g:.6g}: "
            f"{s:.3f} s ({s / P17D_ROUNDS:.3f} s a round); splits "
            f"{splits(base)} -> {splits(bst)}; max |pred change| "
            f"{np.abs(pred - p0).max():.4g}; K4 {want['sigmoid']}, K1-K3 0")
        out[label] = s
    return out


def phase_exact(xtt, hist_cuda, X, y):
    """tree_method="exact" on phase 3's 28 features, 2 rounds, depth 6, on
    the first P17_EXACT_ROWS rows: seconds a round split into the host
    enumeration (and its pruning) and the device gradient; AUC > 0.9; K4
    once for the base score and twice a round (gradient, evaluation),
    K1-K3 never."""
    import xgboost_tpu_torch.core as core

    R, rounds = P17_EXACT_ROWS, 2
    d = xtt.DMatrix(X[:R], label=y[:R])
    host = {"s": 0.0}
    grow, prune = core.grow_exact, core.prune_tree

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host["s"] += time.perf_counter() - t0
        return run

    params = dict(BASE, tree_method="exact", eval_metric="auc")
    want = _sigmoid_launches(hist_cuda, rounds, evals=1)
    core.grow_exact, core.prune_tree = timed(grow), timed(prune)
    try:
        hist_cuda.reset_launches()
        res: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = xtt.train(params, d, rounds, evals=[(d, "train")],
                        evals_result=res, verbose_eval=False)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        core.grow_exact, core.prune_tree = grow, prune
    if hist_cuda.launches != want:
        raise AssertionError(f"phase 17e: launches {hist_cuda.launches}, "
                             f"want {want}")
    auc = res["train"]["auc"][-1]
    if not auc > 0.9:
        raise AssertionError(f"phase 17e: AUC {auc} <= 0.9")
    cache = bst._caches[id(d)]
    grad_ms = cuda_ms(lambda: bst.objective.get_gradient(
        cache.margin, cache.labels, cache.weights, 0), reps=10)
    log(f"phase 17e exact: {R} x {X.shape[1]} (cut from {X.shape[0]} "
        f"rows), {rounds} rounds, depth 6: {total:.3f} s, "
        f"{total / rounds:.3f} s a round; host enumeration and pruning "
        f"{host['s'] / rounds:.3f} s a round, device gradient "
        f"{grad_ms:.4f} ms; train AUC {auc:.6f}; K4 "
        f"{want['sigmoid']}, K1-K3 0")
    return dict(total_s=total, host_s=host["s"], grad_ms=grad_ms, auc=auc)


def phase_boosters_parity(xtt):
    """Card vs CPU on 20,000 rows of phase 3's generator, depth 4: the
    deterministic DART (both sample and normalize types, with one_drop and
    skip_drop), approx, exact and refresh,prune models byte-identical;
    f32 DART and approx the same trees up to a near tie; gblinear weights
    within 1e-5 relative, 1e-6 absolute."""
    Xs, ys = make_data(20_000, 28, seed=3)
    det = dict(SMALL, deterministic_histogram=1)
    for label, params in (
            ("17f DART uniform/tree", dict(det, booster="dart",
                                           rate_drop=0.3)),
            ("17f DART weighted/forest one_drop skip_drop",
             dict(det, booster="dart", rate_drop=0.2,
                  sample_type="weighted", normalize_type="forest",
                  one_drop=1, skip_drop=0.3)),
            ("17f approx", dict(det, tree_method="approx")),
            ("17f exact", dict(SMALL, tree_method="exact", gamma=0.5,
                               subsample=0.8))):
        _card_vs_cpu(xtt, params, Xs, ys, 5, 1e-5, label, identical=True)
    base = xtt.train(det, xtt.DMatrix(Xs, label=ys, device="cpu"), 5,
                     verbose_eval=False, device="cpu")
    raw = bytes(base.save_raw("json"))
    upd = dict(det, process_type="update", updater="refresh,prune",
               gamma=2.0)
    models = [_model_bytes(xtt.train(
        upd, xtt.DMatrix(Xs, label=ys, device=dev), 5,
        xgb_model=bytearray(raw), verbose_eval=False, device=dev))
        for dev in ("cuda", "cpu")]
    if models[0] != models[1]:
        raise AssertionError("phase 17f: refresh,prune on the card is not "
                             "the CPU's")
    log("phase 17f parity: refresh,prune of one CPU model on each device, "
        "model JSON byte-identical: True")
    for label, params in (("17f DART f32", dict(SMALL, booster="dart",
                                                rate_drop=0.3)),
                          ("17f approx f32", dict(SMALL,
                                                  tree_method="approx"))):
        _card_vs_cpu_f32_tie(xtt, params, Xs, ys, 5, 1e-4, label)
    for sel, upd_name in (("cyclic", "coord_descent"),
                          ("shuffle", "shotgun"), ("greedy", "coord_descent")):
        p = {"booster": "gblinear", "objective": "binary:logistic",
             "updater": upd_name, "feature_selector": sel, "top_k": 8,
             "eta": 0.5}
        card, cpu = (xtt.train(p, xtt.DMatrix(Xs, label=ys, device=dev), 10,
                               verbose_eval=False, device=dev)
                     for dev in ("cuda", "cpu"))
        for a, b in ((card.linear_weights, cpu.linear_weights),
                     (card.linear_bias, cpu.linear_bias)):
            if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"phase 17f: gblinear {sel}: card and "
                                     f"CPU weights differ by "
                                     f"{np.abs(a - b).max()}")
        err = np.abs(card.linear_weights - cpu.linear_weights).max()
        log(f"phase 17f parity: gblinear {upd_name} {sel}, 10 rounds: "
            f"weights within 1e-5 relative, 1e-6 absolute (max |diff| "
            f"{err:.3g})")

# phase 18: interpretation.  K6 against its plain version on the card: the
# f32 terms are the plain version's bit for bit, only the within-bucket sums
# are taken in another order (index_add_'s atomics).  The plain version runs
# over the whole call, 2^18 rows at a time, unless it would take 20 s; then
# it stops after the first 2^18 rows, and K6 is timed on those rows too.
P18_ROWS = 1 << 16  # the lossguide, DART and interaction calls
P18_PLAIN_CHUNK = 1 << 18
P18_PLAIN_BUDGET_S = 20.0
P18_CARD_CPU_ROWS = 20_000
SHAP_REL = 1e-5  # K6 vs plain: |diff| <= SHAP_REL max|plain| + SHAP_ABS
SHAP_ABS = 1e-6
# K6 is built with --fmad=false: an unfused f32 multiply or add retires at
# one a lane a clock, 128 lanes x 132 SMs x ~1.98 GHz on an H100 SXM (half
# of F32_FLOPS, which counts a fused multiply-add as two); an f64 add at
# half of F64_FLOPS likewise
F32_UNFUSED = 33.5e12
F64_UNFUSED = 17e12


def _shap_close(got, want, what):
    tol = SHAP_REL * float(want.abs().max()) + SHAP_ABS
    err = float((got - want).abs().max())
    if not err <= tol:
        raise AssertionError(f"phase {what}: K6 and its plain version "
                             f"differ by {err:.3g} > {tol:.3g}")
    return err, tol


def _groups(bst):
    """{output group: (trees, weights)} of a booster's scalar trees."""
    out = {}
    for t, g, w in zip(bst.trees, bst.tree_info, bst.tree_weights):
        trees, wts = out.setdefault(g, ([], []))
        trees.append(t)
        wts.append(w)
    return out


def _k6_bound(tables, rows, interactions=False):
    """K6's least time on this call's inputs: its bytes at the HBM rate
    against its f32 and f64 operations at the unfused rates; (ms, what
    bounds it, f32 operations)."""
    from xgboost_tpu_torch.ops import treeshap_cuda as tc

    nbytes, f32, f64 = tc.work(tables, rows, interactions)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (f32 / F32_UNFUSED + f64 / F64_UNFUSED) * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations", f32


def _local_accuracy(got, margin, what, rtol=1e-3, atol=1e-3):
    err = np.abs(got - margin).max()
    if not np.allclose(got, margin, rtol=rtol, atol=atol):
        raise AssertionError(f"phase {what}: contributions miss the margin "
                             f"by {err:.3g} (rtol {rtol}, atol {atol})")
    return err


def _shap_call(xtt, hist_cuda, label, bst, X, interactions=False):
    """The main path: ``predict(pred_contribs=True)`` (or
    ``pred_interactions``) of X as a user calls it, the launch counts set
    to 0 just before and read just after; its seconds, local accuracy
    against the margin, and the K6 launches (one a group that has a
    split)."""
    from xgboost_tpu_torch.interpret.device import path_tables

    d = xtt.DMatrix(X)
    torch.cuda.synchronize()
    hist_cuda.reset_launches()
    t0 = time.perf_counter()
    out = bst.predict(d, **({"pred_interactions": True} if interactions
                            else {"pred_contribs": True}))
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(hist_cuda.launches)
    groups = _groups(bst)
    F = X.shape[1]
    n_split = sum(bool(path_tables(t, w, F).buckets)
                  for t, w in groups.values())
    want = {k: 0 for k in launches}
    want["treeshap"] = n_split
    if interactions:
        want["treeshap_interactions"] = n_split
    if launches != want or n_split == 0:
        raise AssertionError(f"phase {label}: launches {launches}, want "
                             f"{want}")
    margin = bst.predict(d, output_margin=True)
    summed = out.sum(-1) if not interactions else out.sum((-2, -1))
    err = _local_accuracy(summed, margin, label)
    return d, out, call_s, launches, err


def _call_split(xtt, bst, X, label, interactions=False):
    """Where a ``predict(pred_contribs=True)`` (or ``pred_interactions``)
    call's time goes: the package's steps of that call, one by one, each
    ended by a synchronize: X to the card (a new DMatrix of the host rows
    X, which copies them, and ``_device_X``), the path tables
    and their packing, K6 (for the interactions also the values' launch
    and the diagonal), the (R, K, ...) f64 buffer's adds, and the copy to
    the host (with the base score's add); seconds each, printed on one
    line."""
    from xgboost_tpu_torch.interpret import device as dv
    from xgboost_tpu_torch.ops import treeshap_cuda as tc

    R, F, K = X.shape[0], X.shape[1], bst.n_groups
    shape = (R, K, F + 1, F + 1) if interactions else (R, K, F + 1)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    Xd = bst._device_X(xtt.DMatrix(X))
    mark()
    tables = {g: dv.path_tables(t, w, F) for g, (t, w) in _groups(bst).items()}
    for t in tables.values():
        if t.buckets:
            t.packed(False, Xd.device)
            if interactions:
                t.packed(True, Xd.device)
    mark()
    parts = {}
    for g, t in tables.items():
        if interactions:
            out = tc.treeshap_cuda(Xd, t, True)
            phi = tc.treeshap_cuda(Xd, t)
            diag = torch.diagonal(out, dim1=1, dim2=2)
            diag.copy_(phi - (out.sum(dim=2) - diag))
            parts[g] = out
        else:
            parts[g] = tc.treeshap_cuda(Xd, t)
    mark()
    buf = torch.zeros(shape, dtype=torch.float64, device=Xd.device)
    for g, part in parts.items():
        buf[:, g] += part
    del parts
    mark()
    host = buf.cpu().numpy()
    base = np.asarray(bst.base_score, np.float64).reshape(-1)[:K]
    if interactions:
        host[:, :, F, F] += base[None, :]
    else:
        host[:, :, F] += base[None, :]
    mark()
    steps = dict(zip(("x_to_card", "tables", "k6", "buffer_adds",
                      "to_host"), np.diff(marks)))
    log(f"phase {label} split of a predict("
        f"{'pred_interactions' if interactions else 'pred_contribs'}=True) "
        f"call, {R} rows, each step ended by a synchronize: X to the card "
        f"{steps['x_to_card']:.4f} s, path tables and packing "
        f"{steps['tables']:.4f} s, K6 {steps['k6']:.4f} s, f64 buffer adds "
        f"{steps['buffer_adds']:.4f} s, copy to the host "
        f"{steps['to_host']:.4f} s (sum {sum(steps.values()):.4f} s)")
    del buf, host
    return steps


def _k6_against_plain(hist_cuda, label, bst, Xd, interactions=False):
    """Per output group: K6 on all rows against the plain version (over
    all rows, or the first 2^18 where all would take over 20 s; timed on
    that run), and K6 alone a launch and a call on all rows (and on the
    plain version's rows where those are fewer); the sums over the groups,
    the bounds, and the largest error."""
    from xgboost_tpu_torch.interpret import device as dv
    from xgboost_tpu_torch.ops import treeshap_cuda as tc

    R, F = Xd.shape
    res = dict(launch_ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               ops=0.0, err=0.0, tol=0.0, buckets=0, paths=0, max_m=0,
               plain_rows=R)
    plain_fn = (dv.shap_interactions_plain if interactions
                else dv.shap_values_plain)
    parts = [tb for tb in (dv.path_tables(t, w, F)
                           for t, w in _groups(bst).values()) if tb.buckets]
    # the plain version, chunk by chunk, until the budget runs out
    done, spent = 0, 0.0
    while done < R:
        hi = min(done + P18_PLAIN_CHUNK, R)
        for tables in parts:
            got = tc.treeshap_cuda(Xd[done:hi], tables, interactions)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain_fn(Xd[done:hi], tables)
            torch.cuda.synchronize()
            spent += time.perf_counter() - t0
            err, tol = _shap_close(got, want, label)
            res["err"], res["tol"] = max(res["err"], err), max(res["tol"],
                                                               tol)
            del got, want
        done = hi
        if done < R and spent * R / done > P18_PLAIN_BUDGET_S:
            break
    res["plain_rows"], res["plain_ms"] = done, spent * 1e3
    reps = 3 if interactions else 5
    for tables in parts:
        pk = tables.packed(interactions, Xd.device)
        res["launch_ms"] += cuda_ms(lambda: tc.launch(Xd, pk), reps=reps)
        res["call_ms"] += cuda_ms(
            lambda: tc.treeshap_cuda(Xd, tables, interactions), reps=reps)
        bound, res["bound_by"], ops = _k6_bound(tables, R, interactions)
        res["bound_ms"] += bound
        res["ops"] += ops
        res["buckets"] += len(pk.shapes)
        res["paths"] += sum(s[2] for s in pk.shapes)
        res["max_m"] = max(res["max_m"], pk.max_m)
    res["small_ms"], res["small_bound_ms"] = res["launch_ms"], \
        res["bound_ms"]
    if done < R:  # K6 on the plain version's rows, for the kernels line
        res["small_ms"] = sum(cuda_ms(lambda: tc.launch(
            Xd[:done], t.packed(interactions, Xd.device)), reps=reps)
            for t in parts)
        res["small_bound_ms"] = sum(_k6_bound(t, done, interactions)[0]
                                    for t in parts)
    return res


def _log_k6(label, what, R, call_s, launches, acc_err, r,
            key="treeshap"):
    plain = (f"plain {r['plain_ms']:.1f} ms (one run, all rows)"
             if r["plain_rows"] == R else
             f"plain {r['plain_ms']:.1f} ms on the first {r['plain_rows']} "
             f"rows (all would take over {P18_PLAIN_BUDGET_S:.0f} s), K6 "
             f"{r['small_ms']:.4f} ms on them, bound "
             f"{r['small_bound_ms']:.4f} ms")
    log(f"phase {label}: {what}, {R} rows: predict {call_s:.3f} s; K6 "
        f"{key} launches {launches[key]}; {r['buckets']} buckets, "
        f"{r['paths']} paths, m up to {r['max_m']}; K6 device "
        f"{r['launch_ms']:.4f} ms a launch (summed over the groups), "
        f"{r['call_ms']:.4f} ms a call (the wrapper's layout included); "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({r['ops']:.4g} f32 operations, unfused); local accuracy max |sum - "
        f"margin| {acc_err:.3g}; against the plain version over "
        f"{r['plain_rows']} rows: max |diff| {r['err']:.3g} (tolerance "
        f"{r['tol']:.3g}); {plain}")


def phase_shap(xtt, hist_cuda, f32, X, cover, Xc, lossguide, dart, gbl,
               cat):
    """Phase 18, interpretation on the card with the models earlier phases
    trained: exact SHAP values (18a) of the HIGGS model over 1M rows, the
    7-class Covertype model over its 581,012 rows, the lossguide and DART
    models over 2^16 rows; interactions (18b); Saabas, gblinear and the
    categorical host walk (18c); card against CPU (18d)."""
    out = {}
    # 18a
    for label, what, bst, rows in (
            ("18a HIGGS", "phase 3's f32 model, 10 x depth 6", f32["bst"], X),
            ("18a Covertype", "phase 8's f32 model, 7 classes x 5 rounds x "
             "depth 8", cover["hist_f32"]["bst"], Xc),
            ("18a lossguide", "phase 6's model, 10 x 255 leaves", lossguide,
             X[:P18_ROWS]),
            ("18a DART", "phase 17a's uniform/tree f32 model",
             dart[("uniform/tree", "f32")]["bst"], X[:P18_ROWS])):
        d, _, call_s, launches, acc = _shap_call(xtt, hist_cuda, label, bst,
                                                 rows)
        r = _k6_against_plain(hist_cuda, label, bst, bst._device_X(d))
        _log_k6(label, what, rows.shape[0], call_s, launches, acc, r)
        r.update(call_s=call_s, launches=launches["treeshap"])
        if label in ("18a HIGGS", "18a Covertype"):
            r["split"] = _call_split(xtt, bst, rows, label)
        out[label] = r
        del d
    # 18b
    bst = f32["bst"]
    label = "18b HIGGS interactions"
    d, inter, call_s, launches, acc = _shap_call(
        xtt, hist_cuda, label, bst, X[:P18_ROWS], interactions=True)
    contribs = bst.predict(d, pred_contribs=True)
    if not np.allclose(inter.sum(-1), contribs, rtol=3e-4, atol=5e-5):
        raise AssertionError(f"phase {label}: interactions do not sum to "
                             "the SHAP values (rtol 3e-4, atol 5e-5)")
    r = _k6_against_plain(hist_cuda, label, bst, bst._device_X(d),
                          interactions=True)
    _log_k6(label, "phase 3's model", P18_ROWS, call_s, launches, acc, r,
            key="treeshap_interactions")
    r["split"] = _call_split(xtt, bst, X[:P18_ROWS], label,
                             interactions=True)
    log(f"phase {label}: rows of the interactions sum to pred_contribs "
        f"within rtol 3e-4, atol 5e-5 (max |diff| "
        f"{np.abs(inter.sum(-1) - contribs).max():.3g})")
    r.update(call_s=call_s, launches=launches["treeshap_interactions"])
    out[label] = r
    del d, inter, contribs
    # 18c
    d = xtt.DMatrix(X)
    hist_cuda.reset_launches()
    t0 = time.perf_counter()
    saabas = bst.predict(d, pred_contribs=True, approx_contribs=True)
    torch.cuda.synchronize()
    saabas_s = time.perf_counter() - t0
    if any(hist_cuda.launches.values()):
        raise AssertionError(f"phase 18c: Saabas launched "
                             f"{hist_cuda.launches}")
    acc = _local_accuracy(saabas.sum(-1), bst.predict(d, output_margin=True),
                          "18c Saabas")
    log(f"phase 18c Saabas: {X.shape[0]} rows on the card {saabas_s:.3f} s; "
        f"max |sum - margin| {acc:.3g}")
    lin = gbl["17c binary:logistic coord_descent cyclic"]["bst"]
    t0 = time.perf_counter()
    lc = lin.predict(d, pred_contribs=True)
    lin_s = time.perf_counter() - t0
    acc = _local_accuracy(lc.sum(-1), lin.predict(d, output_margin=True),
                          "18c gblinear", rtol=1e-5, atol=1e-5)
    log(f"phase 18c gblinear: phase 17c's model, {X.shape[0]} rows "
        f"{lin_s:.3f} s; max |sum - margin| {acc:.3g}")
    del d, saabas, lc
    Xk, _ = make_criteo(2000, seed=7001)
    dk = xtt.DMatrix(Xk, feature_types=CRITEO_TYPES, enable_categorical=True)
    cb = cat["hist_f32"]["bst"]
    margin = cb.predict(dk, output_margin=True)
    for kw, what in ((dict(pred_contribs=True), "exact"),
                     (dict(pred_interactions=True), "interactions")):
        hist_cuda.reset_launches()
        t0 = time.perf_counter()
        got = cb.predict(dk, **kw)
        host_s = time.perf_counter() - t0
        if any(hist_cuda.launches.values()):
            raise AssertionError(f"phase 18c: the categorical host walk "
                                 f"launched {hist_cuda.launches}")
        acc = _local_accuracy(got.sum(-1) if what == "exact"
                              else got.sum((-2, -1)), margin,
                              f"18c Criteo {what}", rtol=1e-5, atol=1e-5)
        log(f"phase 18c Criteo {what}: phase 7's categorical model, 2000 "
            f"rows, host walk {host_s:.3f} s; max |sum - margin| {acc:.3g}")
    # 18d
    Xs = X[:P18_CARD_CPU_ROWS]
    cpu = xtt.Booster(model_file=bytearray(bst.save_raw("json")),
                      device="cpu")
    for kw, what in ((dict(pred_contribs=True), "exact"),
                     (dict(pred_contribs=True, approx_contribs=True),
                      "Saabas")):
        card = bst.predict(xtt.DMatrix(Xs), **kw)
        host = cpu.predict(xtt.DMatrix(Xs, device="cpu"), **kw)
        err = float(np.abs(card - host).max())
        same = bool(np.array_equal(card, host))
        tol = SHAP_REL * float(np.abs(host).max()) + SHAP_ABS
        if (what == "Saabas" and not same) or err > tol:
            raise AssertionError(f"phase 18d {what}: card and CPU differ by "
                                 f"{err:.3g} (bitwise: {same})")
        log(f"phase 18d {what}: {P18_CARD_CPU_ROWS} rows of phase 3's model, "
            f"card against the CPU: max |diff| {err:.3g} (tolerance "
            f"{'0' if what == 'Saabas' else f'{tol:.3g}'}), bitwise: {same}")
    return out


# ------------------------------------------------------------ out of core
# the criteo_extmem_40m row of BENCH_LADDER.json (scripts/bench_ladder.py:
# 604-637): 64 pages of 655,360 Criteo-shaped rows, max_bin 128 (uint8
# pages), depth 8, eta 0.3, 5 rounds
EXTMEM_PAGES = 64
EXTMEM_PAGE_ROWS = 655_360
EXTMEM_ROUNDS = 5
EXTMEM = dict(CRITEO)
EXTMEM_DET = dict(CRITEO_DET)
EXTMEM_DET_PAGES = 24  # 15,728,640 rows, under K2's MAX_ROWS = 2**24
EXTMEM_DET_ROUNDS = 3
EXTMEM_LADDER_AUC = 0.684014  # BENCH_LADDER.json, the JAX package on a CPU
# the JAX package's ladder row at its first 8 pages, on a CPU
# (scripts/extmem_reference_auc.py 8)
EXTMEM_REF_PAGES = 8
EXTMEM_REF_AUC = 0.945248
EXTMEM_AUC_TOL = 0.005


def make_extmem_pages(n_pages: int):
    """The ladder's pages, page i from seed 7000 + i (make_criteo is its
    generator), made by eight threads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(
            lambda i: make_criteo(EXTMEM_PAGE_ROWS, seed=7000 + i),
            range(n_pages)))


def _page_iter(xtt, pages):
    class Pages(xtt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= len(pages):
                return 0
            X, y = pages[self.i]
            input_data(data=X, label=y, feature_types=CRITEO_TYPES)
            self.i += 1
            return 1

    return Pages()


def _pinned_rate():
    """GB/s of one 256 MiB copy from pinned host memory to the card."""
    host = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps=10)
    del host, dev
    return (256 << 20) / ms / 1e6, ms


def _extmem_ingest(xtt, pages, label):
    t0 = time.perf_counter()
    d = xtt.ExtMemQuantileDMatrix(_page_iter(xtt, pages), max_bin=128,
                                  enable_categorical=True)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if len(d._pages) != len(pages) or not all(
            isinstance(p, torch.Tensor) and p.is_pinned()
            and p.dtype == torch.uint8 for p in d._pages):
        raise AssertionError(f"phase {label}: the pages are not {len(pages)}"
                             " pinned uint8 host tensors")
    log(f"phase {label} ingest: {len(pages)} pages x {EXTMEM_PAGE_ROWS} "
        f"rows x 39, {d.page_bytes()} page bytes pinned on the host; "
        f"{ingest_s:.3f} s (pass 1, the streaming sketch: "
        f"{d.ingest_seconds['sketch']:.3f} s; pass 2, bins on the card and "
        f"the pinned copy: {d.ingest_seconds['bin']:.3f} s)")
    return d, ingest_s


def _extmem_run(xtt, hist_cuda, d, params, rounds, kernel, label, yard):
    """The main path: ``rounds`` rounds over the pages, the launch counts
    and page counters set to 0 just before and read just after."""
    from xgboost_tpu_torch.data import extmem

    n_pages, depth = len(d._pages), params["max_depth"]
    extmem.reset_counters()
    hist_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bst = xtt.train(params, d, rounds, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(hist_cuda.launches)
    c = extmem.counters()
    peak = torch.cuda.max_memory_allocated()
    want = _sigmoid_launches(hist_cuda, rounds, evals=0)
    want[kernel] = n_pages * depth * rounds
    want["split_scan"] = depth * rounds
    if launches != want:
        raise AssertionError(f"phase {label}: launches {launches}, want "
                             f"{want} (pages x levels = {n_pages} x {depth} "
                             "a round)")
    per_page = d._pages[0].numel()
    page_bytes = d.page_bytes()
    streamed = c["xtb_extmem_page_bytes_total"] / rounds
    if streamed != (depth + 1) * page_bytes:
        raise AssertionError(f"phase {label}: {streamed} page bytes a round,"
                             f" want {depth + 1} passes of {page_bytes}")
    hwm = c["device_page_bytes_hwm"]
    # the histograms' least bytes a round, launch by launch as phase 2
    # counts them: one more round with each launch's rows counted
    sizes = _counted_round(xtt, hist_cuda, d, params, kernel)
    if len(sizes) != n_pages * depth:
        raise AssertionError(f"phase {label}: {len(sizes)} counted launches "
                             f"in a round, want {n_pages * depth}")
    bound_bytes = sum(sizes)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    if hwm > 3 * per_page:
        raise AssertionError(f"phase {label}: {hwm} page bytes resident on "
                             f"the card, more than lookahead + 1 = 3 pages")
    rate = streamed * rounds / train_s / 1e9
    log(f"phase {label} train: {n_pages} pages ({n_pages * EXTMEM_PAGE_ROWS}"
        f" rows), depth {depth}, {rounds} rounds; train loop {train_s:.3f} s "
        f"= {n_pages * EXTMEM_PAGE_ROWS * rounds / train_s / 1e6:.3f} M "
        f"row-rounds/s; page bytes streamed a round {streamed:.0f} "
        f"({depth + 1} passes of {page_bytes}), {rate:.3f} GB/s over the "
        f"loop against the pinned copy's {yard:.3f} GB/s, so the copies "
        f"alone bound a round at {streamed / yard / 1e6:.3f} ms; host "
        f"seconds staging pages {c['xtb_extmem_decode_seconds_total']:.3f},"
        f" waiting {c['xtb_extmem_wait_seconds_total']:.3f}, overlapped "
        f"{c['xtb_extmem_overlap_seconds_total']:.3f}; pages staged "
        f"{c['xtb_extmem_pages_loaded_total']:.0f}; page bytes resident on "
        f"the card at most {hwm} (3 pages of {per_page}); "
        f"max_memory_allocated {peak}; "
        f"{kernel} launches {launches[kernel]} ({n_pages} pages x {depth} "
        f"levels x {rounds}), K3 {launches['split_scan']}, K4 "
        f"{launches['sigmoid']}; the {kernel} launches of a round move at "
        f"least {bound_bytes / 1e6:.1f} MB, {bound_ms:.4f} ms "
        "at 3.35 TB/s")
    return dict(bst=bst, train_s=train_s, launches=launches[kernel],
                scan_launches=launches["split_scan"],
                sigmoid_launches=launches["sigmoid"], streamed=streamed)


def _round_seconds(xtt, d, params, rounds):
    """The wall seconds of each round of one ``train()``, the card
    synchronized at each round's start and end."""
    marks = []

    class Clock(xtt.TrainingCallback):
        def before_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return False

        def after_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            marks[-1] = time.perf_counter() - marks[-1]
            return False

    xtt.train(params, d, rounds, verbose_eval=False, callbacks=[Clock()])
    return marks


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(u, v):
    """The length of the intersection of two unions of intervals."""
    i = j = 0
    tot = 0.0
    while i < len(u) and j < len(v):
        tot += max(0.0, min(u[i][1], v[j][1]) - max(u[i][0], v[j][0]))
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _copy_overlap(xtt, d, params, rounds: int = 2):
    """The card's time copying pages host to device over ``rounds`` rounds
    (torch.profiler's device activity, read from its raw events), its time
    in kernels, and how much of the copy time a kernel ran beside, all
    ms."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xtt.train(params, d, rounds, verbose_eval=False)
        torch.cuda.synchronize()
    copies, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if "HtoD" in e.name():
            copies.append(iv)
        elif "Memcpy" not in e.name() and "Memset" not in e.name():
            kernels.append(iv)
    if not copies or not kernels:
        return None
    cu, ku = _union(copies), _union(kernels)
    span = lambda u: sum(b - a for a, b in u) / 1e6  # noqa: E731
    return span(cu), span(ku), _covered(cu, ku) / 1e6


def _extmem_overlap(xtt, d, params, label, rounds: int = 3):
    """Copy and compute with two pages in flight beside the same in series
    (_extmem_prefetch=0, one device slot): the wall seconds of rounds 2 and
    later of a ``rounds``-round ``train()``, in turns on, off, off, on; then
    on the profiler's device timeline, the share of the page copies' time a
    kernel ran beside, for each."""
    times = {"1": [], "0": []}
    for flag in ("1", "0", "0", "1"):
        times[flag] += _round_seconds(
            xtt, d, dict(params, _extmem_prefetch=flag), rounds)[1:]
    on, off = statistics.mean(times["1"]), statistics.mean(times["0"])
    share = {}
    for flag in ("1", "0"):
        ov = _copy_overlap(xtt, d, dict(params, _extmem_prefetch=flag))
        share[flag] = None if ov is None else ov[2] / ov[0]
        log(f"phase {label} overlap, _extmem_prefetch={flag}: "
            + ("the profiler saw no copy or no kernel (not measured)"
               if ov is None else
               f"2 rounds on the card: copies {ov[0]:.3f} ms, kernels "
               f"{ov[1]:.3f} ms, copy time beside a kernel {ov[2]:.3f} ms "
               f"= {share[flag]:.4f} of the copies"))
    log(f"phase {label} prefetch: a round (rounds 2-{rounds} of "
        f"{rounds}-round runs, in turns) {on:.4f} s with two pages in flight "
        f"({' '.join(f'{t:.4f}' for t in times['1'])}), {off:.4f} s with "
        f"copy and compute in series "
        f"({' '.join(f'{t:.4f}' for t in times['0'])}); the window saves "
        f"{off - on:.4f} s a round")
    if share["1"] is not None and share["0"] is not None \
            and not share["1"] > share["0"]:
        raise AssertionError(f"phase {label}: the copies overlap kernels no "
                             f"more with the window ({share['1']}) than in "
                             f"series ({share['0']})")
    return on, off, share


def phase_extmem(xtt, hist_cuda, pages):
    """19a: out-of-core training at the ladder's size."""
    from xgboost_tpu_torch.metric import auc

    yard, yard_ms = _pinned_rate()
    log(f"phase 19a yardstick: one 256 MiB copy from pinned host memory "
        f"{yard_ms:.4f} ms = {yard:.3f} GB/s")
    d, ingest_s = _extmem_ingest(xtt, pages, "19a")
    r = _extmem_run(xtt, hist_cuda, d, EXTMEM, EXTMEM_ROUNDS, "hist_f32",
                    "19a", yard)
    t0 = time.perf_counter()
    pred = r["bst"].predict(d)
    predict_s = time.perf_counter() - t0
    if pred.shape != (d.num_row(),) or not np.all(np.isfinite(pred)):
        raise AssertionError(f"phase 19a: predictions {pred.shape}")
    got = auc(pred[::8], d.label[::8].astype(np.float64))
    # the same rows in memory on the card
    X = np.concatenate([p[0] for p in pages])
    y = np.concatenate([p[1] for p in pages])
    din = xtt.DMatrix(X, label=y, feature_types=CRITEO_TYPES)
    del X
    incore = xtt.train(EXTMEM, din, EXTMEM_ROUNDS, verbose_eval=False)
    want = auc(incore.predict(din)[::8], y[::8].astype(np.float64))
    del din, incore
    # the reference on the same pages: its ladder row at the first pages
    d8 = xtt.ExtMemQuantileDMatrix(_page_iter(xtt, pages[:EXTMEM_REF_PAGES]),
                                   max_bin=128, enable_categorical=True)
    b8 = xtt.train(EXTMEM, d8, EXTMEM_ROUNDS, verbose_eval=False)
    got8 = auc(b8.predict(d8)[::8], d8.label[::8].astype(np.float64))
    d8.release_device()
    del d8, b8
    log(f"phase 19a quality: predict over the pages {predict_s:.3f} s; "
        f"AUC@stride8 {got:.6f}, in memory on the card {want:.6f} "
        f"(|diff| {abs(got - want):.6f}, gate {EXTMEM_AUC_TOL}); on the "
        f"first {EXTMEM_REF_PAGES} pages {got8:.6f}, the reference's ladder "
        f"row there {EXTMEM_REF_AUC} (|diff| "
        f"{abs(got8 - EXTMEM_REF_AUC):.6f}, gate {EXTMEM_AUC_TOL}); "
        f"BENCH_LADDER.json's 64-page {EXTMEM_LADDER_AUC} (|diff| "
        f"{abs(got - EXTMEM_LADDER_AUC):.6f}, not a gate: ROADMAP Queue 3)")
    if not abs(got - want) <= EXTMEM_AUC_TOL:
        raise AssertionError(f"phase 19a: AUC {got} against {want} in "
                             "memory")
    if not abs(got8 - EXTMEM_REF_AUC) <= EXTMEM_AUC_TOL:
        raise AssertionError(f"phase 19a: AUC {got8} on {EXTMEM_REF_PAGES} "
                             f"pages against the reference's "
                             f"{EXTMEM_REF_AUC}")
    r["on_s"], r["off_s"], r["overlap"] = _extmem_overlap(xtt, d, EXTMEM,
                                                          "19a")
    phase_profile(xtt, d, EXTMEM, "19a (out of core)")
    r.update(auc=got, incore_auc=want, ingest_s=ingest_s, yard=yard, dmat=d)
    d.release_device()
    return r


def phase_extmem_det(xtt, hist_cuda, pages, yard):
    """19b: deterministic_histogram=1 on the pages given (the first 24)."""
    d, _ = _extmem_ingest(xtt, pages, "19b")
    r = _extmem_run(xtt, hist_cuda, d, EXTMEM_DET, EXTMEM_DET_ROUNDS,
                    "hist_q", "19b", yard)
    again = xtt.train(EXTMEM_DET, d, EXTMEM_DET_ROUNDS, verbose_eval=False)
    if _model_bytes(again) != _model_bytes(r["bst"]):
        raise AssertionError("phase 19b: two deterministic runs wrote "
                             "different models")
    log("phase 19b: two deterministic runs byte-identical")
    _extmem_overlap(xtt, d, EXTMEM_DET, "19b")
    phase_profile(xtt, d, EXTMEM_DET, "19b (out of core, deterministic)")
    d.release_device()
    return r


def phase_extmem_parity(xtt, pages):
    """19c: four pages in memory and out of core on the same cuts."""
    import scipy.sparse as sp

    four = pages[:4]
    X = np.concatenate([p[0] for p in four])
    y = np.concatenate([p[1] for p in four])
    qd = xtt.QuantileDMatrix(X, label=y, max_bin=128,
                             feature_types=CRITEO_TYPES,
                             enable_categorical=True)
    ext = xtt.ExtMemQuantileDMatrix(_page_iter(xtt, four), max_bin=128,
                                    ref=qd)
    a = xtt.train(EXTMEM_DET, qd, 3, verbose_eval=False)
    b = xtt.train(EXTMEM_DET, ext, 3, verbose_eval=False)
    if _model_bytes(a) != _model_bytes(b):
        raise AssertionError("phase 19c: the deterministic model out of "
                             "core is not the in-memory one")
    diff = np.abs(b.predict(ext) - a.predict(qd)).max()
    if diff > 1e-6:
        raise AssertionError(f"phase 19c: predictions differ by {diff}")
    fa = xtt.train(EXTMEM, qd, 3, verbose_eval=False)
    fb = xtt.train(EXTMEM, ext, 3, verbose_eval=False)
    first = _same_or_near_tie(
        fb, fa, "19c", 1,
        lambda: np.abs(fb.predict(ext) - fa.predict(qd)).max(), 1e-4,
        "f32 out of core vs in memory", X)

    class Csr(xtt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= len(four):
                return 0
            Xp, yp = four[self.i]
            # a stored zero is a value: CSR of the non-missing entries
            rows, cols = np.nonzero(~np.isnan(Xp))
            input_data(data=sp.csr_matrix((Xp[rows, cols], (rows, cols)),
                                          shape=Xp.shape), label=yp,
                       feature_types=CRITEO_TYPES)
            self.i += 1
            return 1

    spm = xtt.SparsePageDMatrix(Csr(), max_bin=128, ref=qd)
    sdiff = np.abs(a.predict(spm) - a.predict(qd)).max()
    if sdiff > 1e-6:
        raise AssertionError(f"phase 19c: raw-page predictions differ by "
                             f"{sdiff}")
    log(f"phase 19c parity: {X.shape[0]} rows in 4 pages on the cuts of the "
        f"in-memory QuantileDMatrix; deterministic models byte-identical, "
        f"predictions within {diff:.3g}; f32 "
        + ("the same trees" if first is None else f"first apart at {first}")
        + f"; SparsePageDMatrix raw-page predictions within {sdiff:.3g} of "
        "the in-memory ones")
    ext.release_device()


def phase_extmem_cpu(xtt):
    """19d: 20,000 rows in 4 pages, deterministic, card against CPU."""
    X, y = make_criteo(20_000, seed=7100)
    cut = [0, 4000, 9000, 15000, 20_000]
    batches = [(X[a:b], y[a:b]) for a, b in zip(cut, cut[1:])]
    card = xtt.ExtMemQuantileDMatrix(_page_iter(xtt, batches), max_bin=128,
                                     enable_categorical=True)
    cpu = xtt.ExtMemQuantileDMatrix(_page_iter(xtt, batches), max_bin=128,
                                    enable_categorical=True, device="cpu",
                                    compress=False)
    got = xtt.train(EXTMEM_DET, card, 5, verbose_eval=False)
    want = xtt.train(EXTMEM_DET, cpu, 5, verbose_eval=False, device="cpu")
    if _model_bytes(got) != _model_bytes(want):
        raise AssertionError("phase 19d: the card's model JSON is not the "
                             "CPU's")
    if not np.array_equal(got.predict(card), want.predict(cpu)):
        raise AssertionError("phase 19d: predictions differ")
    log("phase 19d parity: 20000 rows in 4 pages, depth 8, 5 rounds, "
        "deterministic: the card's model JSON byte-identical to the CPU's, "
        "predictions equal")
    card.release_device()


def phase_19(xtt, hist_cuda, n_pages: int = EXTMEM_PAGES):
    """Phases 19a-19d at ``n_pages`` of the ladder's pages (19b on at most
    EXTMEM_DET_PAGES of them).  Returns what phase 21 holds its ranks
    against: the pages, 19a's matrix, AUC and round seconds, and 19b's
    model JSON."""
    t0 = time.perf_counter()
    pages = make_extmem_pages(n_pages)
    log(f"phase 19 data: {n_pages} pages of {EXTMEM_PAGE_ROWS} rows made in "
        f"{time.perf_counter() - t0:.3f} s")
    ext = timed("19a", phase_extmem, xtt, hist_cuda, pages)
    det = timed("19b", phase_extmem_det, xtt, hist_cuda,
                pages[:EXTMEM_DET_PAGES], ext["yard"])
    timed("19c", phase_extmem_parity, xtt, pages)
    timed("19d", phase_extmem_cpu, xtt)
    return dict(pages=pages, dmat=ext["dmat"], auc=ext["auc"],
                round_s=ext["train_s"] / EXTMEM_ROUNDS,
                det_json=_model_bytes(det["bst"]))


# ----------------------------------------------------------------- phase 20
P20 = BASE  # the HIGGS shape: binary:logistic, max_bin 256, depth 6
P20_DET = DET
P20_ROWS = 1 << 20  # rows a rank in 20a
P20_ROUNDS = 5
P20_CPU_ROWS = 16_384  # rows a rank in 20b
P20_PROC_ROWS = 262_144  # rows a rank in 20c
P20_PROC_ROUNDS = 3
P20_AUC_TOL = 0.005


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _rank_threads(group, fn, world: int = 2, timeout: float = 600.0):
    """``fn(rank)`` in ``world`` threads, each a rank of an in-memory
    collective group: the results by rank.  A rank's failure fails the
    phase (its peers' collectives raise, the CommunicatorContext aborting
    the group); so does a rank still running at ``timeout``."""
    from xgboost_tpu_torch import collective

    out, errs = {}, {}

    def worker(r):
        try:
            with collective.CommunicatorContext(
                    dmlc_communicator="in-memory", in_memory_world_size=world,
                    in_memory_rank=r, in_memory_group=group):
                out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs[r] = e

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{group}: a rank is still running after "
                             f"{timeout} s")
    if errs:
        raise errs[min(errs)]
    return [out[r] for r in range(world)]


def _rank_train(xtt, hist_cuda, shards, params, rounds, group,
                device="cuda", timed_repeat=True, dmats=None):
    """Each shard a rank (a thread of this process, all on ``device``):
    the distributed sketch and bins (or the rank's matrix of ``dmats``,
    binned already), then ``rounds`` rounds of training, the second run
    timed (the first plans the kernels' launches).  By rank: the model JSON, the sketch seconds, the timed run's
    seconds, its launches (the thread's own counts), the host exchange's
    parts, the booster and the matrix."""
    def fn(r):
        X, y = shards[r]
        t0 = time.perf_counter()
        d = dmats[r] if dmats else xtt.DMatrix(X, label=y, device=device)
        d.ensure_ellpack(max_bin=params["max_bin"], distributed=True)
        _sync(device)
        ingest_s = time.perf_counter() - t0
        if timed_repeat:
            xtt.train(params, d, rounds, verbose_eval=False)
        before = dict(hist_cuda.thread_launches())
        t0 = time.perf_counter()
        bst = xtt.train(params, d, rounds, verbose_eval=False)
        _sync(device)
        train_s = time.perf_counter() - t0
        mine = {k: v - before[k]
                for k, v in hist_cuda.thread_launches().items()}
        return dict(json=_model_bytes(bst), ingest_s=ingest_s,
                    train_s=train_s, launches=mine,
                    exchange=dict(bst._grower.exchange.stats), bst=bst,
                    dmat=d)

    return _rank_threads(group, fn)


def _threads_alone(xtt, dmats, params, rounds):
    """Each matrix trained alone (no collective, one model a thread) in a
    thread of its own, the threads started together: the seconds of the
    slower thread's ``rounds`` rounds.  The ranks' round without their
    exchange: what the two threads' level loops cost side by side."""
    start, secs, errs = threading.Barrier(len(dmats)), {}, {}

    def worker(i):
        try:
            start.wait(timeout=60)
            t0 = time.perf_counter()
            xtt.train(params, dmats[i], rounds, verbose_eval=False)
            torch.cuda.synchronize()
            secs[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - raised below
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(dmats))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"threads alone: {errs or 'still running'}")
    return max(secs.values())


def _exchange_line(stats, rounds, round_s):
    per = {k: stats[k] / rounds * 1e3 for k in ("d2h_s", "gather_s",
                                                "sum_s", "h2d_s")}
    total = sum(per.values())
    return (f"{stats['calls'] // rounds} exchanges a round, "
            f"{stats['bytes'] / rounds / 1e6:.3f} MB a round from a rank; "
            f"a round's exchange {total:.3f} ms = device-to-host "
            f"{per['d2h_s']:.3f} + gather {per['gather_s']:.3f} + sum "
            f"{per['sum_s']:.3f} + host-to-device {per['h2d_s']:.3f}; "
            f"{100 * total / (round_s * 1e3):.2f}% of the round"), total


def phase_distributed(xtt, hist_cuda, smi, X, y, label, params, kernel):
    """20a on one histogram path: two in-memory ranks of P20_ROWS rows on
    the card, P20_ROUNDS rounds."""
    from xgboost_tpu_torch.metric import auc

    shards = [(X[:P20_ROWS], y[:P20_ROWS]), (X[P20_ROWS:], y[P20_ROWS:])]
    rounds, depth = P20_ROUNDS, params["max_depth"]
    hist_cuda.reset_launches()  # the main path's run: counts from 0
    ranks = _rank_train(xtt, hist_cuda, shards, params, rounds,
                        f"p20a-{kernel}")
    total = dict(hist_cuda.launches)
    if ranks[0]["json"] != ranks[1]["json"]:
        raise AssertionError(f"phase {label}: the two ranks' models differ")
    want = depth * rounds
    per_rank = _sigmoid_launches(hist_cuda, rounds, evals=0)
    per_rank[kernel] = per_rank["split_scan"] = want
    for r, rk in enumerate(ranks):
        if rk["launches"] != per_rank:
            raise AssertionError(
                f"phase {label}: rank {r} launched {rk['launches']} in its "
                f"timed run, want {per_rank}")
    # the main path's two runs (warm-up and timed) on both ranks
    if total[kernel] != 2 * 2 * want:
        raise AssertionError(f"phase {label}: {total[kernel]} {kernel} "
                             f"launches over both ranks' two runs, want "
                             f"{4 * want}")
    two_round = max(rk["train_s"] for rk in ranks) / rounds
    # the device's share of the two ranks' time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _rank_train(xtt, hist_cuda, shards, params, 2,
                    f"p20a-{kernel}-profile",
                    dmats=[rk["dmat"] for rk in ranks], timed_repeat=False)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, prof_ms, f"{label} (two ranks)",
                 "2 rounds at two ranks, each rank's train() whole", top=6)
    # one rank: the union of the shards, and one shard alone
    d_union = xtt.DMatrix(X, label=y)
    d_union.ensure_ellpack(max_bin=params["max_bin"])
    xtt.train(params, d_union, 1, verbose_eval=False)
    t0 = time.perf_counter()
    union = xtt.train(params, d_union, rounds, verbose_eval=False)
    torch.cuda.synchronize()
    union_round = (time.perf_counter() - t0) / rounds
    d_one = xtt.DMatrix(*shards[0])
    d_one.ensure_ellpack(max_bin=params["max_bin"])
    xtt.train(params, d_one, 1, verbose_eval=False)
    t0 = time.perf_counter()
    xtt.train(params, d_one, rounds, verbose_eval=False)
    torch.cuda.synchronize()
    one_round = (time.perf_counter() - t0) / rounds
    # the two shards' level loops side by side, with no collective
    alone = [xtt.DMatrix(*sh) for sh in shards]
    for d in alone:
        d.ensure_ellpack(max_bin=params["max_bin"])
        xtt.train(params, d, 1, verbose_eval=False)
    alone_round = _threads_alone(xtt, alone, params, rounds) / rounds
    del alone
    got_auc = auc(ranks[0]["bst"].predict(d_union)[::4],
                  y[::4].astype(np.float64))
    want_auc = auc(union.predict(d_union)[::4], y[::4].astype(np.float64))
    del d_union, d_one
    line, exch_ms = _exchange_line(ranks[0]["exchange"], rounds, two_round)
    log(f"phase {label} distributed ({smi}): 2 in-memory ranks x "
        f"{P20_ROWS} rows x {X.shape[1]} on one card, {rounds} rounds; "
        f"distributed sketch + bins {ranks[0]['ingest_s']:.3f} / "
        f"{ranks[1]['ingest_s']:.3f} s a rank; a round at two ranks "
        f"{two_round * 1e3:.3f} ms, at one rank on the union "
        f"{union_round * 1e3:.3f} ms, at one rank on one shard "
        f"{one_round * 1e3:.3f} ms, two threads each training a shard "
        f"alone at once {alone_round * 1e3:.3f} ms; the two ranks' models "
        f"byte-identical; "
        f"{kernel} and K3 launched {want} a rank ({depth} a round a rank), "
        f"K4 {per_rank['sigmoid']}, {total[kernel]} {kernel} over both "
        f"ranks' two runs; AUC@stride4 on the "
        f"union {got_auc:.6f}, one rank trained on the union "
        f"{want_auc:.6f} (|diff| {abs(got_auc - want_auc):.6f}, gate "
        f"{P20_AUC_TOL})")
    log(f"phase {label} exchange at two ranks (rank 0): {line}")
    if not abs(got_auc - want_auc) <= P20_AUC_TOL:
        raise AssertionError(f"phase {label}: AUC {got_auc} at two ranks "
                             f"against {want_auc} at one")
    return dict(two_round=two_round,
                alone_round=alone_round, union_round=union_round,
                one_round=one_round, exchange_ms=exch_ms,
                launches=total[kernel], auc=got_auc)


def phase_distributed_cpu(xtt, hist_cuda, smi):
    """20b: deterministic, two in-memory ranks of P20_CPU_ROWS rows on the
    card and on the CPU: the same model bytes."""
    X, y = make_data(2 * P20_CPU_ROWS, 28, seed=2001)
    shards = [(X[:P20_CPU_ROWS], y[:P20_CPU_ROWS]),
              (X[P20_CPU_ROWS:], y[P20_CPU_ROWS:])]
    card = _rank_train(xtt, hist_cuda, shards, P20_DET, P20_ROUNDS,
                       "p20b-card", timed_repeat=False)
    cpu = _rank_train(xtt, hist_cuda, shards, dict(P20_DET, device="cpu"),
                      P20_ROUNDS, "p20b-cpu", device="cpu",
                      timed_repeat=False)
    if not (card[0]["json"] == card[1]["json"] == cpu[0]["json"]
            == cpu[1]["json"]):
        raise AssertionError("phase 20b: the card's two-rank model JSON is "
                             "not the CPU's")
    log(f"phase 20b parity ({smi}): 2 ranks x {P20_CPU_ROWS} rows, "
        f"{P20_ROUNDS} rounds, deterministic: the card's model JSON "
        "byte-identical to the CPU's, on every rank")


def _p20c_shards():
    """20c's two shards of P20_PROC_ROWS HIGGS rows (22's too)."""
    X, y = make_data(2 * P20_PROC_ROWS, 28, seed=2002)
    return [(X[:P20_PROC_ROWS], y[:P20_PROC_ROWS]),
            (X[P20_PROC_ROWS:], y[P20_PROC_ROWS:])]


def phase_distributed_procs(xtt, hist_cuda, smi):
    """20c: train_distributed, two tracker-ranked worker processes on the
    one card, deterministic; the same bytes as two in-memory ranks here,
    whose model JSON it returns."""
    shards = _p20c_shards()
    t0 = time.perf_counter()
    out = xtt.train_distributed(P20_DET, shards,
                                num_boost_round=P20_PROC_ROUNDS,
                                eval_train=True, timeout=300)
    job_s = time.perf_counter() - t0
    mem = _rank_train(xtt, hist_cuda, shards, P20_DET, P20_PROC_ROUNDS,
                      "p20c-memory", timed_repeat=False)
    got = _model_bytes(out["booster"])
    if got != mem[0]["json"]:
        raise AssertionError("phase 20c: the workers' model is not the "
                             "in-memory ranks'")
    final = {m: v[-1] for m, v in out["history"]["train"].items()}
    log(f"phase 20c processes ({smi}): train_distributed, 2 tracker-ranked "
        f"worker processes (gloo at the tracker's coordinator) on one card "
        f"x {P20_PROC_ROWS} rows, {P20_PROC_ROUNDS} "
        f"rounds, deterministic: {job_s:.3f} s for the job (the workers' "
        f"start, rendezvous, sketch and training); model bytes equal to 2 "
        f"in-memory ranks' on the same shards; rank 0's train {final}")
    return mem[0]["json"]


def phase_20(xtt, hist_cuda, smi):
    """Phases 20a-20c: data-parallel training across ranks on one card;
    20c's in-memory ranks' model JSON."""
    X, y = make_data(2 * P20_ROWS, 28, seed=2000)
    timed("20a", phase_distributed, xtt, hist_cuda, smi, X, y, "20a",
          P20, "hist_f32")
    timed("20a deterministic", phase_distributed, xtt, hist_cuda, smi, X, y,
          "20a deterministic", P20_DET, "hist_q")
    del X, y
    timed("20b", phase_distributed_cpu, xtt, hist_cuda, smi)
    return timed("20c", phase_distributed_procs, xtt, hist_cuda, smi)


# ----------------------------------------------------------------- phase 21
P21_ROWS = 1 << 14  # rows a rank in 21c (exact's host enumeration)
P21_EXACT_ROUNDS = 2
P21_UPDATE_ROUNDS = 5
P21_CPU_CUT = (0, 4000, 9000, 15_000, 20_000)  # 21d's 4 pages, as 19d's


def _p21_config(xtt, pages, device=None):
    """ExtMemConfig over ``pages``, a shard a page, round robin."""
    def data_fn(smap, rank, world):
        return _page_iter(xtt, [pages[i] for i in smap.shards_of(rank)])

    return xtt.ExtMemConfig(data_fn, num_shards=len(pages), max_bin=128,
                            compress=False, enable_categorical=True)


def _p21_ranks(xtt, hist_cuda, make_dtrain, params, rounds, group,
               device="cuda", **train_kw):
    """Each rank a thread: ``train(params, make_dtrain(rank), rounds)``
    once, timed round by round (the card synchronized at each round's
    start and end).  By rank: the model JSON, the round seconds, the
    thread's launches, the training matrix, the booster and, out of core,
    the host exchange's parts."""
    def fn(r):
        marks = []

        class Clock(xtt.TrainingCallback):
            def before_iteration(self, model, epoch, evals_log):
                _sync(device)
                marks.append(time.perf_counter())
                return False

            def after_iteration(self, model, epoch, evals_log):
                _sync(device)
                marks[-1] = time.perf_counter() - marks[-1]
                return False

        before = dict(hist_cuda.thread_launches())
        t0 = time.perf_counter()
        bst = xtt.train(params, make_dtrain(r), rounds, verbose_eval=False,
                        callbacks=[Clock()], **train_kw)
        _sync(device)
        total_s = time.perf_counter() - t0
        mine = {k: v - before[k]
                for k, v in hist_cuda.thread_launches().items()}
        dmat = next(iter(bst._caches.values())).dmat
        growers = list(bst._stream_growers.values())
        return dict(json=_model_bytes(bst), rounds=marks, total_s=total_s,
                    launches=mine, dmat=dmat, bst=bst,
                    exchange=(dict(growers[0].exchange.stats) if growers
                              else None))

    return _rank_threads(group, fn)


def _cuts_bytes(cuts) -> bytes:
    return b"".join(np.ascontiguousarray(getattr(cuts, f)).tobytes()
                    for f in ("cut_ptrs", "cut_values", "min_vals"))


def _p21_pages(xtt, hist_cuda, smi, ref, pages, params, rounds, kernel,
               label):
    """Two thread ranks through train(params, ExtMemConfig(...)) on the
    card, each on its half of ``pages``: the ranks' bytes equal, each
    rank's launches pages x levels a round, the page bytes streamed a
    round every rank's pages (depth + 1) times."""
    from xgboost_tpu_torch.data import extmem

    depth = params["max_depth"]
    extmem.reset_counters()
    hist_cuda.reset_launches()  # the main path's run: counts from 0
    ranks = _p21_ranks(xtt, hist_cuda, lambda r: _p21_config(xtt, pages),
                       params, rounds, f"p21-{label}")
    total = dict(hist_cuda.launches)
    streamed = extmem.counters()["xtb_extmem_page_bytes_total"] / rounds
    if ranks[0]["json"] != ranks[1]["json"]:
        raise AssertionError(f"phase {label}: the two ranks' models differ")
    for r, rk in enumerate(ranks):
        n = len(rk["dmat"]._pages)
        want = _sigmoid_launches(hist_cuda, rounds, evals=0)
        want[kernel] = n * depth * rounds
        want["split_scan"] = depth * rounds
        if rk["launches"] != want:
            raise AssertionError(f"phase {label}: rank {r} launched "
                                 f"{rk['launches']}, want {want} ({n} pages "
                                 f"x {depth} levels a round)")
    if total[kernel] != len(pages) * depth * rounds:
        raise AssertionError(f"phase {label}: {total[kernel]} {kernel} "
                             f"launches over both ranks, want "
                             f"{len(pages) * depth * rounds}")
    page_bytes = sum(rk["dmat"].page_bytes() for rk in ranks)
    if streamed != (depth + 1) * page_bytes:
        raise AssertionError(f"phase {label}: {streamed} page bytes a round,"
                             f" want {depth + 1} passes of {page_bytes}")
    # rounds 2 and later (the first plans the kernels' launches); the mean
    # of all rounds as 19a's train loop counts them
    round_s = max(statistics.median(rk["rounds"][1:]) for rk in ranks)
    mean_s = max(sum(rk["rounds"]) / rounds for rk in ranks)
    line, _ = _exchange_line(ranks[0]["exchange"], rounds, round_s)
    log(f"phase {label} ({smi}): train(params, ExtMemConfig(...)) at 2 "
        f"in-memory ranks on one card, {len(pages)} pages ({len(pages)} "
        f"shards, {len(ranks[0]['dmat']._pages)} a rank, round robin), "
        f"depth {depth}, {rounds} rounds; a rank's train() "
        f"{ranks[0]['total_s']:.3f} / {ranks[1]['total_s']:.3f} s, its "
        f"ingest inside; a round (median of rounds 2-{rounds}, the slower "
        f"rank) {round_s * 1e3:.3f} ms ("
        + " ".join(f"{t * 1e3:.3f}" for t in ranks[0]["rounds"])
        + f" on rank 0), the mean of all rounds {mean_s * 1e3:.3f} ms "
        f"against one rank's on all the pages {ref['round_s'] * 1e3:.3f} ms "
        f"(19a's train loop over its rounds); the ranks' models "
        f"byte-identical; {kernel} "
        f"{ranks[0]['launches'][kernel]} + {ranks[1]['launches'][kernel]} "
        f"(pages x {depth} levels x {rounds} a rank), K3 "
        f"{ranks[0]['launches']['split_scan']} a rank, K4 "
        f"{ranks[0]['launches']['sigmoid']} a rank; page bytes streamed a "
        f"round {streamed:.0f} ({depth + 1} passes of {page_bytes})")
    log(f"phase {label} exchange at two ranks (rank 0): {line}")
    return ranks, round_s


def phase_extmem_ranks(xtt, hist_cuda, smi, ref):
    """21a: the 64 pages of 19a at two ranks, f32."""
    from xgboost_tpu_torch.metric import auc

    ranks, round_s = _p21_pages(xtt, hist_cuda, smi, ref, ref["pages"],
                                EXTMEM, EXTMEM_ROUNDS, "hist_f32", "21a")
    d19 = ref["dmat"]
    for r, rk in enumerate(ranks):
        if _cuts_bytes(rk["dmat"]._cuts) != _cuts_bytes(d19._cuts):
            raise AssertionError(f"phase 21a: rank {r}'s cuts are not 19a's "
                                 "one-rank cuts of the same pages")
        rk["dmat"].release_device()
    pred = ranks[0]["bst"].predict(d19)
    d19.release_device()
    if pred.shape != (d19.num_row(),) or not np.all(np.isfinite(pred)):
        raise AssertionError(f"phase 21a: predictions {pred.shape}")
    got = auc(pred[::8], d19.label[::8].astype(np.float64))
    log(f"phase 21a quality: the ranks' cuts byte-identical to 19a's; "
        f"AUC@stride8 over the {len(ref['pages'])} pages {got:.6f}, 19a's "
        f"one rank "
        f"{ref['auc']:.6f} (|diff| {abs(got - ref['auc']):.6f}, gate "
        f"{EXTMEM_AUC_TOL})")
    if not abs(got - ref["auc"]) <= EXTMEM_AUC_TOL:
        raise AssertionError(f"phase 21a: AUC {got} at two ranks against "
                             f"{ref['auc']} at one")
    return dict(launches=ranks[0]["launches"]["hist_f32"], round_s=round_s,
                auc=got)


def phase_extmem_ranks_det(xtt, hist_cuda, smi, ref):
    """21b: 19b's first EXTMEM_DET_PAGES pages at two ranks,
    deterministic: 19b's bytes."""
    ranks, _ = _p21_pages(xtt, hist_cuda, smi, ref,
                          ref["pages"][:EXTMEM_DET_PAGES], EXTMEM_DET,
                          EXTMEM_DET_ROUNDS, "hist_q", "21b")
    for rk in ranks:
        rk["dmat"].release_device()
    if ranks[0]["json"] != ref["det_json"]:
        raise AssertionError("phase 21b: the two ranks' deterministic model "
                             "is not 19b's one-rank model")
    log(f"phase 21b: {EXTMEM_DET_PAGES} pages at two ranks, deterministic: "
        "the model JSON byte-identical to 19b's at one rank")


def _p21_splits(bst) -> int:
    return sum(int((t.left_children != -1).sum()) for t in bst.trees)


def phase_exact_update_ranks(xtt, hist_cuda, smi):
    """21c: exact and process_type="update" at two ranks of P21_ROWS HIGGS
    rows on the card."""
    X, y = make_data(2 * P21_ROWS, 28, seed=2100)
    shards = [(X[:P21_ROWS], y[:P21_ROWS]), (X[P21_ROWS:], y[P21_ROWS:])]

    def dmat(r):
        return xtt.DMatrix(*shards[r])

    exact = dict(BASE, tree_method="exact")
    rounds = P21_EXACT_ROUNDS
    hist_cuda.reset_launches()
    ranks = _p21_ranks(xtt, hist_cuda, dmat, exact, rounds, "p21c-exact")
    want = _sigmoid_launches(hist_cuda, rounds, evals=0)
    for r, rk in enumerate(ranks):
        if rk["launches"] != want:
            raise AssertionError(f"phase 21c exact: rank {r} launched "
                                 f"{rk['launches']}, want {want}")
    t0 = time.perf_counter()
    union = xtt.train(exact, xtt.DMatrix(X, label=y), rounds,
                      verbose_eval=False)
    union_s = time.perf_counter() - t0
    if not ranks[0]["json"] == ranks[1]["json"] == _model_bytes(union):
        raise AssertionError("phase 21c exact: the two ranks' models are not "
                             "one rank's on the union")
    log(f"phase 21c exact ({smi}): 2 in-memory ranks x {P21_ROWS} rows x 28, "
        f"depth 6, {rounds} rounds, every rank enumerating both ranks' rows: "
        f"a round {max(max(rk['rounds']) for rk in ranks):.3f} s at two "
        f"ranks (the slower), one rank on the union {union_s / rounds:.3f} s;"
        f" the ranks' models byte-identical to one rank's on the union; K4 "
        f"{want['sigmoid']} a rank, K1-K3 0")
    # update: a 5-round model of the union, refreshed at the ranks
    base = xtt.train(BASE, xtt.DMatrix(X, label=y), P21_UPDATE_ROUNDS,
                     verbose_eval=False)
    raw = bytes(base.save_raw("json"))
    gains = [float(t.loss_changes[n]) for t in base.trees
             for n in range(t.n_nodes) if t.left_children[n] != -1]
    upd = dict(BASE, process_type="update", updater="refresh,prune,sync",
               gamma=float(np.median(gains)))
    hist_cuda.reset_launches()
    ranks = _p21_ranks(xtt, hist_cuda, dmat, upd, P21_UPDATE_ROUNDS,
                       "p21c-update", xgb_model=bytearray(raw))
    want = {k: 0 for k in hist_cuda.launches}
    want["sigmoid"] = P21_UPDATE_ROUNDS  # one gradient a round
    for r, rk in enumerate(ranks):
        if rk["launches"] != want:
            raise AssertionError(f"phase 21c update: rank {r} launched "
                                 f"{rk['launches']}, want {want}")
    if ranks[0]["json"] != ranks[1]["json"]:
        raise AssertionError("phase 21c update: the two ranks' models "
                             "differ")
    got = ranks[0]["bst"]
    if got.num_boosted_rounds() != P21_UPDATE_ROUNDS or \
            not _p21_splits(got) < _p21_splits(base):
        raise AssertionError("phase 21c update: no split pruned, or the "
                             "rounds changed")
    one = xtt.train(upd, xtt.DMatrix(X, label=y), P21_UPDATE_ROUNDS,
                    verbose_eval=False, xgb_model=bytearray(raw))
    dx = xtt.DMatrix(X)
    diff = float(np.abs(got.predict(dx) - one.predict(dx)).max())
    log(f"phase 21c update ({smi}): refresh,prune,sync over a "
        f"{P21_UPDATE_ROUNDS}-round model at 2 ranks x {P21_ROWS} rows, "
        f"gamma {upd['gamma']:.6g}: a round "
        f"{max(max(rk['rounds']) for rk in ranks):.3f} s; the ranks' models "
        f"byte-identical; splits {_p21_splits(base)} -> {_p21_splits(got)} "
        f"({_p21_splits(one)} at one rank on the union); max |pred diff| "
        f"against one rank on the union {diff:.3g} (f64 node sums in "
        f"another order, not a gate); K4 {want['sigmoid']} a rank, K1-K3 0")


def _p21_cpu_pages():
    X, y = make_criteo(P21_CPU_CUT[-1], seed=7100)
    return [(X[a:b], y[a:b]) for a, b in zip(P21_CPU_CUT, P21_CPU_CUT[1:])]


def _p21_part(rank: int, device=None):
    """A train_distributed worker's part in 21d: its pages of 21d's rows
    (``ShardMap`` round robin) as an ExtMemQuantileDMatrix on ``device``
    (None: the card)."""
    import xgboost_tpu_torch as xtt

    pages = _p21_cpu_pages()
    mine = xtt.ShardMap.create(len(pages), 2).shards_of(rank)
    return xtt.ExtMemQuantileDMatrix(
        _page_iter(xtt, [pages[i] for i in mine]), max_bin=128,
        compress=False, enable_categorical=True, device=device)


def phase_extmem_ranks_cpu(xtt, hist_cuda, smi):
    """21d: 20,000 rows in 4 pages, deterministic, at two ranks on the card
    and on the CPU, at one rank on the card, and in two gloo worker
    processes: one model."""
    import functools

    import chip_smoke as module  # the parts unpickle by this import path

    pages = _p21_cpu_pages()
    card = _p21_ranks(xtt, hist_cuda, lambda r: _p21_config(xtt, pages),
                      EXTMEM_DET, 5, "p21d-card")
    cpu = _p21_ranks(xtt, hist_cuda, lambda r: _p21_config(xtt, pages),
                     dict(EXTMEM_DET, device="cpu"), 5, "p21d-cpu",
                     device="cpu")
    one = xtt.train(EXTMEM_DET, _p21_config(xtt, pages), 5,
                    verbose_eval=False)
    if not (card[0]["json"] == card[1]["json"] == cpu[0]["json"]
            == cpu[1]["json"] == _model_bytes(one)):
        raise AssertionError("phase 21d: the card's two-rank model JSON is "
                             "not the CPU's, or not one rank's")
    t0 = time.perf_counter()
    out = xtt.train_distributed(
        EXTMEM_DET, [functools.partial(module._p21_part, r,
                                       EXTMEM_DET.get("device"))
                     for r in range(2)], num_boost_round=5, timeout=300)
    job_s = time.perf_counter() - t0
    if _model_bytes(out["booster"]) != card[0]["json"]:
        raise AssertionError("phase 21d: the workers' out-of-core model is "
                             "not the in-memory ranks'")
    log(f"phase 21d parity ({smi}): {P21_CPU_CUT[-1]} rows in 4 pages, "
        "depth 8, 5 rounds, deterministic: two ranks' model JSON on the "
        "card byte-identical to the CPU's, to one rank's on the card, and "
        f"to train_distributed's two tracker-ranked worker processes "
        f"building their pages in a callable part ({job_s:.3f} s for the "
        f"job)")


def phase_21(xtt, hist_cuda, smi, ref):
    """Phases 21a-21d: out of core, exact and process_type="update" across
    ranks on one card; ``ref`` phase 19's results."""
    timed("21a", phase_extmem_ranks, xtt, hist_cuda, smi, ref)
    timed("21b", phase_extmem_ranks_det, xtt, hist_cuda, smi, ref)
    timed("21c", phase_exact_update_ranks, xtt, hist_cuda, smi)
    timed("21d", phase_extmem_ranks_cpu, xtt, hist_cuda, smi)


# ----------------------------------------------------------------- phase 22
P22_FANOUT_S = 60  # 22b: the failed job's seconds at most


def _p22_train(rank, world, out_dir):
    """A run_distributed worker of 22a: trains 20c's shard of its rank on
    the card, deterministic, and writes its model JSON, its own launches,
    its rounds' seconds and the collective's route to
    ``out_dir/rank<rank>.json``."""
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch import collective
    from xgboost_tpu_torch.ops import hist_cuda

    X, y = _p20c_shards()[rank]
    marks = []

    class Clock(xtt.TrainingCallback):
        def before_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return False

        def after_iteration(self, model, epoch, evals_log):
            torch.cuda.synchronize()
            marks[-1] = time.perf_counter() - marks[-1]
            return False

    d = xtt.DMatrix(X, label=y)
    hist_cuda.reset_launches()  # this worker's main path: counts from 0
    bst = xtt.train(P20_DET, d, P20_PROC_ROUNDS, verbose_eval=False,
                    callbacks=[Clock()])
    torch.cuda.synchronize()
    out = dict(world=world, json=_model_bytes(bst), rounds=marks,
               launches=dict(hist_cuda.launches),
               relay=bool(collective._backend()._relay_mode))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def _p22_fail(rank, world):
    """A run_distributed worker of 22b: both ranks touch the card; rank 1
    then raises, while rank 0 waits for it in a collective."""
    from xgboost_tpu_torch import collective

    torch.zeros(1, device="cuda")
    if rank == 1:
        raise RuntimeError("phase 22b: rank 1 fails after the rendezvous")
    collective.allreduce(np.ones(4))
    time.sleep(600)  # only the tracker's abort ends this worker


def _p22_job(hist_cuda, mem_json, coll, tmp):
    """22a's job over ``coll``: "relay" or "gloo" under the tracker (which
    XGBOOST_TPU_COLL must name), or "direct", run_distributed's default
    on the card (gloo, worker i rank i).  Its seconds and its workers'
    reports, checked against 20c's in-memory ranks."""
    import functools

    import chip_smoke as module  # the workers unpickle by this path
    from xgboost_tpu_torch.launcher import run_distributed

    out_dir = os.path.join(tmp, coll)
    os.makedirs(out_dir)
    fn = functools.partial(module._p22_train, out_dir=out_dir)
    t0 = time.perf_counter()
    if coll == "direct":
        run_distributed(fn, 2, timeout=300)
    else:
        run_distributed(fn, 2, rendezvous="tracker", timeout=300)
    job_s = time.perf_counter() - t0
    reports = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            reports.append(json.load(fh))
    want = _sigmoid_launches(hist_cuda, P20_PROC_ROUNDS, evals=0)
    want["hist_q"] = want["split_scan"] = \
        P20_DET["max_depth"] * P20_PROC_ROUNDS
    for r, rep in enumerate(reports):
        if rep["json"] != mem_json:
            raise AssertionError(f"phase 22a {coll}: rank {r}'s model is not "
                                 "20c's in-memory ranks'")
        if rep["relay"] != (coll == "relay") or rep["world"] != 2:
            raise AssertionError(f"phase 22a {coll}: rank {r} took the relay "
                                 f"{rep['relay']}, world {rep['world']}")
        if rep["launches"] != want:
            raise AssertionError(f"phase 22a {coll}: rank {r} launched "
                                 f"{rep['launches']}, want {want}")
    return job_s, reports


def phase_tracker_fanout():
    """22b: one worker raises after the rendezvous; the tracker aborts its
    peer, which waits in a collective.  The job's seconds, the exit codes
    and the error's message."""
    import chip_smoke as module
    from xgboost_tpu_torch.launcher import WorkerFailedError, run_distributed

    t0 = time.perf_counter()
    try:
        run_distributed(module._p22_fail, 2, rendezvous="tracker",
                        timeout=P22_FANOUT_S)
    except WorkerFailedError as e:
        err = e
    else:
        raise AssertionError("phase 22b: the failing job did not raise")
    return (time.perf_counter() - t0,
            sorted(rc for _label, rc, _tail in err.failures), str(err))


def phase_22(xtt, hist_cuda, smi, mem_json=None):
    """Phases 22a-22b: the tracker and the launcher on one card;
    ``mem_json`` 20c's in-memory ranks' model (trained here if None).
    22a's relay job and its gloo job (at the tracker's coordinator) each
    run alone, so their rounds compare; its direct job (run_distributed's
    default on the card) runs beside 22b's failing job, which gathers
    through gloo at its tracker's coordinator."""
    import shutil

    if mem_json is None:
        mem = _rank_train(xtt, hist_cuda, _p20c_shards(), P20_DET,
                          P20_PROC_ROUNDS, "p22-memory", timed_repeat=False)
        mem_json = mem[0]["json"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p22_")
    old = os.environ.get("XGBOOST_TPU_COLL")
    try:
        os.environ["XGBOOST_TPU_COLL"] = "relay"
        relay = timed("22a relay", _p22_job, hist_cuda, mem_json, "relay",
                      tmp)
        os.environ["XGBOOST_TPU_COLL"] = "gloo"
        gloo = timed("22a gloo", _p22_job, hist_cuda, mem_json, "gloo", tmp)
        t0 = time.perf_counter()
        fanout = _in_thread(phase_tracker_fanout)
        direct = _p22_job(hist_cuda, mem_json, "direct", tmp)
        fan_s, codes, msg = fanout()
        log(f"phase 22a direct and 22b took "
            f"{time.perf_counter() - t0:.3f} s")
    finally:
        if old is None:
            os.environ.pop("XGBOOST_TPU_COLL", None)
        else:
            os.environ["XGBOOST_TPU_COLL"] = old
        shutil.rmtree(tmp, ignore_errors=True)

    def rounds(reports):
        return " / ".join(" ".join(f"{t * 1e3:.3f}" for t in rep["rounds"])
                          for rep in reports)

    k2 = [rep["launches"]["hist_q"] // P20_PROC_ROUNDS
          for rep in relay[1] + gloo[1] + direct[1]]
    log(f"phase 22a ({smi}): run_distributed, 2 workers on one card x "
        f"{P20_PROC_ROWS} rows, {P20_PROC_ROUNDS} rounds, deterministic: "
        f"tracker-ranked over the relay {relay[0]:.3f} s and over gloo at "
        f"its coordinator {gloo[0]:.3f} s, each alone; direct gloo (the "
        f"default rendezvous) {direct[0]:.3f} s beside 22b's job (the "
        f"workers' start, rendezvous, sketch and training); round ms by "
        f"rank, relay {rounds(relay[1])}, gloo {rounds(gloo[1])}, direct "
        f"{rounds(direct[1])}; K2 a round by worker (relay, gloo, direct) "
        f"{k2}, K3 {P20_DET['max_depth']} a round, K4 "
        f"{P20_PROC_ROUNDS + 1} a worker; the three jobs' model bytes "
        "equal to 20c's 2 in-memory ranks'")
    if fan_s > P22_FANOUT_S or codes != [1, 255]:
        raise AssertionError(f"phase 22b: {fan_s:.3f} s, exit codes {codes}")
    if "Traceback" not in msg or "rank 1 fails after the rendezvous" \
            not in msg or "aborted by tracker fan-out" not in msg:
        raise AssertionError(f"phase 22b: the error lacks the traceback or "
                             f"the abort: {msg[-1500:]}")
    log(f"phase 22b ({smi}): a worker raised after the rendezvous; its peer, "
        f"waiting in a gloo collective, was aborted by the tracker (exit "
        f"codes {codes}); WorkerFailedError after {fan_s:.3f} s (gate "
        f"{P22_FANOUT_S}) with the failing worker's traceback")


def _shap_entry(name, r):
    """K6's line: its main path's call (or the first rows of it, where the
    plain version ran on those only), with the launches of the call."""
    return {"name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/treeshap.cu",
            "replaces": REPLACES[name], "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["small_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["small_bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None}


def _kernel_entry(name, source, cases, launches):
    # K1 and K2: the line sums the three int16 shapes it has summed since
    # the first slice, (0, 1, 1), (15, 16, 2) and (31, 16, 2), the six
    # levels' sum is phase 2's line; K3: the six depth-6 levels,
    # unconstrained (the main path's scan)
    if name == "sigmoid":
        c = cases[0]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        }
    if name == "lambdarank":
        # the MSLR-shaped main path's launch
        c = [c for c in cases if c["case"] == "mslr"][0]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None,
        }
    if name == "hist_f32_multi":
        # the lockstep layout at Covertype's shapes, its three levels
        main = [c for c in cases
                if c["layout"] == "pos per class" and c["rows"] == "spread"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["kernel_ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": sum(c["bound_ms"] for c in main),
            "bound_by": main[0]["bound_by"],
            "library_ms": sum(c["library_ms"] for c in main),
        }
    if name == "split_scan_categorical":
        # the seven levels of a depth-8 round, partition (max_cat_to_onehot
        # 4, the main path's), from the f32 histogram
        main = [c for c in cases if c["max_cat_to_onehot"] == 4]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["kernel_ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": sum(c["bound_ms"] for c in main),
            "bound_by": main[0]["bound_by"], "library_ms": None,
        }
    if name == "split_scan":
        main = [c for c in cases if c["mode"] == "native"
                and c["n_nodes"] in SCAN_LEVELS]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["kernel_ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": sum(c["bound_ms"] for c in main),
            "bound_by": main[0]["bound_by"], "library_ms": None,
        }
    main = [c for c in cases if c["dtype"] == "int16"
            and _shape(c) in LINE_SHAPES]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["kernel_ms"] for c in main),
        "plain_ms": sum(c["plain_ms"] for c in main),
        "bound_ms": sum(c["bound_ms"] for c in main),
        "bound_by": main[0]["bound_by"],
        "library_ms": sum(c["library_ms"] for c in main),
    }


REPLACES = {"hist_f32": "xgboost_tpu/ops/hist_pallas.py:77",
            # K1's class axis: the same Pallas kernel, K histograms a launch
            "hist_f32_multi": "xgboost_tpu/ops/hist_pallas.py:77",
            "hist_q": "xgboost_tpu/ops/hist_pallas.py:173",
            # no Pallas kernel: the reference's native CPU scan (and its
            # XLA formulation, xgboost_tpu/ops/split.py:253, when monotone)
            "split_scan": "native/xtb_kernels.h:647",
            # no Pallas kernel: XLA's jax.nn.sigmoid in the objective
            "sigmoid": "xgboost_tpu/objective/regression.py:113",
            # K3's categorical mode: no Pallas kernel, the reference's XLA
            # formulation with a cat_mask
            "split_scan_categorical": "xgboost_tpu/ops/split.py:269",
            # no Pallas kernel: the reference's native top-k LambdaMART
            # gradients
            "lambdarank": "native/xtb_kernels.h:997",
            # no Pallas kernel: the reference's XLA TreeSHAP programs
            "treeshap": "xgboost_tpu/interpret/device.py:114",
            "treeshap_interactions": "xgboost_tpu/interpret/device.py:210"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    t_start = time.perf_counter()
    late_build = start_build(hist_cuda, LATE_BUILD)
    smi = timed("1", phase_device, hist_cuda, LATE_BUILD)
    f32_cases = timed("2", phase_kernels, hist_cuda, "hist_f32", "2")
    q_cases = timed("2b", phase_kernels, hist_cuda, "hist_q", "2b")
    scan_cases = timed("2c", phase_split_scan, hist_cuda)
    cat_cases = timed("2e", phase_split_scan_cat)
    sig_cases = timed("2d", phase_sigmoid, hist_cuda)
    class_cases = timed("2f", phase_class_axis, hist_cuda)
    rank_cases = timed("2g", phase_lambdarank, hist_cuda)
    X, y = make_data(1_000_000, 28)
    f32, dtrain = timed("3", phase_train, xtt, hist_cuda, X, y, 10)
    timed("3b", phase_profile, xtt, dtrain, BASE, "3b")
    timed("3b gradient", phase_gradient_profile, xtt, hist_cuda)
    det = timed("3c", phase_train_det, xtt, hist_cuda, dtrain, X.shape[0],
                10, f32)
    timed("3d", phase_profile, xtt, dtrain, DET, "3d (deterministic)")
    timed("4", phase_predict, xtt, f32["bst"], X)
    timed("5", phase_parity, xtt)
    timed("5b", phase_parity_det, xtt, dtrain, X)
    lossguide = timed("6", phase_lossguide, xtt, hist_cuda, dtrain,
                      X.shape[0])
    timed("6b", phase_lossguide_parity, xtt)
    cat = timed("7", phase_categorical, xtt, hist_cuda)
    timed("7b", phase_categorical_parity, xtt)
    cover, Xc, yc, dcover = timed("8", phase_multiclass, xtt, hist_cuda)
    timed("8b", phase_multiclass_parity, xtt, Xc, yc)
    lockstep = timed("12", phase_lockstep, xtt, hist_cuda, dcover,
                     cover["hist_f32"], Xc)
    timed("12b", phase_lockstep_parity, xtt, hist_cuda)
    timed("13", phase_vector_leaf, xtt, hist_cuda, dcover,
          cover["hist_f32"], Xc)
    del yc, dcover
    timed("9", phase_forest, xtt, hist_cuda, dtrain, y)
    timed("10", phase_api, xtt, dtrain, X, y)
    timed("11", phase_csr, xtt, hist_cuda, X, y)
    timed("13 multi-target", phase_multi_target, xtt, hist_cuda, X)
    timed("13b", phase_vector_parity, xtt)
    del X, y, dtrain
    timed("14", phase_pointwise, xtt, hist_cuda)
    timed("14b", phase_pointwise_parity, xtt)
    rank = timed("15", phase_ranking, xtt, hist_cuda)
    timed("15b", phase_ranking_parity, xtt)
    timed("16", phase_api_surface, xtt, hist_cuda, f32)
    X, y = make_data(1_000_000, 28)
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)
    dart = timed("17a", phase_dart, xtt, hist_cuda, dtrain, X, f32, det)
    timed("17b", phase_approx, xtt, hist_cuda, dtrain, X, f32, det)
    gbl = timed("17c", phase_gblinear, xtt, hist_cuda, X, y)
    timed("17d", phase_update, xtt, hist_cuda, dtrain, X)
    del dtrain
    timed("17e", phase_exact, xtt, hist_cuda, X, y)
    late_build()
    shap = timed("18", phase_shap, xtt, hist_cuda, f32, X, cover, Xc,
                 lossguide, dart, gbl, cat)
    del X, y, Xc
    timed("17f", phase_boosters_parity, xtt)
    ext = phase_19(xtt, hist_cuda)
    mem_json = phase_20(xtt, hist_cuda, smi)
    phase_21(xtt, hist_cuda, smi, ext)
    del ext
    t22 = time.perf_counter()
    phase_22(xtt, hist_cuda, smi, mem_json)
    log(f"phase 22 took {time.perf_counter() - t22:.3f} s")

    kernels = [_kernel_entry(name, hist_cuda.SOURCES[name], cases, n)
               for name, cases, n in (("hist_f32", f32_cases, f32["launches"]),
                                      ("hist_q", q_cases, det["launches"]),
                                      ("split_scan", scan_cases,
                                       f32["scan_launches"]),
                                      ("sigmoid", sig_cases,
                                       f32["sigmoid_launches"]))]
    kernels.append(_kernel_entry(
        "split_scan_categorical", hist_cuda.SOURCES["split_scan"], cat_cases,
        cat["hist_f32"]["scan_launches"]))
    kernels.append(_kernel_entry(
        "hist_f32_multi", hist_cuda.SOURCES["hist_f32_multi"], class_cases,
        lockstep["launches"]))
    kernels.append(_kernel_entry(
        "lambdarank", hist_cuda.SOURCES["lambdarank"], rank_cases,
        rank[("rank:ndcg", "topk")]["lambdarank_launches"]))
    kernels.append(_shap_entry("treeshap", shap["18a HIGGS"]))
    kernels.append(_shap_entry("treeshap_interactions",
                               shap["18b HIGGS interactions"]))
    log(f"chip_smoke total {time.perf_counter() - t_start:.3f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
