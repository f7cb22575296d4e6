"""Out-of-core data for the port's multi-rank tests, importable by
``train_distributed``'s worker processes: numpy and xgboost_tpu_torch
only (a worker unpickles a part by this module's import path).

``pages(mod, X, y, idx, page_rows)`` is a DataIter of ``mod`` (either
package) yielding the pages ``idx`` of (X, y); ``extmem_part(rank)`` is
one worker's ExtMemQuantileDMatrix on the CPU over the pages
``ShardMap.create(PARTS_PAGES, 2)`` gives that rank."""
import numpy as np

PARTS_PAGES = 4
PARTS_PAGE_ROWS = 1024
PARTS_FEATURES = 5
PARTS_MAX_BIN = 16


def pages(mod, X, y, idx, page_rows, weight=None):
    """A ``mod.DataIter`` over the pages ``idx`` (page i: rows
    i * page_rows onwards) of X, y and the optional weights."""

    class Pages(mod.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= len(idx):
                return 0
            sl = slice(idx[self.i] * page_rows, (idx[self.i] + 1) * page_rows)
            input_data(data=X[sl], label=y[sl],
                       weight=None if weight is None else weight[sl])
            self.i += 1
            return 1

    return Pages()


def parts_data(seed: int = 43):
    """The pages' rows: (X, y), NaN-sprinkled, from ``seed``."""
    rng = np.random.default_rng(seed)
    R = PARTS_PAGES * PARTS_PAGE_ROWS
    X = rng.normal(size=(R, PARTS_FEATURES)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.4 * np.nan_to_num(X[:, 2])
         > 0).astype(np.float32)
    return X, y


def extmem_part(rank: int):
    """Rank ``rank``'s pages of ``parts_data`` as an uncompressed
    ExtMemQuantileDMatrix on the CPU, its cuts merged over the ranks."""
    import xgboost_tpu_torch as xtt

    X, y = parts_data()
    idx = xtt.ShardMap.create(PARTS_PAGES, 2).shards_of(rank)
    return xtt.ExtMemQuantileDMatrix(
        pages(xtt, X, y, list(idx), PARTS_PAGE_ROWS),
        max_bin=PARTS_MAX_BIN, device="cpu", compress=False)
