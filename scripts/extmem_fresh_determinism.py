"""Deterministic out-of-core training on a freshly made page ring, after
other work has churned the card's memory: chip_smoke.py's 19b pages (24
deterministic Criteo-shaped pages) trained 4 times, then phase 23
(serving: graphs captured and freed), then 4 more times on the same matrix
and 4 times on a matrix ingested afresh.  Prints each model's digest;
every one must be the same.  Run on one GPU:

    python3 scripts/extmem_fresh_determinism.py
"""
import hashlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_phase23  # noqa: E402
import chip_smoke as cs  # noqa: E402


def _digest(bst) -> str:
    return hashlib.sha256(cs._model_bytes(bst).encode()).hexdigest()[:12]


def main() -> int:
    if not torch.cuda.is_available():
        print("extmem_fresh_determinism: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    smi = cs.phase_device(hist_cuda, cs.LATE_BUILD)
    pages = cs.make_extmem_pages(cs.EXTMEM_DET_PAGES)

    def runs(d):
        return [_digest(xtt.train(cs.EXTMEM_DET, d, cs.EXTMEM_DET_ROUNDS,
                                  verbose_eval=False)) for _ in range(4)]

    d, _ = cs._extmem_ingest(xtt, pages, "fresh 1")
    seen = {"before phase 23": runs(d)}
    cs.phase_23(xtt, hist_cuda, smi, chip_phase23._models(xtt))
    seen["after phase 23"] = runs(d)
    d.release_device()
    d, _ = cs._extmem_ingest(xtt, pages, "fresh 2")
    seen["a fresh matrix after phase 23"] = runs(d)
    for what, digests in seen.items():
        cs.log(f"{what}: {digests}")
    if len({x for v in seen.values() for x in v}) != 1:
        cs.log("extmem_fresh_determinism: the models differ")
        return 1
    cs.log("extmem_fresh_determinism: every model the same bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
