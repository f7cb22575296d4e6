"""chip_smoke.py's phase 21 alone, on one GPU: phase 1 (the card's name
and power limit, every kernel built), one rank's models of phase 19a and
19b on the same pages (the references phase 21 holds its ranks against:
19a's matrix, AUC and round, 19b's model JSON, without 19's other
measurements), then chip_smoke's phase_21 (21a-21d: out of core at two
in-memory ranks on both histogram paths, exact and process_type="update"
at two ranks, card against CPU and two gloo worker processes).  A quicker
rehearsal of phase 21 than the whole script.

    python3 scripts/chip_phase21.py [PAGES]

PAGES (default 64, chip_smoke's) cuts 21a's pages; 21b takes the first
min(PAGES, 24).
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def one_rank(xtt, pages):
    """Phase 19a's and 19b's one-rank training on ``pages``: what phase 21
    needs of phase 19."""
    from xgboost_tpu_torch.metric import auc

    d, _ = cs._extmem_ingest(xtt, pages, "21 one rank")
    t0 = time.perf_counter()
    bst = xtt.train(cs.EXTMEM, d, cs.EXTMEM_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / cs.EXTMEM_ROUNDS
    pred = bst.predict(d)
    got = auc(pred[::8], d.label[::8].astype(np.float64))
    d.release_device()
    d24, _ = cs._extmem_ingest(xtt, pages[:cs.EXTMEM_DET_PAGES],
                               "21 one rank deterministic")
    det = xtt.train(cs.EXTMEM_DET, d24, cs.EXTMEM_DET_ROUNDS,
                    verbose_eval=False)
    d24.release_device()
    cs.log(f"phase 21 one rank: {len(pages)} pages, a round "
           f"{round_s * 1e3:.3f} ms (the first round included), "
           f"AUC@stride8 {got:.6f}")
    return dict(pages=pages, dmat=d, auc=got, round_s=round_s,
                det_json=cs._model_bytes(det))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase21: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    n_pages = int(sys.argv[1]) if len(sys.argv) > 1 else cs.EXTMEM_PAGES
    t_start = time.perf_counter()
    smi = cs.timed("1", cs.phase_device, hist_cuda)
    cs.log(smi)
    pages = cs.make_extmem_pages(n_pages)
    ref = cs.timed("21 one rank", one_rank, xtt, pages)
    cs.phase_21(xtt, hist_cuda, smi, ref)
    cs.log(f"chip_phase21 total {time.perf_counter() - t_start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
