"""chip_smoke.py's tracker and launcher phase alone, on one GPU: phase 1
(the card's name and power limit, every kernel built), phase 20c
(train_distributed's tracker-ranked workers against two in-memory ranks,
whose model 22a is held against), then chip_smoke's phase_22 (22a:
run_distributed over the tracker's relay, over gloo at its
coordinator and over gloo directly; 22b: the abort fan-out of a failing
worker).  A quicker
rehearsal of phase 22 than the whole script.

    python3 scripts/chip_phase22.py
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase22: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    t_start = time.perf_counter()
    smi = cs.timed("1", cs.phase_device, hist_cuda)
    cs.log(smi)
    mem_json = cs.timed("20c", cs.phase_distributed_procs, xtt, hist_cuda,
                        smi)
    t22 = time.perf_counter()
    cs.phase_22(xtt, hist_cuda, smi, mem_json)
    cs.log(f"phase 22 took {time.perf_counter() - t22:.3f} s")
    cs.log(f"chip_phase22 total {time.perf_counter() - t_start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
