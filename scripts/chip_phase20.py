"""chip_smoke.py's data-parallel phase alone, on one GPU: phase 1 (the
card's name and power limit, every kernel built), then chip_smoke's
phase_20 (20a-20c: two in-memory ranks on the card on both histogram
paths, card against CPU, two gloo worker processes).  A quicker
rehearsal of phase 20 than the whole script.

    python3 scripts/chip_phase20.py
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
        print("chip_phase20: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    t_start = time.perf_counter()
    smi = cs.timed("1", cs.phase_device, hist_cuda)
    cs.log(smi)
    cs.phase_20(xtt, hist_cuda, smi)
    cs.log(f"chip_phase20 total {time.perf_counter() - t_start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
