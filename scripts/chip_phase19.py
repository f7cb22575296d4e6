"""chip_smoke.py's out-of-core phase alone, on one GPU: phase 1 (the
card's name and power limit, every kernel built), then chip_smoke's
phase_19 (19a-19d) at PAGES pages of the ladder's criteo_extmem_40m
configuration (default 64, as chip_smoke.py; 19b takes at most 24 of
them).  A quicker rehearsal of phase 19 than the whole script.

    python3 scripts/chip_phase19.py [PAGES]
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
        print("chip_phase19: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    n = int(sys.argv[1]) if len(sys.argv) > 1 else cs.EXTMEM_PAGES
    t_start = time.perf_counter()
    cs.log(cs.timed("1", cs.phase_device, hist_cuda))
    cs.phase_19(xtt, hist_cuda, n)
    cs.log(f"chip_phase19 total {time.perf_counter() - t_start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
