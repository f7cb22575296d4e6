"""chip_smoke.py's serving phase alone, on one GPU: phase 1 (the card's
name and power limit; every kernel built but K6's, which serving does not
run), the three models 23b serves trained as chip_smoke's phases 7, 8 and
17a train them (Criteo-shaped categorical f32, Covertype f32, DART
uniform/tree f32 on the HIGGS rows), then chip_smoke's phase_23 (23a the
reference's serving configuration, 23b those models, a hot swap, a pin and
an LRU eviction under load, 23c card against CPU).  A quicker rehearsal of
phase 23 than the whole script.

    python3 scripts/chip_phase23.py
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _models(xtt):
    """23b's models and rows, trained as the phases of chip_smoke.py that
    make them train them (their f32 paths)."""
    Xc, yc = cs.make_covertype()
    cover = xtt.train(cs.COVER, xtt.DMatrix(Xc, label=yc), 5,
                      verbose_eval=False)
    Xk, yk = cs.make_criteo(1 << 20)
    cat = xtt.train(cs.CRITEO, xtt.DMatrix(Xk, label=yk,
                                           feature_types=cs.CRITEO_TYPES,
                                           enable_categorical=True),
                    10, verbose_eval=False)
    X, y = cs.make_data(1_000_000, 28)
    dart = xtt.train(cs.P17_DART["uniform/tree"], xtt.DMatrix(X, label=y),
                     cs.P17_ROUNDS, verbose_eval=False)
    return cs.p23_models(xtt, cover, Xc, cat, dart, X)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase23: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    t_start = time.perf_counter()
    smi = cs.timed("1", cs.phase_device, hist_cuda, cs.LATE_BUILD)
    cs.log(smi)
    models = cs.timed("23 models", _models, xtt)
    serving = cs.phase_23(xtt, hist_cuda, smi, models)
    cs.log(f"chip_phase23: K4 launched {serving['k4']} times in 23a's "
           f"{serving['replays']} replays")
    cs.log(f"chip_phase23 total {time.perf_counter() - t_start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
