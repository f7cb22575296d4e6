"""Compare utils/libm.py's expf, exp2f and log2f with the C library's over
every f32 input (or a range of bit patterns), bit for bit.

The C library's values come from a small helper compiled with the
system's C compiler into a temporary directory (a loop calling the
function, so that the values are the ones the dynamic linker's choice of
variant gives on this CPU); the port's come from PyTorch on the CPU, in
chunks of 2^22 inputs.  Prints each mismatch (at most three a chunk) and
a summary line a function.  Takes about half an hour a function on two
threads.

    python scripts/libm_exhaustive.py                 # all three, all 2^32
    python scripts/libm_exhaustive.py exp2f 0x3f000000 0x3f800000
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from xgboost_tpu_torch.utils import libm  # noqa: E402

HELPER = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
void run(int which, uint32_t lo, uint32_t n, uint32_t* out) {
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t b = lo + i; float x; memcpy(&x, &b, 4);
    float y = which == 0 ? expf(x) : which == 1 ? exp2f(x) : log2f(x);
    memcpy(&out[i], &y, 4);
  }
}
"""
NAMES = ("expf", "exp2f", "log2f")
CHUNK = 1 << 22


def _helper(tmp: str):
    src = os.path.join(tmp, "libm_values.c")
    lib = os.path.join(tmp, "libm_values.so")
    with open(src, "w") as fh:
        fh.write(HELPER)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", lib, src, "-lm"],
                   check=True)
    h = ctypes.CDLL(lib)
    h.run.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                      ctypes.c_void_p]
    return h


def check(helper, name: str, start: int, end: int) -> int:
    which = NAMES.index(name)
    fn = getattr(libm, name)
    bad_total, t0 = 0, time.time()
    for lo in range(start, end, CHUNK):
        n = min(CHUNK, end - lo)
        want = np.empty(n, np.uint32)
        helper.run(which, lo, n, want.ctypes.data)
        x = (np.arange(n, dtype=np.uint64) + lo).astype(np.uint32)
        got = fn(torch.from_numpy(x.view(np.float32))).numpy().view(np.uint32)
        bad = np.nonzero(got != want)[0]
        bad_total += len(bad)
        for b in bad[:3]:
            print(f"MISMATCH {name} x=0x{int(x[b]):08x} got "
                  f"0x{int(got[b]):08x} want 0x{int(want[b]):08x}",
                  flush=True)
    print(f"{name} [{start:#x}, {end:#x}): {bad_total} mismatches in "
          f"{time.time() - t0:.0f} s", flush=True)
    return bad_total


def main() -> int:
    names = [sys.argv[1]] if len(sys.argv) > 1 else list(NAMES)
    start = int(sys.argv[2], 0) if len(sys.argv) > 2 else 0
    end = int(sys.argv[3], 0) if len(sys.argv) > 3 else 1 << 32
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        helper = _helper(tmp)
        bad = sum(check(helper, name, start, end) for name in names)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
