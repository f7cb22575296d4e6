"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and without a CUDA device that is an error, never a quiet
fallback to the CPU.  A string takes the reference's grammar
(``context.DeviceOrd.parse``): ``tpu``, ``gpu`` and ``cuda`` name the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..context import DeviceOrd


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if isinstance(device, torch.device):
        dev = device
    else:
        dev = DeviceOrd.parse("cuda" if device is None else device
                              ).torch_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xgboost_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise ValueError(f"device {dev} does not exist: "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return dev
