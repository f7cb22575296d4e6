"""Execution context: device parsing (port of xgboost_tpu/context.py;
reference include/xgboost/context.h:40, src/context.cc:105-155).

The grammar is the reference's: ``cpu``, ``tpu``, ``gpu`` or ``cuda``, each
with an optional ``:N`` ordinal.  The port runs on a CUDA card, so the
three accelerator spellings all name ``cuda[:N]``: a config saved by the
JAX package (``"device": "tpu"``) loads onto the card.

The reference's ``Context`` also sizes its native thread pool from
``nthread``.  The port has no such pool and keeps no ``Context``: ``nthread``
is a parameter, saved with the configuration as the reference saves it,
and the port does not call ``torch.set_num_threads`` behind the caller's
back.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

_DEVICE_RE = re.compile(r"^(cpu|tpu|gpu|cuda)(:(\d+))?$")


@dataclasses.dataclass(frozen=True)
class DeviceOrd:
    """A parsed device: ``type`` is ``'cpu'`` or ``'cuda'``; ``ordinal`` is
    the card's index, None where the spec named none (the current card)."""

    type: str = "cpu"
    ordinal: Optional[int] = None

    @staticmethod
    def parse(spec: str) -> "DeviceOrd":
        text = str(spec).strip().lower()
        m = _DEVICE_RE.match(text)
        if m is None:
            raise ValueError(
                f"Invalid device spec: {spec!r}. Expected 'cpu', 'cuda', "
                "'cuda:<ordinal>' (or the reference's 'gpu' and 'tpu').")
        kind = "cpu" if m.group(1) == "cpu" else "cuda"
        ordinal = None if m.group(3) is None else int(m.group(3))
        return DeviceOrd(kind, ordinal)

    def torch_device(self) -> torch.device:
        if self.type == "cpu" or self.ordinal is None:
            return torch.device(self.type)
        return torch.device(self.type, self.ordinal)
