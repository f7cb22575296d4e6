"""UBJSON reader/writer (reference: include/xgboost/json_io.h:188 UBJReader,
:230 UBJWriter — used for ``.ubj`` binary model files).  A copy of
xgboost_tpu/utils/ubjson.py, so the port reads and writes the same bytes.

Implements the UBJSON draft-12 subset the reference emits: objects, arrays
(including optimized strongly-typed arrays with ``$`` type and ``#`` count),
strings, int8/16/32/64, float32/64, bools, null.  Python ints/floats map to the
smallest lossless tag, matching the reference writer's behavior.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np


def _write_int(fh: BinaryIO, v: int) -> None:
    if -128 <= v <= 127:
        fh.write(b"i" + struct.pack(">b", v))
    elif 0 <= v <= 255:
        fh.write(b"U" + struct.pack(">B", v))
    elif -(2**15) <= v < 2**15:
        fh.write(b"I" + struct.pack(">h", v))
    elif -(2**31) <= v < 2**31:
        fh.write(b"l" + struct.pack(">i", v))
    else:
        fh.write(b"L" + struct.pack(">q", v))


def _write_str_payload(fh: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    _write_int(fh, len(b))
    fh.write(b)


def dump_ubjson(obj: Any, fh: BinaryIO) -> None:
    if obj is None:
        fh.write(b"Z")
    elif obj is True:
        fh.write(b"T")
    elif obj is False:
        fh.write(b"F")
    elif isinstance(obj, (int, np.integer)):
        _write_int(fh, int(obj))
    elif isinstance(obj, (float, np.floating)):
        fh.write(b"D" + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        fh.write(b"S")
        _write_str_payload(fh, obj)
    elif isinstance(obj, np.ndarray) and obj.dtype == np.float32:
        fh.write(b"[$d#")
        _write_int(fh, obj.size)
        fh.write(obj.astype(">f4").tobytes())
    elif isinstance(obj, np.ndarray) and obj.dtype in (np.int32, np.dtype(">i4")):
        fh.write(b"[$l#")
        _write_int(fh, obj.size)
        fh.write(obj.astype(">i4").tobytes())
    elif isinstance(obj, (list, tuple, np.ndarray)):
        fh.write(b"[")
        for it in obj:
            dump_ubjson(it, fh)
        fh.write(b"]")
    elif isinstance(obj, dict):
        fh.write(b"{")
        for k, v in obj.items():
            _write_str_payload(fh, str(k))
            dump_ubjson(v, fh)
        fh.write(b"}")
    else:
        raise TypeError(f"UBJSON: unsupported type {type(obj)}")


_INT_FMT = {b"i": ">b", b"U": ">B", b"I": ">h", b"l": ">i", b"L": ">q"}
_FLOAT_FMT = {b"d": ">f", b"D": ">d"}


class _Reader:
    def __init__(self, fh: BinaryIO):
        self.fh = fh

    def _read_exact(self, n: int) -> bytes:
        """Short reads become EOFError, not struct.error — truncated or
        corrupt model buffers must fail with a clean python-level error
        (tests/test_model_io_fuzz.py)."""
        if n < 0:
            raise ValueError("UBJSON: negative length")
        b = self.fh.read(n)
        if len(b) != n:
            raise EOFError("unexpected end of UBJSON stream")
        return b

    def tag(self) -> bytes:
        return self._read_exact(1)

    def read_int(self, t: bytes) -> int:
        fmt = _INT_FMT[t]
        return struct.unpack(fmt, self._read_exact(struct.calcsize(fmt)))[0]

    def read_len(self) -> int:
        n = self.read_int(self.tag())
        if n < 0:
            raise ValueError("UBJSON: negative length")
        return n

    def read_str(self) -> str:
        n = self.read_len()
        return self._read_exact(n).decode("utf-8")

    def value(self, t: bytes) -> Any:
        if t in _INT_FMT:
            return self.read_int(t)
        if t in _FLOAT_FMT:
            fmt = _FLOAT_FMT[t]
            return struct.unpack(fmt, self._read_exact(struct.calcsize(fmt)))[0]
        if t == b"S":
            return self.read_str()
        if t == b"T":
            return True
        if t == b"F":
            return False
        if t == b"Z":
            return None
        if t == b"[":
            return self.array()
        if t == b"{":
            return self.obj()
        raise ValueError(f"UBJSON: bad tag {t!r}")

    def array(self) -> Any:
        t = self.tag()
        typ = None
        count = None
        if t == b"$":
            typ = self.tag()
            t = self.tag()
        if t == b"#":
            count = self.read_len()
        if typ is not None:
            assert count is not None
            if typ in _FLOAT_FMT:
                fmt = _FLOAT_FMT[typ]
                sz = struct.calcsize(fmt)
                arr = np.frombuffer(self._read_exact(sz * count), dtype=fmt).astype(
                    np.float32 if typ == b"d" else np.float64
                )
                return arr.tolist()
            if typ in _INT_FMT:
                fmt = _INT_FMT[typ]
                sz = struct.calcsize(fmt)
                return np.frombuffer(self._read_exact(sz * count), dtype=fmt).tolist()
            raise ValueError(f"UBJSON: bad array type {typ!r}")
        out = []
        if count is not None:
            for _ in range(count):
                out.append(self.value(self.tag()))
            return out
        while t != b"]":
            out.append(self.value(t))
            t = self.tag()
        return out

    def obj(self) -> dict:
        out = {}
        while True:
            t = self.tag()
            if t == b"}":
                return out
            # key: length tag already read
            n = self.read_int(t)
            key = self._read_exact(n).decode("utf-8")
            out[key] = self.value(self.tag())


def load_ubjson(fh: BinaryIO) -> Any:
    r = _Reader(fh)
    return r.value(r.tag())
