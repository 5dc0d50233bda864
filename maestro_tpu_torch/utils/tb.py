"""Minimal TensorBoard event-file writer (pure Python, no torch/TF deps).

tensorboardX is not a dependency of the port (and may be absent where it
runs).  TensorBoard's on-disk format is just TFRecord-framed Event
protobufs with a handful of fields, so this module hand-encodes them:

  Event    { double wall_time = 1; int64 step = 2; string file_version = 3;
             Summary summary = 5; }
  Summary  { repeated Value value = 1; }
  Value    { string tag = 1; float simple_value = 2; Image image = 4; }
  Image    { int32 height = 1; int32 width = 2; int32 colorspace = 3;
             bytes encoded_image_string = 4; }

TFRecord framing: u64le(len) + masked_crc32c(len) + payload +
masked_crc32c(payload).  Verified readable by the tensorboardX/TensorBoard
proto parsers (tests/test_torch_runtime.py reads the port's back).
"""

from __future__ import annotations

import io
import socket
import struct
import time
from pathlib import Path

# ---- crc32c (Castagnoli, reflected poly 0x82F63B78), table-driven ---------
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire-format helpers -----------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _event(step: int | None = None, wall_time: float | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    out = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _f_varint(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


class SummaryWriter:
    """Drop-in subset of tensorboardX.SummaryWriter (scalars + images)."""

    def __init__(self, logdir: str) -> None:
        path = Path(logdir)
        path.mkdir(parents=True, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}"
        )
        self._fh = open(path / name, "ab")
        self._record(_event(file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        val = _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(value)))
        self._record(_event(step=int(global_step), summary=val))

    def add_image(self, tag: str, img, global_step: int = 0,
                  dataformats: str = "CHW") -> None:
        """img: uint8 (or [0,1] float) array in CHW or HWC layout."""
        import numpy as np
        from PIL import Image as PILImage

        arr = np.asarray(img)
        if dataformats == "CHW":
            arr = arr.transpose(1, 2, 0)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format="PNG")
        h, w = arr.shape[0], arr.shape[1]
        channels = 1 if arr.ndim == 2 else arr.shape[-1]
        image = (
            _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, channels)
            + _f_bytes(4, buf.getvalue())
        )
        val = _f_bytes(1, _f_bytes(1, tag.encode()) + _f_bytes(4, image))
        self._record(_event(step=int(global_step), summary=val))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class NullWriter:
    """The sink of a process other than 0 in a multi-process run, where
    process 0 alone writes the event file (the reference's rank-0 logger)."""

    def add_scalar(self, *args, **kwargs) -> None: ...

    def add_image(self, *args, **kwargs) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...
