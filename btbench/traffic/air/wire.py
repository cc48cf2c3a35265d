"""Wire formats: (2, N) float32 planes to the SDR's interleaved samples and back.

A frozen copy, for the benchmark's yardstick, of io/ingest.py's wire encoding
(gr_bluetooth_tpu_torch).  It imports nothing of the port; later
changes to the port leave it as it is.
"""
from __future__ import annotations

import numpy as np


WIRES = {
    "f32": (np.float32, 1.0),
    "i16": (np.int16, 1.0 / 32768.0),
    "i8": (np.int8, 1.0 / 128.0),
    "i4": (np.uint8, 1.0 / 8.0),
    "u8": (np.uint8, 1.0 / 127.5),
}


WIRE_ZERO_BYTE = {"f32": 0, "i16": 0, "i8": 0, "u8": 127, "i4": 0}


def wire_encode(x, wire: str) -> np.ndarray:
    """(2, N) float32 planes -> the on-the-wire array, quantized exactly
    as the device-side decode will see it."""
    inter = np.ascontiguousarray(np.asarray(x, np.float32).T)  # (N, 2)
    if wire == "f32":
        return inter
    if wire == "i4":
        q = np.clip(np.round(inter * 8.0), -8, 7).astype(np.int8)
        return ((q[:, 0] & 0xF) | ((q[:, 1] & 0xF) << 4)).astype(np.uint8)
    if wire == "u8":
        return np.clip(np.round(inter * 127.5 + 127.5), 0,
                       255).astype(np.uint8)
    dtype, scale = WIRES[wire]
    lim = {"i16": 32767.0, "i8": 127.0}[wire]
    return np.clip(inter / scale, -lim - 1, lim).astype(dtype)


def wire_decode_np(inter: np.ndarray, wire: str) -> np.ndarray:
    """Wire array -> (2, N) float32 planes; the numpy mirror of
    wire_decode (used for carries and file replays)."""
    _, scale = WIRES[wire]
    if wire == "i4":
        b = np.asarray(inter).astype(np.int32)
        i4 = (b & 0xF).astype(np.float32)
        q4 = ((b >> 4) & 0xF).astype(np.float32)
        i4 -= 16.0 * (i4 >= 8)
        q4 -= 16.0 * (q4 >= 8)
        return np.ascontiguousarray(np.stack([i4, q4]) * scale)
    x = np.asarray(inter).astype(np.float32).T
    if wire == "u8":
        x = x - 127.5
    return np.ascontiguousarray(x * scale if scale != 1.0 else x)
