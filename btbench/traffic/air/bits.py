"""[Frozen copy of gr_bluetooth_tpu_torch/utils/bits.py.]
Bit-order utilities, vectorized with numpy.

"Air order" is the on-air transmission order: one bit per array element,
LSB of each field first.  "Host order" is ordinary integers.  Conventions
follow doc/bit-order.txt of the reference; the reference's scalar versions
live at lib/packet_impl.cc:76-136 (reverse, air_to_host*, host_to_air).

All functions here are batch-friendly: air arrays may have any number of
leading batch dimensions; the *last* axis is the bit axis.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "reverse8", "air_to_host", "host_to_air", "int_to_bits_msb",
    "bits_msb_to_int", "parity_bits",
]

# 256-entry byte bit-reversal table
_REV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def reverse8(x):
    """Reverse the bits within each byte value (0..255)."""
    return _REV8[np.asarray(x, dtype=np.uint8)]


def air_to_host(air, bits: int | None = None):
    """Air-order bit array (LSB-first) -> host integer(s).

    `air[..., i]` holds bit i of the result.  Returns int64 to hold up to
    32-bit fields safely (1-D inputs return a python-int-compatible
    np.int64 via the packbits fast path — the mul/sum form cost ~5 us on
    the per-packet host hot path)."""
    air = np.asarray(air)
    if bits is None:
        bits = air.shape[-1]
    if air.ndim == 1 and bits <= 64:
        by = np.packbits(air[:bits].astype(np.uint8, copy=False),
                         bitorder="little").tobytes()
        return np.int64(int.from_bytes(by, "little"))
    w = (1 << np.arange(bits, dtype=np.int64))
    return (air[..., :bits].astype(np.int64) * w).sum(axis=-1)


def host_to_air(value, bits: int):
    """Host integer(s) -> air-order bit array (LSB-first) along a new last axis."""
    value = np.asarray(value, dtype=np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    return ((value[..., None] >> shifts) & np.uint64(1)).astype(np.uint8)


def int_to_bits_msb(value, bits: int):
    """Host integer(s) -> MSB-first bit array along a new last axis."""
    return host_to_air(value, bits)[..., ::-1]


def bits_msb_to_int(bits_arr):
    """MSB-first bit array -> host integer(s)."""
    return air_to_host(np.asarray(bits_arr)[..., ::-1])


def parity_bits(x):
    """Elementwise GF(2) reduction: integer array -> parity of each element."""
    x = np.asarray(x, dtype=np.int64)
    return (x & 1).astype(np.uint8)
