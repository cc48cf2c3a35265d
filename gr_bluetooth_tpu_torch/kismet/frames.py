"""14-byte LAP frame codec + bounded wake-fd queue.

A copy of gr_bluetooth_tpu/kismet/frames.py (host code, no device).

Frame layout mirrors bluetooth_kismet_block::enqueue
(bluetooth_kismet_block.cc:95-110): 6 zero bytes (dst), 3 zero bytes +
3-byte big-endian LAP (src low bits), then ether_type 0xFFF0 — i.e. a
pseudo-ethernet header whose payload is implied empty; the dissector
(packet_bluetooth.cc:36-74) reads the LAP back out of bytes 9..11.

The queue mirrors the reference's pthread mutex + socketpair wake
(bluetooth_kismet_block.cc:107-125): bounded at 20 frames (overflow frames
are dropped, matching the "queue too big" branch), with an eventfd-style
pipe a poll loop can select on.  Thread-safe: the DSP thread enqueues,
a consumer (server / UI) drains.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

__all__ = ["LapFrame", "FrameQueue", "ETHER_TYPE", "MAX_QUEUE"]

ETHER_TYPE = 0xFFF0        # multi_sniffer_impl.h:52 / kismet frame bytes 12-13
MAX_QUEUE = 20             # bluetooth_kismet_block.cc:112


@dataclass(frozen=True)
class LapFrame:
    lap: int
    channel: int
    clkn: int = 0

    def pack(self) -> bytes:
        b = bytearray(14)
        b[9] = (self.lap >> 16) & 0xFF
        b[10] = (self.lap >> 8) & 0xFF
        b[11] = self.lap & 0xFF
        b[12] = (ETHER_TYPE >> 8) & 0xFF
        b[13] = ETHER_TYPE & 0xFF
        return bytes(b)

    @classmethod
    def unpack(cls, data: bytes, channel: int = -1,
               clkn: int = 0) -> "LapFrame":
        if len(data) < 14 or (data[12] << 8 | data[13]) != ETHER_TYPE:
            raise ValueError("not a btbb LAP frame")
        lap = data[9] << 16 | data[10] << 8 | data[11]
        return cls(lap=lap, channel=channel, clkn=clkn)


class FrameQueue:
    """Bounded thread-safe frame queue with a pollable wake fd."""

    def __init__(self, maxsize: int = MAX_QUEUE):
        self.maxsize = maxsize
        self._q: list[LapFrame] = []
        self._lock = threading.Lock()
        self._rfd, self._wfd = os.pipe()
        os.set_blocking(self._rfd, False)
        self._pending = False
        self.n_dropped = 0

    @property
    def wake_fd(self) -> int:
        """File descriptor that becomes readable when frames are pending
        (the reference's fake_fd socketpair, bluetooth_kismet_block.cc:120)."""
        return self._rfd

    def put(self, frame: LapFrame) -> bool:
        with self._lock:
            if len(self._q) >= self.maxsize:
                self.n_dropped += 1          # "queue too big" drop branch
                return False
            self._q.append(frame)
            if not self._pending:
                self._pending = True
                os.write(self._wfd, b"\x01")
        return True

    def drain(self) -> list[LapFrame]:
        with self._lock:
            out, self._q = self._q, []
            if self._pending:
                try:
                    while os.read(self._rfd, 64):
                        pass
                except BlockingIOError:
                    pass
                self._pending = False
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self):
        os.close(self._rfd)
        os.close(self._wfd)
