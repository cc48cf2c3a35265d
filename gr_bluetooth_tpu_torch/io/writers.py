"""Packet output sinks: live TAP ("btbb" interface, Wireshark-dissectable)
and pcap files, both carrying the reference's pseudo-ethernet framing
(ether_type 0xFFF0, multi_sniffer_impl.h:52) around the 9-byte
meta+header tun_format payload (lib/packet_impl.cc:1175-1202).

Frame addressing mirrors the reference call sites: decoded packets go to
dst = BD_ADDR-derived address with src 0 (multi_sniffer_impl.cc:262-265);
ID packets are empty frames to dst = LAP (:233).

The TAP path requires the native runtime (ioctls) and root; the pcap path
works anywhere (native writer when available, pure Python otherwise) and
is the portable equivalent the reference lacked.

The port of gr_bluetooth_tpu/io/writers.py: the same framing, byte for
byte, over the port's native runtime (io/native.py).
"""
from __future__ import annotations

import struct
import time

from . import native

__all__ = ["ETHER_TYPE", "PcapWriter", "TapWriter"]

ETHER_TYPE = 0xFFF0  # multi_sniffer_impl.h:52


class PcapWriter:
    """Offline Wireshark output: pcap of 0xFFF0 pseudo-ethernet frames."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        self._lib = native.load() if use_native else None
        self._handle = None
        self._f = None
        if self._lib is not None:
            self._handle = self._lib.bt_pcap_open(path.encode(), 1)
        if self._handle is None:
            self._lib = None
            self._f = open(path, "wb")
            self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                      65535, 1))
        self.n_written = 0

    def _frame(self, payload: bytes, src: int, dst: int) -> bytes:
        hdr = (dst.to_bytes(6, "big") + src.to_bytes(6, "big") +
               ETHER_TYPE.to_bytes(2, "big"))
        return hdr + payload

    def _emit(self, frame: bytes):
        t = time.time()
        sec, usec = int(t), int((t % 1) * 1e6)
        if self._lib is not None:
            self._lib.bt_pcap_write(self._handle, sec, usec, frame,
                                    len(frame))
        else:
            self._f.write(struct.pack("<IIII", sec, usec, len(frame),
                                      len(frame)))
            self._f.write(frame)
        self.n_written += 1

    def write_packet(self, tun_data: bytes, addr: int):
        self._emit(self._frame(tun_data, 0, addr & 0xFFFFFFFFFFFF))

    def write_id(self, lap: int):
        self._emit(self._frame(b"", 0, lap & 0xFFFFFFFFFFFF))

    def close(self):
        if self._lib is not None and self._handle is not None:
            self._lib.bt_pcap_close(self._handle)
            self._handle = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TapWriter:
    """Live TAP interface "btbb" for Wireshark (lib/tun.cc); requires the
    native runtime and net-admin rights.  Degrades to console-only by
    raising — callers treat failure like the reference does
    (multi_sniffer_impl.cc:66-71)."""

    def __init__(self, name: str = "btbb"):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        ether = bytes(6)
        self.fd = lib.bt_mktun(name.encode(), ether)
        if self.fd < 0:
            raise RuntimeError(f"could not open TAP '{name}' "
                               "(needs root/NET_ADMIN)")
        self.n_written = 0

    def write_packet(self, tun_data: bytes, addr: int):
        self._lib.bt_write_frame(self.fd, tun_data, len(tun_data), 0,
                                 addr & 0xFFFFFFFFFFFF, ETHER_TYPE)
        self.n_written += 1

    def write_id(self, lap: int):
        self._lib.bt_write_frame(self.fd, b"", 0, 0, lap & 0xFFFFFFFFFFFF,
                                 ETHER_TYPE)
        self.n_written += 1

    def close(self):
        pass
