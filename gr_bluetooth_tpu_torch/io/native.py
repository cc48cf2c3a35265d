"""ctypes bindings for the port's native I/O runtime (native/btio.cc).

The port of gr_bluetooth_tpu/io/native.py over the package's own copy
of btio.cc.  The library builds at first use with g++ into the
package's _build/, named by a digest of the source and the flags (as
utils/cuda_build.py names the kernels), so an edited source rebuilds
and a stale library is never loaded.  load() returns None when the
toolchain is missing, and callers then take their pure-Python paths:
host I/O, not a device.  build() does the same for the package's other
host C++ (native/batch_decode.cc, core/batch_decode.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "CXX_FLAGS", "build", "library_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "btio.cc"
BUILD = _PKG / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-pthread", "-std=c++17")
_LIB = None
_TRIED = False


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha1(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path | None:
    """The library of a native/*.cc source, compiled if missing; None
    where g++ is missing or fails."""
    so = library_path(source)
    if so.exists():
        return so
    try:
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def load():
    """Load (building if needed) libbtio; returns None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.bt_mktun.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.bt_mktun.restype = ctypes.c_int
    lib.bt_write_frame.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_ushort]
    lib.bt_write_frame.restype = ctypes.c_int
    lib.bt_pcap_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.bt_pcap_open.restype = ctypes.c_void_p
    lib.bt_pcap_write.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.c_uint32]
    lib.bt_pcap_write.restype = ctypes.c_int
    lib.bt_pcap_close.argtypes = [ctypes.c_void_p]
    lib.bt_ring_create.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                   ctypes.c_int]
    lib.bt_ring_create.restype = ctypes.c_void_p
    lib.bt_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.bt_ring_pop.restype = ctypes.c_long
    lib.bt_ring_pop_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t, ctypes.c_int]
    lib.bt_ring_pop_wait.restype = ctypes.c_long
    lib.bt_ring_available.argtypes = [ctypes.c_void_p]
    lib.bt_ring_available.restype = ctypes.c_long
    lib.bt_ring_overruns.argtypes = [ctypes.c_void_p]
    lib.bt_ring_overruns.restype = ctypes.c_int
    lib.bt_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.bt_ring_dropped.restype = ctypes.c_uint64
    lib.bt_ring_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib
