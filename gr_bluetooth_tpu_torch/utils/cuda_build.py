"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded with ctypes.  The build runs at first use, from the
package's own sources, into gr_bluetooth_tpu_torch/_build/; the file
name carries a digest of the source, so an edited kernel is rebuilt and
a stale library is never loaded.  All missing libraries are compiled
at once, one nvcc process per source, started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_logs", "check", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("pfb_snr", "demod_pack", "detect_words", "pfb_channelize",
           "deinterleave", "le_detect", "hit_table")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}        # source -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    raise with nvcc's output if any fails.  Returns name -> library."""
    targets = {n: _target(n) for n in SOURCES}
    todo = [n for n, t in targets.items() if not t.exists()]
    if todo:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            build_logs[n] = out
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
            else:
                os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" +
                               "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, building all of them first if
    any is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def check(rc: int, what: str) -> None:
    """Raise for a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
