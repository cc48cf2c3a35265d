"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller names another
device.  With no device given and no card present they raise: nothing
carries on quietly on the CPU.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "fp32_matmul"]


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device,
    and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def fp32_matmul():
    """Matmuls and cuDNN convolutions enqueued inside the block run in
    FP32, not TF32; both process-wide flags are restored on exit, so a
    caller's own setting holds outside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
