"""Entry points of the port for a compile check and a multi-device dry
run: the counterpart of the JAX package's __graft_entry__.py.

entry() returns the compiled step of the 16 Msps front end
(FrontEnd(16e6, 2441e6, block_slots=16)) with a block of zeros to call
it on, as the JAX entry() returns its jitted step: on a CUDA device a
graph captured once and replayed per call.

    from gr_bluetooth_tpu_torch import graft_entry
    step, (x,) = graft_entry.entry()      # on the card
    snr_db, n_hits, tab, windows, n_le, le_tab, le_windows = step(x)

dryrun_multichip(n) is parallel/dryrun.py's.
"""
from __future__ import annotations

import torch

from .models.frontend import FrontEnd
from .parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None):
    """(compiled step, (x,)): the flat chain's step of
    FrontEnd(16e6, 2441e6, block_slots=16) on `device` (the CUDA device
    unless the caller names another; with none and no card it raises),
    and x, zeros (2, block_samples) float32 on that device.  The step is
    the JAX FrontEnd._jit_step's counterpart: _device_step on flat
    planes."""
    fe = FrontEnd(16e6, 2441e6, block_slots=16, device=device)
    x = torch.zeros((2, fe.block_samples), dtype=torch.float32,
                    device=fe.device)
    return fe.compiled_step("flat"), (x,)
