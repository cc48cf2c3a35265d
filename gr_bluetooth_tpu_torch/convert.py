"""Carry the JAX front end's constants across to the port.

The system has no weights: its parameters are the channelizer bank and
the detector constants.  `consts_from_jax` takes the JAX package's
`FrontEnd._step_kwargs`, with every array already converted to numpy,
and returns what the port's `FrontEnd` holds in `consts` and `statics`,
so a caller can run both front ends on identical constants.

The modes' state crosses too: `state_from_jax` restores a JAX sniffer's
checkpoint (piconet registries and stream cursor) into the port's.
"""
from __future__ import annotations

import numpy as np

from .models.frontend import consts_to_device
from .ops.detect import le_table_consts
from .ops.detect_kernel import ac_masks

__all__ = ["consts_from_jax", "state_from_jax"]

_STATICS = ("decim", "n_sym", "n_y", "slot_ch", "kappa", "demod_gain",
            "max_ac_errors", "delay_sym", "squelch", "max_hits",
            "max_le_hits")
_LE = ("le_rows", "le_white", "le_aa_on", "le_max_dist")


def consts_from_jax(step_kwargs: dict):
    """JAX `_step_kwargs` (numpy arrays + scalar statics) -> (consts,
    statics): the port's constant tensors on the CPU (move them with
    `.to(device)`) and its scalar step arguments.

    Requires the packed (use_pallas) PFB configuration, the only one the
    port runs: word_s0 and word_mask_a must be present.  With LE on
    (with_le) the LE row constants come across too, with the LE distance
    tables, which the JAX step holds as module constants."""
    kw = step_kwargs
    if not kw.get("is_pfb") or kw.get("word_s0") is None:
        raise ValueError("consts_from_jax needs the packed PFB step "
                         "(even-integer rate, use_pallas=True)")
    consts = dict(
        h0=kw["h0"], h1=kw["h1"], dft_c=kw["dft_c"], dft_s=kw["dft_s"],
        bin_odd=kw["bin_odd"], probe_re=kw["probe_re"],
        probe_im=kw["probe_im"],
        ac_masks=ac_masks(np.asarray(kw["A68"]).astype(np.int64),
                          np.asarray(kw["C68v"]).astype(np.int64)),
        word_s0=kw["word_s0"], word_mask_a=kw["word_mask_a"])
    if kw.get("with_le"):
        consts.update({k: kw[k] for k in _LE})
        consts["le_rows"] = np.asarray(kw["le_rows"]).astype(np.int64)
        consts.update(le_table_consts())
    consts = consts_to_device(consts, "cpu")
    statics = {k: kw[k] for k in _STATICS}
    return consts, statics


def state_from_jax(sniffer, path: str) -> int:
    """Restore into the port's `sniffer` a checkpoint that the JAX
    package's Sniffer.save_state wrote (gr_bluetooth_tpu/io/checkpoint.py):
    the two packages write the same format, so this is the port's
    Sniffer.restore_state, and the piconets take the sniffer's device.
    Returns the stream cursor to resume from (pass it as start_clkn)."""
    return sniffer.restore_state(path)
