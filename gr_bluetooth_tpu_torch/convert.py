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

from .models.frontend import (ac_product_consts, consts_to_device,
                              le_step_consts)
from .ops.detect_kernel import ac_masks

__all__ = ["consts_from_jax", "state_from_jax"]

_STATICS = ("decim", "n_sym", "n_y", "slot_ch", "kappa", "demod_gain",
            "max_ac_errors", "delay_sym", "squelch", "max_hits",
            "max_le_hits")


def consts_from_jax(step_kwargs: dict):
    """JAX `_step_kwargs` (numpy arrays + scalar statics) -> (consts,
    statics): the port's constant tensors on the CPU (move them with
    `.to(device)`) and its scalar step arguments.

    Requires the packed (use_pallas) PFB configuration, the only one the
    port runs: word_s0 and word_mask_a must be present.  The affine
    access-code map (A68, C68v) comes across as detect_words' masks and
    as the hit rows' product constants.  With LE on (with_le) the LE row
    constants come across too (the whitening bits packed to a word per
    row), with the LE squelch word constants and the LE distance tables,
    which the JAX step holds as module constants."""
    kw = step_kwargs
    if not kw.get("is_pfb") or kw.get("word_s0") is None:
        raise ValueError("consts_from_jax needs the packed PFB step "
                         "(even-integer rate, use_pallas=True)")
    a68 = np.asarray(kw["A68"]).astype(np.int64)
    c68v = np.asarray(kw["C68v"]).astype(np.int64)
    consts = dict(
        h0=kw["h0"], h1=kw["h1"], dft_c=kw["dft_c"], dft_s=kw["dft_s"],
        bin_odd=kw["bin_odd"], probe_re=kw["probe_re"],
        probe_im=kw["probe_im"], ac_masks=ac_masks(a68, c68v),
        word_s0=kw["word_s0"], word_mask_a=kw["word_mask_a"],
        **ac_product_consts(a68, c68v))
    if kw.get("with_le"):
        consts["le_rows"] = np.asarray(kw["le_rows"]).astype(np.int64)
        consts.update(le_step_consts(kw["le_white"], kw["le_aa_on"],
                                     kw["le_max_dist"], n_sym=kw["n_sym"],
                                     delay_sym=kw["delay_sym"]))
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
