"""demod_pack's earliest-tie rule against the JAX package.

On rows whose 16 timing metrics tie exactly (testing.make_tied_streams:
all zeros, and +-pi/2 phase steps where hypotheses 0 and 8 tie at the
maximum with every sum exact), the plain PyTorch version (torch.argmax)
and the TPU kernel demod_timing_pack (first-max scan, Pallas in
interpret mode) both take the earliest hypothesis, 0: the same words,
bit for bit.  The CUDA kernel is held to the plain version on the same
rows on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_bluetooth_tpu.ops import demod_kernel as jdemod
from gr_bluetooth_tpu_torch.ops import demod_kernel, detect_kernel, pfb, snr
from gr_bluetooth_tpu_torch.testing import make_tied_streams
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n_sym", [2048, 1900])
def test_demod_plain_takes_the_earliest_tie_like_jax(n_sym):
    """Four groups (the last one short for n_sym = 1900, with a tail
    word); the JAX kernel reads a window of 1152 frames per group."""
    gain = pfb.make_pfb_bank(8e6, 2441e6).demod_gain
    n_t = -(-n_sym // demod_kernel.GROUP)
    F = (n_t - 1) * 1024 + 1152
    yr, yi, steps = make_tied_streams(F, seed=n_sym)
    ref = np.asarray(jdemod.demod_timing_pack(jnp.asarray(yr),
                                              jnp.asarray(yi), gain, n_sym,
                                              interpret=True))
    sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(8e6, 2441e6))
    words, _ = demod_kernel.demod_pack_plain(
        torch.from_numpy(yr), torch.from_numpy(yi), gain, n_sym,
        torch.from_numpy(sc.taps_re), torch.from_numpy(sc.taps_im), 20)
    assert np.array_equal(words.numpy(), ref)
    # the zero row: hypothesis 0 of 16 equal metrics, soft 0 -> ones
    tail = (1 << (n_sym % 32)) - 1 if n_sym % 32 else -1
    assert (ref[0, :-1] == -1).all() and ref[0, -1] == np.int32(
        np.uint32(tail & 0xFFFFFFFF))
    # the step row: hypothesis 0 slices the even frames' steps, which
    # differ from the odd frames' (hypothesis 8's) in most words
    even = detect_kernel.pack_bits_words(
        torch.from_numpy(steps[0:2 * n_sym:2] > 0)[None]).numpy()
    odd = detect_kernel.pack_bits_words(
        torch.from_numpy(steps[1:2 * n_sym:2] > 0)[None]).numpy()
    assert np.array_equal(ref[1:2], even)
    assert (ref[1:2] != odd).mean() > 0.9
