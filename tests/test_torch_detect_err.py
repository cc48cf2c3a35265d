"""K2's error-count planes and the dense detector entry points of the
port against the JAX package.

  * detect_words_plain(..., emit_err=True) against the Pallas kernel
    (detect_pallas.detect_words, interpret mode): hit, gate and the 7
    bit-sliced error planes equal at every offset < n, for ragged channel
    counts and offset counts;
  * gated_error and classic_detect_words against detect_pallas'
    gated_error and classic_detect_pallas (interpret mode), and against
    the XLA formulation detect._classic_detect_impl.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.core import access_code
from gr_bluetooth_tpu.ops import detect as jdetect
from gr_bluetooth_tpu.ops import detect_pallas as jpallas
from gr_bluetooth_tpu_torch.ops import detect_kernel
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

LAPS = (0x123456, 0x9E8B33, 0x000000, 0xFFFFFF, 0x24D952, 0x5A17EC)


def _bits(seed, C, T, n_plants=6):
    """Random symbols with access codes planted at the first and last
    offsets and across word and tile edges, some with flipped bits."""
    r = np.random.default_rng(seed)
    bits = r.integers(0, 2, (C, T)).astype(np.int8)
    n = T - 71
    spots = sorted({0, n - 1, min(31, n - 1), min(4095, n - 1),
                    int(r.integers(0, n))})
    for i, off in enumerate(spots[:n_plants]):
        ac = access_code.ac_bits(LAPS[i % len(LAPS)])[:68].copy()
        for j in r.choice(np.arange(5, 38), size=i % 4, replace=False):
            ac[j] ^= 1
        bits[i % C, off:off + 68] = ac
    return bits


def _unpack(planes, n):
    return detect_kernel.unpack_words(torch.as_tensor(np.array(planes)),
                                      n).numpy()


# n = 1; n = 64, a whole number of words; n = 1234, a ragged last word;
# n = 4225, past the Pallas kernel's first 4096-offset tile
@pytest.mark.parametrize("C,T,max_ac_errors", [(1, 72, 6), (2, 135, 1),
                                               (9, 1305, 6), (11, 4296, 1)])
def test_error_planes_match_pallas(C, T, max_ac_errors):
    bits = _bits(C * T, C, T)
    n = T - 71
    words = np.array(jpallas.pack_bits_words(bits))
    hj, gj, ej = jpallas.detect_words(jnp.asarray(words), n, max_ac_errors,
                                      interpret=True, emit_err=True)
    masks = torch.from_numpy(detect_kernel.ac_masks())
    h, g, e = detect_kernel.detect_words_plain(torch.from_numpy(words), n,
                                               max_ac_errors, masks,
                                               emit_err=True)
    assert e.shape == (detect_kernel.N_ERR, C, -(-n // 32)) == ej.shape
    assert np.array_equal(h.numpy(), np.asarray(hj))
    assert np.array_equal(g.numpy(), np.asarray(gj))
    assert np.array_equal(_unpack(e, n), _unpack(ej, n))
    # the wrapper takes the plain version for a CPU tensor
    w = detect_kernel.detect_words(torch.from_numpy(words), n,
                                   max_ac_errors, masks, emit_err=True)
    assert all(torch.equal(a, b) for a, b in zip(w, (h, g, e)))
    # the planes are the binary digits of the error count
    count = (_unpack(e, n).astype(np.int64) <<
             np.arange(7)[:, None, None]).sum(0)
    lap = bits[0, 38:62]
    want = int((bits[0, :68] != (jdetect._A68 @ lap + jdetect._C68v) % 2)
               .sum())
    assert count[0, 0] == want


@pytest.mark.parametrize("C,T", [(1, 72), (11, 2500)])
def test_gated_error_and_classic_detect_match_jax(C, T):
    bits = _bits(7 * T + C, C, T)
    ref = np.asarray(jpallas.gated_error(bits, interpret=True))
    got = detect_kernel.gated_error(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (C, T - 71)
    assert np.array_equal(got.numpy(), ref)
    assert (ref < 69).any() and ((ref == detect_kernel.BIG).any() or T < 100)

    hj, ej = jpallas.classic_detect_pallas(bits, max_ac_errors=6,
                                           interpret=True)
    h, e = detect_kernel.classic_detect_words(torch.from_numpy(bits), 6)
    assert np.array_equal(h.numpy(), np.asarray(hj))
    assert np.array_equal(e.numpy(), np.asarray(ej))

    hx, ex = jdetect._classic_detect_impl(
        jnp.asarray(bits), jnp.asarray(jdetect._A68),
        jnp.asarray(jdetect._C68v), 6, 2)
    hx, ex = np.asarray(hx), np.asarray(ex)
    assert np.array_equal(h.numpy(), hx)
    assert np.array_equal(e.numpy()[hx], ex[hx])
    assert h.numpy()[0, 0]


def test_gated_error_takes_float_bits_and_rejects_short_blocks():
    bits = _bits(5, 2, 200)
    a = detect_kernel.gated_error(torch.from_numpy(bits))
    b = detect_kernel.gated_error(torch.from_numpy(bits.astype(np.float32)))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        detect_kernel.gated_error(torch.zeros((2, 71)))
