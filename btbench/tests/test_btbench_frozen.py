"""The benchmark's frozen copies give the same arrays as the port's own
helpers today, at fixed seeds: the captures, the wire and the plain
front end."""
import numpy as np
import pytest
import torch

from btbench.reference.frontend import RefFrontEnd
from btbench.traffic import generator
from btbench.traffic.air import captures, wire
from btbench.traffic.generator import (Traffic, block_planes,
                                       expected_payload_bits, make_pass)
from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.io import ingest
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd

PICONETS = ((0x24D952, 0x47, 0x12780), (0x1A2B3C, 0x99, 0x00450),
            (0x654321, 0x13, 0x71111))
CFG = dict(sample_rate=8e6, center_freq=2441e6, wire="i8", noise_std=0.02,
           piconets=[list(p) for p in PICONETS])


def _sims(mod):
    return [mod.PiconetSim(lap=a, uap=b, clk0=c) for a, b, c in PICONETS]


@pytest.mark.parametrize("make", ["make_multi_piconet_capture",
                                     "make_hostile_capture"])
def test_captures_equal_the_ports(make):
    seed = 2 ** 31 + 977
    x0, s0 = getattr(testing, make)(_sims(testing), 128, 8e6, 2441e6,
                                       seed=seed)
    x1, s1 = getattr(captures, make)(_sims(captures), 128, 8e6, 2441e6,
                                        seed=seed)
    assert np.array_equal(x0, x1) and s0 == s1


def test_fixed_noise_max_rate_is_the_capture_with_its_noise_seed():
    """A mix's noise_seed keeps the frozen capture's payloads and jitter
    from the run's seed and draws only the noise from its own: at the
    run's own seed it is the capture itself, and at another seed the
    noise (the capture less its packets) is the same."""
    seed = 2 ** 31 + 977
    x0, s0 = captures.make_multi_piconet_capture(_sims(captures), 128, 8e6,
                                                 2441e6, seed=seed)
    make = generator._multi_piconet(seed)
    x1, s1 = make(_sims(captures), 128, 8e6, 2441e6, 0.02, seed)
    assert np.array_equal(x0, x1) and s0 == s1
    noise = []
    for run_seed in (5, 2 ** 33 + 1):
        x, _ = make(_sims(captures), 128, 8e6, 2441e6, 0.02, run_seed)
        clean, _ = make(_sims(captures), 128, 8e6, 2441e6, 0.0, run_seed)
        noise.append(x - clean)
    # equal but for the rounding of a packet added in complex64
    assert np.abs(noise[0] - noise[1]).max() < 1e-6
    assert not np.array_equal(
        make(_sims(captures), 128, 8e6, 2441e6, 0.0, 5)[0],
        make(_sims(captures), 128, 8e6, 2441e6, 0.0, 6)[0])


@pytest.mark.parametrize("air", ["mixed", "survey_ids"])
def test_other_air_refuses_a_noise_seed(air):
    tr = Traffic("t", "closed", air, "sniffer", 128, 1, {"noise_seed": 1})
    with pytest.raises(ValueError):
        make_pass(tr, CFG, 3, step_samples=1, overlap_samples=1,
                  samples_per_slot=1, block_slots=64)


def test_piconet_capture_equals_the_ports():
    sim = dict(lap=0x24D952, uap=0x47, clk0=0x12780)
    x0, s0 = testing.make_piconet_capture(testing.PiconetSim(**sim), 96,
                                          8e6, 2441e6, seed=3)
    x1, s1 = captures.make_piconet_capture(captures.PiconetSim(**sim), 96,
                                           8e6, 2441e6, seed=3)
    assert np.array_equal(x0, x1) and s0 == s1


@pytest.mark.parametrize("w", ["f32", "i16", "i8", "i4", "u8"])
def test_wire_equals_the_ports(w):
    x = np.random.default_rng(5).normal(0, 0.3, (2, 4096)).astype(
        np.float32)
    a, b = ingest.wire_encode(x, w), wire.wire_encode(x, w)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ingest.wire_decode_np(a, w),
                          wire.wire_decode_np(b, w))


def test_pass_truth_and_payloads_match_the_capture():
    fe = FrontEnd(8e6, 2441e6, block_slots=64, device="cpu")
    tr = Traffic("t", "closed", "max_rate", "sniffer", 128, 1)
    p = make_pass(tr, CFG, 41, step_samples=fe.step_samples,
                  overlap_samples=fe.overlap_samples,
                  samples_per_slot=fe.samples_per_slot, block_slots=64)
    x, sent = testing.make_multi_piconet_capture(_sims(testing), 128, 8e6,
                                                 2441e6, seed=41)
    assert [t[:3] for t in p.truth] == sent
    q = ingest.wire_decode_np(ingest.wire_encode(
        np.stack([x.real, x.imag]).astype(np.float32), "i8"), "i8")
    assert np.array_equal(p.planes, q)
    # chunk k of the stream, after the carry, is block k of the pass
    cyclic = np.concatenate([x, x[:fe.overlap_samples]])
    carry, chunks = ingest.wire_chunks(cyclic, fe, "i8")
    assert np.array_equal(carry, p.carry)
    for k, c in enumerate(chunks):
        assert np.array_equal(c, p.chunks[k])
    # a DM1's decoded payload bits: header, body, CRC
    bits = expected_payload_bits(3, b"\x01\x02\x03", 0x47)
    assert bits.shape == (8 * (1 + 3 + 2),)


def test_reference_front_end_equals_the_ports_plain_step():
    fe = FrontEnd(8e6, 2441e6, block_slots=64, enable_le=True,
                  max_ac_errors=6, device="cpu")
    ref = RefFrontEnd(8e6, 2441e6, squelch_db=10.0, block_slots=64,
                      max_ac_errors=6, enable_le=True, device="cpu")
    tr = Traffic("t", "closed", "mixed", "sniffer", 128, 1)
    p = make_pass(tr, CFG, 8, step_samples=fe.step_samples,
                  overlap_samples=fe.overlap_samples,
                  samples_per_slot=fe.samples_per_slot, block_slots=64)
    for k in range(p.n_blocks):
        x = block_planes(p, k, fe.step_samples, fe.overlap_samples)
        prog = [None if o is None else o.numpy()
                for o in fe.fused_step(torch.from_numpy(x))]
        snr, tab, n, le_tab, n_le = ref.step(x)
        assert np.array_equal(prog[0], snr)
        assert np.array_equal(prog[2], tab) and int(prog[1]) == int(n)
        assert np.array_equal(prog[5], le_tab) and int(prog[4]) == int(n_le)
        res = fe.assemble_block(*prog, slot_base=0)
        classic, le = ref.hits(tab, n, le_tab, n_le)
        assert classic == [(h.chan_idx, h.sym_offset, h.clkn, h.lap,
                            h.errors) for h in res.hits]
        assert [(fe.le_rows[r][1], t, s, d) for r, t, s, d in le] == \
            [(h.channel, h.sym_offset, h.clkn, h.distance)
             for h in res.le_hits]
        assert classic                            # the block has hits
