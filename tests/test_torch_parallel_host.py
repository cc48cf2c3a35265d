"""The port's multiprocess host decode (models/parallel_host.py) against
the port's single-process Sniffer and the JAX package's, on
tests/test_parallel_host.py's capture: three piconets, 48 slots at
4 Msps, made from a seed with numpy.

The pool (two spawned workers, each piconet on the CPU) must decode
exactly the packets the port's Sniffer decodes, per LAP and in order,
and those are the JAX package's Sniffer's.
"""
import numpy as np
import pytest

from gr_bluetooth_tpu.models.sniffer import Sniffer as JSniffer
from gr_bluetooth_tpu.testing import (PiconetSim as JPiconetSim,
                                      make_multi_piconet_capture as jcapture)
from gr_bluetooth_tpu_torch.models import parallel_host
from gr_bluetooth_tpu_torch.models.parallel_host import ParallelHostDecoder
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.testing import (PiconetSim,
                                            make_multi_piconet_capture)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

LAPS = [(0x24D952, 0x47), (0x1A2B3C, 0x99), (0x654321, 0x13)]


def _key(lap, uap, clkn, channel, ptype, plen, payload):
    return (lap, uap, clkn, channel, ptype, plen, payload)


@pytest.fixture(scope="module")
def decoded():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")                # the spawned workers
    try:
        yield _decode()
    finally:
        mp.undo()


def _decode():
    kw = dict(n_slots=48, fs=4e6, center_freq=2441e6, seed=7,
              noise_std=0.02)
    samples, _ = make_multi_piconet_capture(
        [PiconetSim(lap=lap, uap=uap, clk0=0x100 * (i + 3))
         for i, (lap, uap) in enumerate(LAPS)], **kw)
    jsamples, _ = jcapture(
        [JPiconetSim(lap=lap, uap=uap, clk0=0x100 * (i + 3))
         for i, (lap, uap) in enumerate(LAPS)], **kw)
    assert np.array_equal(samples, jsamples)
    x = np.stack([samples.real, samples.imag]).astype(np.float32)

    sn = Sniffer(4e6, 2441e6, block_slots=16, enable_le=False, device="cpu")
    blocks = list(sn.fe.stream(x))
    sn.run_blocks(iter(blocks))
    single = [_key(p.lap, p.uap, p.clkn, p.channel, p.packet_type,
                   p.payload_length,
                   None if p.payload is None
                   else np.packbits(p.payload).tobytes())
              for p in sn.decoded]
    js = JSniffer(4e6, 2441e6, block_slots=16, enable_le=False)
    js.run(x)
    jax = [_key(p.lap, p.uap, p.clkn, p.channel, p.packet_type,
                p.payload_length,
                None if p.payload is None
                else np.packbits(p.payload).tobytes()) for p in js.decoded]
    with ParallelHostDecoder(n_workers=2) as pool:
        assert pool.n == 2 and len(pool._procs) == 2
        got = pool.drive(sn.fe, iter(blocks))
        assert all(p.is_alive() for p in pool._procs)
    assert pool._procs == []
    pooled = [_key(d.lap, d.uap, d.clkn, d.channel, d.packet_type,
                   d.payload_length, d.payload) for d in got]
    assert all(isinstance(d, parallel_host.DecodedPacket) for d in got)
    return single, jax, pooled


def _per_lap(rows):
    out = {}
    for r in rows:
        out.setdefault(r[0], []).append(r)
    return out


def test_pool_equals_single_sniffer_per_lap_in_order(decoded):
    single, _, pooled = decoded
    assert single, "the single decoder decoded nothing"
    assert _per_lap(pooled) == _per_lap(single)
    assert sorted(pooled) == sorted(single)


def test_single_sniffer_equals_jax(decoded):
    single, jax, _ = decoded
    assert single == jax


def test_pool_output_is_ordered_by_clock_and_channel(decoded):
    _, _, pooled = decoded
    assert [(r[2], r[3]) for r in pooled] == sorted((r[2], r[3])
                                                    for r in pooled)
