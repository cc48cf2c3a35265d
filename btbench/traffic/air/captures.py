"""Piconet-consistent synthetic captures (testing.py's capture functions).

A frozen copy, for the benchmark's yardstick, of the classic capture
functions of gr_bluetooth_tpu_torch/testing.py.  It imports nothing of
the port; later changes to the port leave it as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import SYMBOLS_PER_SLOT
from . import hop, packets, synth


@dataclass
class PiconetSim:
    lap: int
    uap: int
    nap: int = 0x1234
    clk0: int = 0          # master CLK1-27 at capture slot 0
    afh: bool = False

    def __post_init__(self):
        self._consts = hop.address_precalc(
            ((self.uap << 24) | self.lap) & 0xFFFFFFF)

    def channel_at(self, slot: int) -> int:
        return int(hop.hop((self.clk0 + slot) & 0x7FFFFFF, self._consts,
                           afh=self.afh))

    def packet_bits(self, slot: int, type_code: int = 3,
                    payload: bytes = b"\x01\x02\x03",
                    fhs: bool = False, voice: bytes = b"") -> np.ndarray:
        clk = (self.clk0 + slot) & 0x7FFFFFF
        if fhs:
            return packets.encode_fhs_packet(self.lap, self.uap, self.nap,
                                             clock=clk, clk27_value=clk)
        return packets.encode_classic_packet(self.lap, self.uap, clk,
                                             type_code, payload,
                                             voice_bytes=voice)


def make_piconet_capture(sim: PiconetSim, n_slots: int, fs: float,
                         center_freq: float, tx_slots=None,
                         payload_fn=None, noise_std: float = 0.02,
                         seed: int = 0, jitter_symbols: int = 5):
    """Synthesize a capture of `n_slots`; master transmits on `tx_slots`
    (default: every even slot) at the hop channel of its clock.

    Returns (samples, sent) where sent = [(slot, channel, type_code)] for
    packets actually placed (all of them; filter by the bank's coverage in
    tests)."""
    sps = int(round(fs / 1e6))
    spslot = SYMBOLS_PER_SLOT * sps
    if tx_slots is None:
        tx_slots = range(0, n_slots - 6, 2)
    plan, sent = [], []
    rng = np.random.default_rng(seed ^ 0x5EED)
    for slot in tx_slots:
        ch = sim.channel_at(slot)
        if payload_fn is not None:
            spec = payload_fn(slot)
            type_code, payload, fhs = spec[:3]
            voice = spec[3] if len(spec) > 3 else b""
        else:
            type_code, payload, fhs, voice = \
                3, bytes(rng.integers(0, 256, 9).tolist()), False, b""
        bits = sim.packet_bits(slot, type_code, payload, fhs=fhs,
                               voice=voice)
        start = slot * spslot + int(rng.integers(0, jitter_symbols)) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        sent.append((slot, ch, 2 if fhs else type_code))
    samples = synth.synthesize_capture(plan, n_samples=n_slots * spslot,
                                       fs=fs, center_freq=center_freq,
                                       noise_std=noise_std, seed=seed)
    return samples, sent


def make_multi_piconet_capture(sims, n_slots: int, fs: float,
                               center_freq: float, noise_std: float = 0.02,
                               seed: int = 0, jitter_symbols: int = 5):
    """Several masters interleaved in one capture: sim k transmits on slots
    congruent to k modulo len(sims) (TDD-style, so packets never overlap in
    time) at its own hop channel — ground truth for the sniffer's
    all-piconets-concurrently contract (multi_sniffer_impl.cc:82-166).

    Returns (samples, sent) with sent = [(slot, channel, lap)]."""
    sps = int(round(fs / 1e6))
    spslot = SYMBOLS_PER_SLOT * sps
    plan, sent = [], []
    rng = np.random.default_rng(seed ^ 0x3A7)
    k = len(sims)
    for slot in range(0, n_slots - 6):
        sim = sims[slot % k]
        ch = sim.channel_at(slot)
        payload = bytes(rng.integers(0, 256, 9).tolist())
        bits = sim.packet_bits(slot, 3, payload)
        start = slot * spslot + int(rng.integers(0, jitter_symbols)) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        sent.append((slot, ch, sim.lap))
    samples = synth.synthesize_capture(plan, n_samples=n_slots * spslot,
                                       fs=fs, center_freq=center_freq,
                                       noise_std=noise_std, seed=seed)
    return samples, sent


_HOSTILE_TYPES = (                 # (type_code, slots, user payload bytes)
    (3, 1, 17),                    # DM1
    (4, 1, 27),                    # DH1
    (10, 3, 119),                  # DM3
    (3, 1, 9),                     # DM1
    (14, 5, 220),                  # DM5
    (11, 3, 180),                  # DH3
    (3, 1, 17),                    # DM1
    (15, 5, 330),                  # DH5
)


def make_hostile_capture(sims, n_slots: int, fs: float, center_freq: float,
                         noise_std: float = 0.02, seed: int = 0):
    """Worst-case air load for the host decode half: EVERY slot occupied
    back-to-back, masters round-robin, mixed 1/3/5-slot ACL types (DM and
    DH), each at its owner's hop channel.  Pair with >= 3 sims in
    discovery for the 64-candidate clock-attack cost and enable_le for
    the LE parse load.

    Returns (samples, sent) with sent = [(slot, channel, lap, type)]."""
    sps = int(round(fs / 1e6))
    spslot = SYMBOLS_PER_SLOT * sps
    plan, sent = [], []
    rng = np.random.default_rng(seed ^ 0x7E57)
    k = len(sims)
    slot, turn = 0, 0
    while slot < n_slots - 6:
        sim = sims[turn % k]
        t, nslots, nbytes = _HOSTILE_TYPES[turn % len(_HOSTILE_TYPES)]
        if slot + nslots > n_slots - 5:
            break
        ch = sim.channel_at(slot)
        payload = bytes(rng.integers(0, 256, nbytes).tolist())
        bits = sim.packet_bits(slot, t, payload)
        start = slot * spslot + int(rng.integers(0, 5)) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        sent.append((slot, ch, sim.lap, t))
        slot += nslots
        turn += 1
    samples = synth.synthesize_capture(plan, n_samples=n_slots * spslot,
                                       fs=fs, center_freq=center_freq,
                                       noise_std=noise_std, seed=seed)
    return samples, sent
