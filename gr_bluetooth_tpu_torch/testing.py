"""Golden-capture builders: piconet-consistent synthetic wideband IQ.

The reference's integration story was real captures (samples/*.cfile,
stripped from the snapshot); we synthesize captures where every packet is
hop/clock/whitening-consistent with a simulated master, so tests can assert
exact UAP/clock recovery (SURVEY §4).  Copy of gr_bluetooth_tpu/testing.py
over the port's own encoders and synthesizer.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import SYMBOLS_PER_SLOT
from .core import hop, le_ll, packets
from .core.le_tables import LE_INDEX2CHAN
from .ops import synth

__all__ = ["PiconetSim", "make_piconet_capture", "make_aliased_capture",
           "make_multi_piconet_capture",
           "LeConnectionSim", "make_le_connection_capture",
           "make_tied_streams"]


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


def make_aliased_capture(sim: PiconetSim, n_slots: int, fs: float = 28e6,
                         center_freq: float = 2440e6, tx_slots=None,
                         noise_std: float = 0.02, seed: int = 0):
    """Folded-band capture: the aliased-USRP2 receiver scenario
    (doc/README.aliasing; SURVEY §2 #28).

    The modified FPGA folds all 79 MHz into the 25 observable channels
    26..50; a packet on true hop channel ch lands at
    aliased_channel(ch) = (ch+24) % 25 + 26 (lib/piconet_impl.cc:520-523).
    This synthesizer places each packet at its *observed* (folded) channel,
    so Hopper(aliased=True) must undo the fold during both CLK1-27
    winnowing and live following.

    Returns (samples, sent) with sent = [(slot, observed_channel, true_channel)].
    """
    sps = int(round(fs / 1e6))
    spslot = SYMBOLS_PER_SLOT * sps
    if tx_slots is None:
        tx_slots = range(0, n_slots - 6, 2)
    plan, sent = [], []
    rng = np.random.default_rng(seed ^ 0xA11A5)
    for slot in tx_slots:
        true_ch = sim.channel_at(slot)
        obs_ch = int(hop.aliased_channel(true_ch))
        payload = bytes(rng.integers(0, 256, 9).tolist())
        bits = sim.packet_bits(slot, 3, payload)
        start = slot * spslot + int(rng.integers(0, 5)) * sps
        plan.append(synth.PlannedPacket(channel=obs_ch, start_sample=start,
                                        bits=bits))
        sent.append((slot, obs_ch, true_ch))
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


# ---------------------------------------------------------------------- LE

@dataclass
class LeConnectionSim:
    """A simulated LE master: advertising, a CONNECT_REQ, then hopped data
    packets (CSA#1, or CSA#2 when ch_sel=1) — ground truth for the
    connection-following path the reference stubs out
    (lib/piconet_impl.cc:551-585)."""
    adv_a: bytes = b"\x11\x22\x33\x44\x55\x66"
    init_a: bytes = b"\xaa\xbb\xcc\xdd\xee\xff"
    conn_aa: int = 0x50655F3A
    crc_init: int = 0x5A6B7C
    hop_increment: int = 7
    interval: int = 6            # 1.25 ms units -> 12 slots
    win_offset: int = 1
    win_size: int = 2
    latency: int = 0
    timeout: int = 100
    ch_map: int = 0x1FFFFFFFFF   # all 37 data channels
    ch_sel: int = 0              # ChSel header bit: 1 -> CSA#2 (BT 5.0)

    def connect_req_bits(self) -> np.ndarray:
        lldata = (self.conn_aa.to_bytes(4, "little") +
                  self.crc_init.to_bytes(3, "little") +
                  bytes([self.win_size]) +
                  self.win_offset.to_bytes(2, "little") +
                  self.interval.to_bytes(2, "little") +
                  self.latency.to_bytes(2, "little") +
                  self.timeout.to_bytes(2, "little") +
                  self.ch_map.to_bytes(5, "little") +
                  bytes([(self.hop_increment & 0x1F) | (0 << 5)]))
        return packets.encode_le_adv(
            0x8E89BED6, 38, 5, self.init_a + self.adv_a + lldata,
            ch_sel=self.ch_sel)

    def data_channel(self, event: int) -> int:
        """LE data channel index for connection event N (CSA#1 or #2)."""
        if self.ch_sel:
            return int(le_ll.csa2_channel(event, self.conn_aa, self.ch_map))
        unmapped = ((event + 1) * self.hop_increment) % 37
        return int(le_ll.csa1_channel(np.int64(unmapped), self.ch_map))

    def data_bits(self, event: int, payload: bytes) -> np.ndarray:
        return packets.encode_le_data(self.conn_aa, self.data_channel(event),
                                      llid=2, payload=payload,
                                      crc_init=self.crc_init, sn=event & 1)


def make_le_connection_capture(sim: LeConnectionSim, n_slots: int, fs: float,
                               center_freq: float, connect_slot: int = 2,
                               n_events: int = 8, noise_std: float = 0.02,
                               seed: int = 3):
    """CONNECT_REQ on advertising channel 38 followed by one data packet at
    each connection-event anchor.  Returns (samples, sent) with
    sent = [(slot, le_index, kind)] for packets inside the band."""
    sps = int(round(fs / 1e6))
    spslot = SYMBOLS_PER_SLOT * sps
    plan, sent = [], []

    def br_channel(index: int) -> int:
        return 2 * int(LE_INDEX2CHAN[index])        # 2402 + 2k MHz grid

    plan.append(synth.PlannedPacket(
        channel=br_channel(38), start_sample=connect_slot * spslot + 8 * sps,
        bits=sim.connect_req_bits()))
    sent.append((connect_slot, 38, "CONNECT_REQ"))

    anchor = connect_slot + 2 * (1 + sim.win_offset)
    rng = np.random.default_rng(seed ^ 0x1E)
    for ev in range(n_events):
        slot = anchor + ev * 2 * sim.interval
        if slot >= n_slots - 1:
            break
        payload = bytes(rng.integers(0, 256, 8).tolist())
        plan.append(synth.PlannedPacket(
            channel=br_channel(sim.data_channel(ev)),
            start_sample=slot * spslot + 8 * sps,
            bits=sim.data_bits(ev, payload)))
        sent.append((slot, sim.data_channel(ev), "DATA"))

    samples = synth.synthesize_capture(plan, n_samples=n_slots * spslot,
                                       fs=fs, center_freq=center_freq,
                                       noise_std=noise_std, seed=seed)
    return samples, sent


def make_tied_streams(n_frames: int, seed: int = 0):
    """Three channel-stream rows on which the 16 timing metrics of the
    demod (ops/demod_kernel.py) tie exactly, at the 4/pi gain of every
    bank, to pin the earliest-hypothesis rule:

    row 0: zeros, so d = 0 and every metric is 0 (hypothesis 0 wins);
    row 1: phase steps of +-pi/2 (y in {1, i, -1, -i}, products exact),
           so every d is +-2 and every interpolated |d| a multiple of 1/4:
           hypotheses 0 and 8 (f = 0) tie at the maximum, every sum exact
           in any order; the earliest, 0, slices the even frames' steps,
           8 would slice the odd ones';
    row 2: a random phase walk.

    Returns (yr, yi) float32 (3, n_frames) and row 1's steps (n_frames -
    1,) of +-1: d[l] = 2 steps[l]."""
    r = np.random.default_rng(seed)
    steps = r.choice(np.array([-1, 1]), n_frames - 1)
    k = np.concatenate([[0], np.cumsum(steps)]) % 4
    y = np.zeros((3, n_frames), np.complex64)
    y[1] = np.array([1, 1j, -1, -1j], np.complex64)[k]
    y[2] = np.exp(1j * np.cumsum(r.normal(0, 0.8, n_frames)))
    return (np.ascontiguousarray(y.real, np.float32),
            np.ascontiguousarray(y.imag, np.float32), steps)
