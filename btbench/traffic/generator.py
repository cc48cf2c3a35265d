"""The benchmark's one traffic generator: a mix file's parameters and a
configuration -> the air of one pass, its wire chunks and the truth of
every packet planted in it.

A pass is `pass_slots` slots of air, a whole number of blocks and of
64-slot CLK1-6 periods, synthesized once from the seed by the frozen
capture functions in air/ and replayed in a loop: chunk j of the stream
is block j % P of the pass, cut so that every pass reads exactly what
the first does (the carry that closes pass p is the one that opened
it).  The
piconets are the configuration's; the seed draws payloads, start jitter
and noise, so every seed brings the same packets, channels and sizes.
A mix that names a `noise_seed` draws the noise from it instead, the
same in every run: the detectors' false alarms in the noise are then
the same for every seed, and so is the work.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .air import captures, crc, packets, survey, synth, wire
from .air.bits import host_to_air
from .air.constants import SYMBOLS_PER_SLOT

__all__ = ["Traffic", "Pass", "load_traffic", "make_pass",
           "expected_payload_bits", "AIR"]

_TWO_BYTE_HEADER = (10, 11, 14, 15)       # DM3, DH3, DM5, DH5


@dataclass(frozen=True)
class Traffic:
    name: str
    loop: str                 # "closed" or "open"
    air: str                  # a key of AIR
    mode: str                 # "sniffer" or "survey"
    pass_slots: int
    warmup_passes: int
    params: dict = field(default_factory=dict)


def load_traffic(path) -> Traffic:
    d = json.loads(Path(path).read_text())
    return Traffic(name=Path(path).stem, loop=d["loop"], air=d["air"],
                   mode=d.get("mode", "sniffer"),
                   pass_slots=int(d["pass_slots"]),
                   warmup_passes=int(d["warmup_passes"]),
                   params={k: v for k, v in d.items() if k not in (
                       "loop", "air", "mode", "pass_slots", "warmup_passes",
                       "why")})


class _Recording(captures.PiconetSim):
    """A PiconetSim that records what each packet carries."""

    def packet_bits(self, slot, type_code=3, payload=b"\x01\x02\x03",
                    fhs=False, voice=b""):
        self.sent_log.append((slot, type_code, bytes(payload)))
        return super().packet_bits(slot, type_code, payload, fhs=fhs,
                                   voice=voice)


def _sims(piconets):
    out = []
    for lap, uap, clk0 in piconets:
        s = _Recording(lap=int(lap), uap=int(uap), clk0=int(clk0))
        s.sent_log = []
        out.append(s)
    return out


def _sniffed(make, sims, n_slots, fs, fc, noise, seed):
    """A capture and its truth: (slot, channel, lap, uap, type, payload)
    of every packet, from what each piconet was asked to send."""
    x, sent = make(sims, n_slots, fs, fc, noise_std=noise, seed=seed)
    by_slot = {}
    for s in sims:
        for slot, t, payload in s.sent_log:
            by_slot[slot] = (s.lap, s.uap, t, payload)
    return x, [(rec[0], rec[1], *by_slot[rec[0]]) for rec in sent]


def _multi_piconet(noise_seed):
    """captures.make_multi_piconet_capture with its noise drawn from
    `noise_seed`, the same in every run; the run's seed draws the
    payloads and the start jitter as before.  The receiver's detectors
    now and then take noise for an access code or an LE address, so
    noise drawn from the run's seed changes the hits, and with them the
    work, from seed to seed."""
    def make(sims, n_slots, fs, center_freq, noise_std, seed):
        sps = int(round(fs / 1e6))
        spslot = SYMBOLS_PER_SLOT * sps
        plan, sent = [], []
        rng = np.random.default_rng(seed ^ 0x3A7)
        for slot in range(0, n_slots - 6):
            sim = sims[slot % len(sims)]
            ch = sim.channel_at(slot)
            payload = bytes(rng.integers(0, 256, 9).tolist())
            bits = sim.packet_bits(slot, 3, payload)
            start = slot * spslot + int(rng.integers(0, 5)) * sps
            plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                            bits=bits))
            sent.append((slot, ch, sim.lap))
        return synth.synthesize_capture(plan, n_samples=n_slots * spslot,
                                        fs=fs, center_freq=center_freq,
                                        noise_std=noise_std,
                                        seed=noise_seed), sent
    return make


def _max_rate(cfg, n_slots, seed, noise_seed=None):
    make = captures.make_multi_piconet_capture if noise_seed is None \
        else _multi_piconet(noise_seed)
    return _sniffed(make, _sims(cfg["piconets"]), n_slots,
                    cfg["sample_rate"], cfg["center_freq"], cfg["noise_std"],
                    seed)


def _mixed(cfg, n_slots, seed, noise_seed=None):
    if noise_seed is not None:
        raise ValueError("mixed air draws its noise from the run's seed")
    return _sniffed(captures.make_hostile_capture, _sims(cfg["piconets"]),
                    n_slots, cfg["sample_rate"], cfg["center_freq"],
                    cfg["noise_std"], seed)


def _survey_ids(cfg, n_slots, seed, noise_seed=None):
    """chip_smoke.py's survey air: ID packets of seven LAPs on up to 24
    of the bank's channels; truth (slot, channel, lap, None, None,
    None)."""
    if noise_seed is not None:
        raise ValueError("survey air draws its noise from the run's seed")
    from ..reference.plain import select_channels
    fs, fc = cfg["sample_rate"], cfg["center_freq"]
    bank = SimpleNamespace(channels=select_channels(fs, fc),
                           sps=int(round(fs / 1e6)))
    plan, planted = survey._classic_plan(SimpleNamespace(bank=bank),
                                         n_slots,
                                         np.random.default_rng(seed), set())
    x = synth.synthesize_capture(plan, n_samples=n_slots * 625 * bank.sps,
                                 fs=fs, center_freq=fc,
                                 noise_std=cfg["noise_std"], seed=seed)
    return x, [(slot, ch, lap, None, None, None)
               for lap, ch, slot in planted]


# air kinds: bench.py's sniffer captures (max_rate: a DM1 in every slot,
# the piconets in turn; mixed: every slot busy with 1-, 3- and 5-slot
# DM/DH packets) and chip_smoke.py's survey air
AIR = {"max_rate": _max_rate, "mixed": _mixed, "survey_ids": _survey_ids}


@dataclass
class Pass:
    planes: np.ndarray        # (2, N) float32, the pass as the wire decodes
    chunks: list              # P wire chunks, chunk k = block k of a pass
    carry: np.ndarray         # (2, overlap) float32 planes opening a pass
    truth: list               # (slot, channel, lap, uap, type, payload)
    n_blocks: int


def make_pass(traffic: Traffic, cfg: dict, seed: int, *, step_samples: int,
              overlap_samples: int, samples_per_slot: int,
              block_slots: int) -> Pass:
    """One pass of the traffic's air for the configuration, from the
    seed: its wire chunks, the carry that opens it, the wire-quantized
    planes and the planted packets."""
    if traffic.pass_slots % block_slots or traffic.pass_slots % 64:
        raise ValueError(f"pass of {traffic.pass_slots} slots is not whole "
                         f"blocks of {block_slots} and CLK1-6 periods")
    x, truth = AIR[traffic.air](cfg, traffic.pass_slots, int(seed),
                                traffic.params.get("noise_seed"))
    w_fmt = traffic.params.get("wire", cfg["wire"])
    w = wire.wire_encode(np.stack([x.real, x.imag]).astype(np.float32),
                         w_fmt)
    n = w.shape[0]
    if n != traffic.pass_slots * samples_per_slot or \
            n != (traffic.pass_slots // block_slots) * step_samples:
        raise ValueError("pass length does not match the block geometry")
    P = traffic.pass_slots // block_slots
    cyc = np.concatenate([w, w[:overlap_samples]], axis=0)
    chunks = [np.ascontiguousarray(cyc[overlap_samples + k * step_samples:
                                       overlap_samples + (k + 1) *
                                       step_samples]) for k in range(P)]
    carry = wire.wire_decode_np(w[:overlap_samples], w_fmt)
    return Pass(planes=wire.wire_decode_np(w, w_fmt), chunks=chunks,
                carry=carry, truth=truth, n_blocks=P)


def block_planes(p: Pass, k: int, step_samples: int, overlap_samples: int):
    """Block k of a pass as the device reads it: (2, step + overlap)
    float32 planes, cyclic over the pass."""
    n = p.planes.shape[1]
    idx = (k * step_samples + np.arange(step_samples + overlap_samples)) % n
    return np.ascontiguousarray(p.planes[:, idx])


def expected_payload_bits(type_code: int, payload: bytes, uap: int,
                          llid: int = 2, flow: int = 0) -> np.ndarray:
    """The unwhitened payload bits a receiver recovers from a DM or DH
    packet the capture functions made: payload header, body and CRC, in air
    order."""
    hb = 2 if type_code in _TWO_BYTE_HEADER else 1
    body = np.frombuffer(bytes(payload), np.uint8)
    bits = np.concatenate([packets._payload_header_bits(len(body), llid,
                                                        flow, hb),
                           host_to_air(body, 8).reshape(-1)])
    c = crc.crc16(bits, uap)
    return np.concatenate([bits, host_to_air(int(c), 16)]).astype(np.uint8)
