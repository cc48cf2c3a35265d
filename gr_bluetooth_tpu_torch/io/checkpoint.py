"""Checkpoint / resume: serialize piconet state + stream cursor.

The reference keeps all piconet state (UAP/NAP/clock offsets, candidate
sets, recorded hop patterns, queued packets) in memory only — stopping the
receiver loses everything except what an FHS packet can instantly restore
(multi_sniffer_impl.cc:324-365).  SURVEY §5 calls for the TPU build to add
real checkpointing: this module snapshots a mode's full protocol state into
one .npz file (arrays stored natively, scalars in a JSON header; no pickle)
so a capture can be processed across process restarts or machine moves and
long-running surveys survive preemption.

The port of gr_bluetooth_tpu/io/checkpoint.py, with the same file format
(meta JSON and array names): a checkpoint either package writes restores
into the other.  Restored piconets take the restoring mode's device.

Layout: meta (JSON: version, cursor, scalar fields per piconet) +
per-piconet arrays under "br/<lap>/<name>" and queued-packet symbol blocks
under "br/<lap>/q<i>" (resp. "le/<aa>/...").
"""
from __future__ import annotations

import json

import numpy as np

from ..core.packets import ClassicPacket, LePacket
from ..models.piconet import BasicRatePiconet, LowEnergyPiconet

__all__ = ["save_state", "load_state", "attach"]

_VERSION = 1

_BR_SCALARS = ("lap", "uap", "nap", "clk_offset", "have_uap", "have_nap",
               "have_clk6", "have_clk27", "afh", "looks_like_afh", "aliased",
               "hop_reversal_inited", "got_first_packet", "first_pkt_time",
               "packets_observed", "total_packets_observed", "winnowed")

_LE_SCALARS = ("aa", "packets_seen", "crc_ok_count", "crc_bad_count",
               "is_connection", "crc_init", "ch_map", "hop_increment",
               "interval", "latency", "timeout", "win_size", "win_offset",
               "anchor_clkn")


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def save_state(path: str, *, cursor: int = 0,
               basic_rate: dict | None = None,
               low_energy: dict | None = None) -> None:
    """Write a checkpoint of {lap: BasicRatePiconet} / {aa: LowEnergyPiconet}
    registries plus the stream cursor (clkn of the next slot to process)."""
    arrays: dict[str, np.ndarray] = {}
    meta = {"version": _VERSION, "cursor": int(cursor), "br": {}, "le": {}}

    for lap, pn in (basic_rate or {}).items():
        key = f"{lap:06x}"
        meta["br"][key] = {n: _jsonable(getattr(pn, n)) for n in _BR_SCALARS}
        arrays[f"br/{key}/clock6"] = pn.clock6_candidates
        arrays[f"br/{key}/pattern_idx"] = np.asarray(pn.pattern_indices,
                                                     dtype=np.int64)
        arrays[f"br/{key}/pattern_ch"] = np.asarray(pn.pattern_channels,
                                                    dtype=np.int64)
        # materializes the device-resident candidate mask if winnowing was
        # mid-flight on device (ops/hop_ops.py)
        cands = pn.get_clock27_candidates()
        if cands is not None:
            arrays[f"br/{key}/clock27"] = cands
        qmeta = []
        for i, pkt in enumerate(pn.pkt_queue):
            arrays[f"br/{key}/q{i}"] = np.asarray(pkt.symbols, dtype=np.uint8)
            qmeta.append({"clkn": int(pkt.clkn), "channel": int(pkt.channel),
                          "snr": float(pkt.snr)})
        meta["br"][key]["queue"] = qmeta

    for aa, pn in (low_energy or {}).items():
        key = f"{aa:08x}"
        meta["le"][key] = {n: _jsonable(getattr(pn, n)) for n in _LE_SCALARS}
        qmeta = []
        for i, pkt in enumerate(pn.pkt_queue):
            arrays[f"le/{key}/q{i}"] = np.asarray(pkt.symbols, dtype=np.uint8)
            qmeta.append({"clkn": int(pkt.clkn), "freq": float(pkt.freq),
                          "snr": float(pkt.snr)})
        meta["le"][key]["queue"] = qmeta

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device=None):
    """Returns (cursor, {lap: BasicRatePiconet}, {aa: LowEnergyPiconet});
    the classic piconets winnow on `device` (None: the CUDA card)."""
    from ..core import hop

    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta["version"] != _VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {_VERSION}")

    basic_rate = {}
    for key, m in meta["br"].items():
        queue_meta = m.pop("queue")
        pn = BasicRatePiconet(lap=m["lap"], device=device)
        for n in _BR_SCALARS:
            setattr(pn, n, m[n])
        pn.clock6_candidates = z[f"br/{key}/clock6"]
        pn.pattern_indices = list(z[f"br/{key}/pattern_idx"])
        pn.pattern_channels = list(z[f"br/{key}/pattern_ch"])
        if f"br/{key}/clock27" in z:
            pn.clock27_candidates = z[f"br/{key}/clock27"]
        if pn.hop_reversal_inited:
            # address constants are a pure function of UAP|LAP — recompute
            # rather than store (lib/piconet_impl.cc:150-168)
            pn._addr_consts = hop.address_precalc(
                ((pn.uap << 24) | pn.lap) & 0xFFFFFFF)
        for i, qm in enumerate(queue_meta):
            pn.pkt_queue.append(ClassicPacket(
                symbols=z[f"br/{key}/q{i}"], clkn=qm["clkn"],
                channel=qm["channel"], snr=qm["snr"]))
        basic_rate[pn.lap] = pn

    low_energy = {}
    for key, m in meta["le"].items():
        queue_meta = m.pop("queue")
        pn = LowEnergyPiconet(aa=m["aa"])
        for n in _LE_SCALARS:
            setattr(pn, n, m[n])
        for i, qm in enumerate(queue_meta):
            pn.pkt_queue.append(LePacket(
                symbols=z[f"le/{key}/q{i}"], freq=qm["freq"],
                clkn=qm["clkn"], snr=qm["snr"]))
        low_energy[pn.aa] = pn

    return meta["cursor"], basic_rate, low_energy


def attach(mode, path: str) -> int:
    """Restore a checkpoint into a Sniffer-like mode object; returns the
    stream cursor to resume from (pass as start_clkn).  The piconets take
    the mode's device."""
    cursor, br, le = load_state(path, getattr(mode, "device", None))
    if hasattr(mode, "basic_rate_piconets"):
        mode.basic_rate_piconets.update(br)
    if hasattr(mode, "low_energy_piconets"):
        mode.low_energy_piconets.update(le)
    if hasattr(mode, "piconet") and br:
        lap = getattr(mode, "lap", None)
        if lap in br:
            mode.piconet = br[lap]
    return cursor
