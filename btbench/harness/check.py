"""Whether what the window produced is correct: every block's front-end
outputs against the plain reference, and every packet the sniffer
decoded against the packet that was planted.

During the window the collector keeps, for each block position of the
replayed pass, every distinct output seen there with its count (a
replayed pass reads the same air, so a sound program gives one per
position).  After the window each is compared with the reference's
output for its position, and the numbers are weighed by their counts,
so every block of the window is judged.
"""
from __future__ import annotations

import numpy as np

from ..traffic.generator import expected_payload_bits

__all__ = ["Collector", "compare", "verdict"]


class Collector:
    """The window's outputs, by block position k = j % P."""

    def __init__(self, n_blocks: int, block_slots: int, mode=None):
        self.P = n_blocks
        self.B = block_slots
        self.mode = mode
        self.kind = "survey" if hasattr(mode, "observations") else "sniffer"
        self.fe_out = [dict() for _ in range(n_blocks)]
        self.decoded = [dict() for _ in range(n_blocks)]

    def on_result(self, j, res):
        classic = tuple((h.chan_idx, h.sym_offset, h.clkn - res.slot_base,
                         h.lap, h.errors) for h in res.hits)
        le = tuple((h.channel, h.sym_offset, h.clkn - res.slot_base,
                    h.distance) for h in res.le_hits)
        snr = np.asarray(res.snr_db, np.float32)
        key = (snr.tobytes(), classic, le)
        d = self.fe_out[j % self.P]
        if key in d:
            d[key][0] += 1
        else:
            d[key] = [1, snr, classic, le]

    def on_done(self, j, res):
        """What the mode made of block j, taken out of its output list
        (a sink would take it from there): the sniffer's decoded packets
        (slot in the block, channel, LAP, UAP, type, payload bits), the
        survey's LAP observations (slot, channel, LAP, errors)."""
        m = self.mode
        if m is None:
            return
        if self.kind == "survey":
            recs = tuple(sorted(
                (o.clkn - res.slot_base, o.channel, o.lap, o.errors)
                for o in m.observations))
            m.observations.clear()
        else:
            recs = tuple(sorted(
                (p.clkn - res.slot_base, p.channel, p.lap, p.uap,
                 p.packet_type, np.asarray(p.payload, np.uint8).tobytes())
                for p in m.decoded))
            m.decoded.clear()
            m.le_packets.clear()
        d = self.decoded[j % self.P]
        d[recs] = d.get(recs, 0) + 1


def _hit_diff(a, b) -> int:
    """Rows of a not in b plus rows of b not in a (multisets)."""
    from collections import Counter
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def _due_packets(truth, k, col, classic_r, chans):
    """The planted packets a sniffer may report in block k (slot in the
    block, channel, LAP, UAP, type, payload bits), and those it must:
    the ones whose access code the reference reports there."""
    # a packet starting in the block's first slot may be reported by the
    # block before (its access code is seen past the group delay):
    # candidates run from slot -1 to slot B, over the pass
    lo = k * col.B
    span = col.P * col.B
    planted = []
    for s, ch, lap, uap, t, pl in truth:
        rel = (s - lo + 1) % span - 1
        if rel <= col.B:
            planted.append((rel, ch, lap, uap, t,
                            expected_payload_bits(t, pl, uap).tobytes()))
    seen = {(chans[c], lap, s) for c, _, s, lap, _ in classic_r}
    return planted, [p for p in planted if (p[1], p[2], p[0]) in seen]


def compare(col: Collector, ref_blocks, ref_fe, truth) -> dict:
    """The numbers compared, bad_blocks (the window's blocks with a
    wrong hit, packet or observation) and notes on the first faults
    found.  ref_blocks[k] = (snr, classic rows, LE rows) from the
    reference for position k; truth = the planted packets (slot,
    channel, lap, uap, type, payload)."""
    le_channel = {r: ch for r, (_, ch, _) in enumerate(ref_fe.le_rows)}
    chans = ref_fe.bank.channels
    hit_mis, gap, mode_mis, bad = 0, 0.0, 0, 0
    notes = []
    for k in range(col.P):
        snr_r, classic_r, le_r = ref_blocks[k]
        le_r = [(le_channel[r], t, s, d) for r, t, s, d in le_r]
        for count, snr, classic, le in col.fe_out[k].values():
            diff = _hit_diff(classic, classic_r) + _hit_diff(le, le_r)
            hit_mis += count * diff
            bad += count * (diff > 0)
            if diff and len(notes) < 10:
                notes.append(f"block {k} x{count}: hits "
                             f"{sorted(set(classic) ^ set(classic_r))[:4]} "
                             f"LE {sorted(set(le) ^ set(le_r))[:4]}")
            if snr.shape != snr_r.shape:
                gap = float("inf")
            else:
                gap = max(gap, float(np.abs(snr.astype(np.float64) -
                                            snr_r).max()))
        if col.kind == "survey":
            # the survey reports every hit the reference finds
            planted = due = sorted((s, chans[c], lap, e)
                                   for c, _, s, lap, e in classic_r)
        else:
            planted, due = _due_packets(truth, k, col, classic_r, chans)
        for recs, count in col.decoded[k].items():
            left = list(planted)
            wrong = 0
            for r in recs:
                if r in left:
                    left.remove(r)
                else:
                    wrong += 1
            missing = [p for p in due if p in left]
            mode_mis += count * (wrong + len(missing))
            bad += count * (wrong + len(missing) > 0)
            if (wrong or missing) and len(notes) < 10:
                notes.append(
                    f"block {k} x{count}: {len(recs)} decoded, {wrong} not "
                    f"sent {[r[:5] for r in recs if r not in planted][:3]}, "
                    f"missing {[m[:5] for m in missing][:3]}")
    return dict(hit_mismatch=hit_mis, snr_gap_db=gap,
                mode_mismatch=mode_mis, bad_blocks=bad, notes=notes)


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the limits' names."""
    rows = [(n, numbers[n], limits[n]) for n in limits]
    return all(v <= lim for _, v, lim in rows), rows
