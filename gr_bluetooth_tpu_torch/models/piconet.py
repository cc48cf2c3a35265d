"""Piconet state engines: passive UAP/clock recovery and hop following.

The port of gr_bluetooth_tpu/models/piconet.py: the same state machines,
with the CLK1-27 winnow scans on the port's DeviceWinnower
(ops/hop_ops.py) on the piconet's device.

Re-design of lib/piconet_impl.cc.  Two structural inversions vs the reference:

  * CLK1-6/UAP attack: the reference loops over 64 candidate clocks calling
    try_clock per candidate (piconet_impl.cc:457-496).  Here the header
    trial-unwhitening and HEC reversal for all 64 candidates is one
    vectorized batch (packets.try_clocks); only surviving candidates run the
    payload crc_check.
  * CLK1-27 reversal: no 134 MB sequence table — candidates are winnowed
    against the closed-form hop kernel evaluated lazily (core/hop.py).

Algorithm-level recovery semantics preserved (SURVEY §5): candidate-
exhaustion reset + AFH retry, pattern-overflow reset, FHS-restore.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import MAX_PATTERN_LENGTH, SEQUENCE_LENGTH
from ..core import hop, le_ll
from ..core import packets as packets_mod
from ..core.packets import ClassicPacket
from ..ops import hop_ops
from ..utils.device import resolve_device
from ..utils.log import get_logger

__all__ = ["BasicRatePiconet", "LowEnergyPiconet"]

log = get_logger("piconet")


@dataclass
class BasicRatePiconet:
    lap: int

    uap: int = 0
    nap: int = 0
    clk_offset: int = 0
    have_uap: bool = False
    have_nap: bool = False
    have_clk6: bool = False
    have_clk27: bool = False

    afh: bool = False
    looks_like_afh: bool = False
    aliased: bool = False
    hop_reversal_inited: bool = False

    got_first_packet: bool = False
    first_pkt_time: int = 0
    packets_observed: int = 0
    total_packets_observed: int = 0
    winnowed: int = 0

    pattern_indices: list = field(default_factory=list)
    pattern_channels: list = field(default_factory=list)

    # CLK1-6 candidates: candidate UAP per first-packet clock, -1 = eliminated
    clock6_candidates: np.ndarray = field(
        default_factory=lambda: np.full(64, -1, dtype=np.int64))

    clock27_candidates: np.ndarray | None = None
    _addr_consts: hop.AddressConsts | None = None
    _winnower: object | None = field(default=None, repr=False)

    pkt_queue: list = field(default_factory=list)

    # where the CLK1-27 winnow runs: None means the CUDA card (and raises
    # when there is none), "cpu" the plain torch ops on the host
    device: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------ queue

    def enqueue(self, pkt):
        self.pkt_queue.append(pkt)

    def dequeue(self):
        return self.pkt_queue.pop(0) if self.pkt_queue else None

    # ------------------------------------------------------------ CLK1-6/UAP

    def uap_from_header(self, pkt: ClassicPacket) -> bool:
        """Ossmann's candidate-elimination attack, vectorized.

        Mirrors basic_rate_piconet_impl::UAP_from_header
        (lib/piconet_impl.cc:433-517); returns True once UAP+CLK1-6 known.
        """
        clkn = pkt.clkn
        # Pin the pattern time base to the first *recorded* packet.  The
        # reference keys this on d_got_first_packet (piconet_impl.cc:442-443),
        # which stays false after a CRC-certain early-return win — so its
        # base drifts to every new packet and the recorded hop pattern
        # becomes self-inconsistent (latent bug, only visible with
        # CRC-certain traffic).  Keying on the pattern itself keeps the
        # winnow replay consistent; reset() clears it as before.
        if not self.pattern_indices:
            self.first_pkt_time = clkn

        if self.packets_observed < MAX_PATTERN_LENGTH:
            self.pattern_indices.append(clkn - self.first_pkt_time)
            self.pattern_channels.append(pkt.channel)
        else:
            log.warning("pattern overflow; resetting piconet %06x", self.lap)
            self.reset()
            return False
        self.packets_observed += 1
        self.total_packets_observed += 1

        counts = np.arange(64)
        alive = (self.clock6_candidates > -1) | (not self.got_first_packet)
        clocks = (counts + clkn - self.first_pkt_time) % 64
        uaps, types, fec_ok = pkt.try_clocks(clocks)

        starting = int(alive.sum())
        remaining = 0
        first_clock = 0
        new_cands = self.clock6_candidates.copy()
        # survivors after the cheap (header) eliminations; their payload
        # scoring runs as ONE batched pass instead of per-candidate python
        # (the dominant discovery-mode host cost — up to 64 payload
        # decodes per packet, lib/piconet_impl.cc:457-496)
        live = []
        for count in np.nonzero(alive)[0]:
            if not fec_ok:
                new_cands[count] = -1
                continue
            if self.got_first_packet and \
                    int(uaps[count]) != self.clock6_candidates[count]:
                new_cands[count] = -1
                continue
            live.append(int(count))
        retvals = {}
        if live and fec_ok:
            scores = packets_mod.crc_check_clocks(
                pkt, [int(clocks[c]) for c in live],
                [int(uaps[c]) for c in live],
                [int(types[c]) for c in live])
            retvals = dict(zip(live, scores))
        for count in live:
            clock = int(clocks[count])
            uap = int(uaps[count])
            pkt.uap = uap
            pkt.packet_type = int(types[count])
            retval = retvals[count]
            if retval == 0:
                new_cands[count] = -1
            elif retval == 1:
                new_cands[count] = uap
                first_clock = int(count)
                remaining += 1
            else:  # CRC-verified
                log.info("Correct CRC! UAP=0x%02x after %d packets",
                         uap, self.total_packets_observed)
                self.clk_offset = (int(count) - (self.first_pkt_time & 0x3F)) & 0x3F
                self.uap = uap
                self.have_clk6 = self.have_uap = True
                self.total_packets_observed = 0
                self.clock6_candidates = new_cands
                # NOTE: got_first_packet deliberately NOT set — the reference's
                # early return skips it (piconet_impl.cc:487-494), so a
                # CRC-certain piconet re-runs a full fresh candidate pass on
                # every later packet and keeps re-winning consistently.
                return True

        self.clock6_candidates = new_cands
        self.got_first_packet = True
        log.debug("reduced from %d to %d CLK1-6 candidates", starting, remaining)

        if remaining == 1:
            self.clk_offset = (first_clock - (self.first_pkt_time & 0x3F)) & 0x3F
            self.uap = int(self.clock6_candidates[first_clock])
            self.have_clk6 = self.have_uap = True
            log.info("We have a winner! UAP=0x%02x after %d packets",
                     self.uap, self.total_packets_observed)
            self.total_packets_observed = 0
            return True
        if remaining == 0:
            self.reset()
        return False

    # ------------------------------------------------------------ CLK1-27

    # below this count the numpy tail is cheaper than a device dispatch;
    # above it the init/winnow scans run on device (ops/hop_ops.py)
    DEVICE_WINNOW_THRESHOLD = 8192

    def init_hop_reversal(self, aliased: bool = False) -> int:
        """Start CLK1-27 recovery (lib/piconet_impl.cc:96-129) — lazily:
        candidates are clock values; channels are computed on demand.

        The 2^21-clock init scan (and winnows while the candidate set is
        large) runs on the piconet's device as a masked reduction
        (ops/hop_ops.py); once the set drops under
        DEVICE_WINNOW_THRESHOLD it materializes to host numpy
        (core/hop.py).  A winnower that fails raises."""
        self._addr_consts = hop.address_precalc(
            ((self.uap << 24) | self.lap) & 0xFFFFFFF)
        clock6 = (self.clk_offset + self.first_pkt_time) & 0x3F
        self.aliased = aliased
        self._winnower = hop_ops.DeviceWinnower(
            ((self.uap << 24) | self.lap) & 0xFFFFFFF, clock6,
            int(self.pattern_channels[0]), aliased=aliased, afh=self.afh,
            device=self.device)
        n = self._winnower.count
        self._maybe_materialize()
        self.winnowed = 0
        self.hop_reversal_inited = True
        self.have_clk27 = False
        log.info("%d initial CLK1-27 candidates", n)
        return n

    def _maybe_materialize(self):
        """Pull the device candidate set to host once it is small."""
        if (self._winnower is not None
                and self._winnower.count <= self.DEVICE_WINNOW_THRESHOLD):
            self.clock27_candidates = self._winnower.candidates()
            self._winnower = None

    def get_clock27_candidates(self) -> np.ndarray | None:
        """Candidate clocks as a host array (materializes the device mask
        if needed — used by checkpointing)."""
        if self._winnower is not None:
            return self._winnower.candidates()
        return self.clock27_candidates

    def winnow(self) -> int:
        """Replay recorded (offset, channel) pattern against candidates;
        flags AFH on consecutive same-channel slots (piconet_impl.cc:341-368)."""
        if self._winnower is not None:
            n = self._winnower.count
        else:
            n = len(self.clock27_candidates) if self.clock27_candidates is not None else 0
        while self.winnowed < self.packets_observed:
            i = self.winnowed
            index = int(self.pattern_indices[i])
            channel = int(self.pattern_channels[i])
            if self._winnower is not None:
                n = self._winnower.winnow(index, channel)
                self._maybe_materialize()
            else:
                self.clock27_candidates = hop.winnow(
                    self.clock27_candidates, index, channel, self._addr_consts,
                    aliased=self.aliased, afh=self.afh)
                n = len(self.clock27_candidates)
            if i > 0:
                last_index = int(self.pattern_indices[i - 1])
                last_channel = int(self.pattern_channels[i - 1])
                if (not self.looks_like_afh and index == last_index + 1
                        and channel == last_channel):
                    self.looks_like_afh = True
            self.winnowed += 1
            if n == 1:
                self.clk_offset = int(
                    (self.clock27_candidates[0] - self.first_pkt_time)
                    & (SEQUENCE_LENGTH - 1))
                self.have_clk27 = True
                log.info("Acquired CLK1-27 offset = 0x%07x", self.clk_offset)
            elif n == 0:
                self.reset()
                break
            else:
                log.debug("%d CLK1-27 candidates remaining", n)
        return n

    def hop(self, clock: int) -> int:
        """Channel for a CLK1-27 slot clock (lazy; no sequence table)."""
        return int(hop.hop(clock, self._addr_consts, afh=self.afh))

    def aliased_channel(self, channel: int) -> int:
        return int(hop.aliased_channel(channel))

    # ------------------------------------------------------------ state

    def set_uap(self, uap: int):
        self.uap = uap
        self.have_uap = True

    def set_nap(self, nap: int):
        self.nap = nap
        self.have_nap = True

    def set_offset(self, offset: int):
        """FHS-derived instant restore (multi_sniffer_impl.cc:324-365)."""
        self.clk_offset = offset
        self.have_clk6 = True
        self.have_clk27 = True

    def get_offset(self) -> int:
        return self.clk_offset

    def reset(self):
        """Candidate exhaustion: start over, retry with AFH if suspected
        (lib/piconet_impl.cc:526-547)."""
        log.info("no candidates remaining for %06x! starting over", self.lap)
        self.got_first_packet = False
        self.packets_observed = 0
        self.winnowed = 0
        self.pattern_indices.clear()
        self.pattern_channels.clear()
        self.hop_reversal_inited = False
        self.have_uap = False
        self.have_clk6 = False
        self.have_clk27 = False
        self.clock6_candidates = np.full(64, -1, dtype=np.int64)
        self.clock27_candidates = None
        self._winnower = None
        self.afh = self.looks_like_afh
        self.looks_like_afh = False


@dataclass
class LowEnergyPiconet:
    """LE piconet / connection tracking.

    The reference's low_energy_piconet is an empty stub
    (lib/piconet_impl.cc:551-585); this is a real implementation: when a
    CONNECT_REQ is sniffed its LLData (the fields the reference only
    prints, lib/packet_impl.cc:1619-1665) seeds full connection-following
    state — CSA#1 or (BT5, ChSel header bit) CSA#2 hop sequence, CRCInit
    for data-packet validation, and connection-event timing from the
    transmit-window parameters.
    """
    aa: int
    packets_seen: int = 0
    crc_ok_count: int = 0
    crc_bad_count: int = 0
    pkt_queue: list = field(default_factory=list)

    # connection parameters (from CONNECT_REQ LLData)
    is_connection: bool = False
    crc_init: int | None = None
    ch_map: int = 0
    hop_increment: int = 0
    interval: int = 0                 # units of 1.25 ms = 2 slots
    latency: int = 0
    timeout: int = 0
    win_size: int = 0
    win_offset: int = 0
    ch_sel: int = 0                   # 0 -> CSA#1, 1 -> CSA#2 (BT 5.0)
    anchor_clkn: int | None = None    # estimated clkn of connection event 0

    def enqueue(self, pkt):
        self.pkt_queue.append(pkt)
        self.packets_seen += 1

    # ------------------------------------------------------- connection

    def from_connect_req(self, fields: dict, clkn: int) -> None:
        """Seed connection state from a sniffed CONNECT_REQ at slot clkn.

        Event 0's anchor lies inside the transmit window, which opens
        1.25 ms + WinOffset*1.25 ms after the CONNECT_REQ end
        (spec v4.2 Vol 6 Part B §4.5.3); clkn ticks are 625 us = half
        that unit.
        """
        self.is_connection = True
        self.crc_init = fields["crc_init"]
        self.ch_map = fields["ch_map"]
        self.hop_increment = fields["hop"]
        self.interval = fields["interval"]
        self.latency = fields["latency"]
        self.timeout = fields["timeout"]
        self.win_size = fields["win_size"]
        self.win_offset = fields["win_offset"]
        self.ch_sel = fields.get("ch_sel", 0)
        self.anchor_clkn = clkn + 2 * (1 + self.win_offset)
        log.info("LE connection AA=%08x: hop=%d interval=%d chm=%010x "
                 "csa=#%d", self.aa, self.hop_increment, self.interval,
                 self.ch_map, 2 if self.ch_sel else 1)

    def channel_for_event(self, event: int) -> int:
        """Data channel index for connection event N.

        CSA#1 (§4.5.8.2) by default; CSA#2 (BT 5.0 §4.5.8.3, selected by
        the ChSel bit on the CONNECT_IND) via the AA-seeded per-event PRN
        in core/le_ll.py.  The reference has neither (empty stub,
        lib/piconet_impl.cc:551-585)."""
        if self.ch_sel:
            return int(le_ll.csa2_channel(event, self.aa, self.ch_map))
        unmapped = ((event + 1) * self.hop_increment) % 37
        return int(le_ll.csa1_channel(np.int64(unmapped), self.ch_map))

    def event_for_clkn(self, clkn: int) -> int:
        """Connection event counter active at slot clock clkn."""
        if self.anchor_clkn is None or self.interval <= 0:
            return 0
        return max(0, (clkn - self.anchor_clkn) // (2 * self.interval))

    def predict_channel(self, clkn: int) -> int:
        return self.channel_for_event(self.event_for_clkn(clkn))

    def observe_data(self, pkt) -> bool:
        """Track a data-channel packet; returns CRC validity.

        Before the connection is seeded the validity is provisional (no
        CRCInit is known yet) — recall() re-validates the backlog once a
        CONNECT_REQ supplies it."""
        self.enqueue(pkt)
        ok = bool(pkt.crc_ok(self.crc_init)) if self.is_connection else \
            bool(pkt.crc_ok())
        if ok:
            self.crc_ok_count += 1
        else:
            self.crc_bad_count += 1
        return ok

    def recall(self) -> list:
        """Re-validate buffered data packets against the now-known CRCInit.

        The LE analog of the classic enqueue -> recall structure
        (multi_sniffer_impl.cc:287-318; the reference's LE decode path is a
        stub): data packets sniffed *before* their CONNECT_REQ were only
        provisionally validated.  Rebuilds the CRC counters from the full
        backlog and returns [(pkt, crc_ok)] for event emission."""
        if not self.is_connection:
            return []
        recalled = []
        self.crc_ok_count = 0
        self.crc_bad_count = 0
        for pkt in self.pkt_queue:
            if pkt.index >= 37:
                continue
            ok = bool(pkt.crc_ok(self.crc_init))
            if ok:
                self.crc_ok_count += 1
            else:
                self.crc_bad_count += 1
            recalled.append((pkt, ok))
        return recalled
