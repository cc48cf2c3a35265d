"""All-piconet sniffer mode — parity with multi_sniffer
(lib/multi_sniffer_impl.cc): decode everything from every piconet
concurrently, discovering UAPs and clocks as needed, harvesting FHS packets,
and optionally framing decoded packets for Wireshark (pcap/TAP writer).

Flow per detected classic AC (multi_sniffer_impl.cc:169-204):
  header_present?  no  -> ID packet, log LAP
  piconet known (clk6+UAP)? -> decode, print, FHS harvest, writer
  else -> enqueue + UAP_from_header; on success decode the backlog (recall)
  GIAC/LIAC piconets are not retained (inquiry responses).

LE path: detect AAs on 2-MHz-grid channels, parse + track per-AA piconets
(the reference's LE decode paths are stubs; parsing here is complete for
advertising PDUs incl. CONNECT_REQ LLData).

The port of gr_bluetooth_tpu/models/sniffer.py over the port's FrontEnd:
the same flows and EventBus events.  It runs on the CUDA card unless
given another device, which its front end and piconets share.
"""
from __future__ import annotations

import logging

import numpy as np

from ..constants import DEFAULT_SNR_DB, GIAC, LIAC
from ..core import batch_decode
from ..core.packets import ClassicPacket, LePacket
from ..utils.device import resolve_device
from ..utils.log import EventBus, bus as default_bus, get_logger
from .frontend import FrontEnd
from .piconet import BasicRatePiconet, LowEnergyPiconet

__all__ = ["Sniffer"]

log = get_logger("sniffer")


def _apply_batch_row(pkt: ClassicPacket, row: dict) -> bool:
    """Replay a core/batch_decode row onto a ClassicPacket — the same
    effects as pkt.decode() at the (clock, uap) the batch used."""
    if row.get("header_failed"):
        pkt.have_payload = False
        return False
    pkt.packet_type = row["packet_type"]
    pkt.packet_header = row["packet_header"]
    pkt.voice = row.get("voice")
    pkt.payload = row["payload"]
    pkt.payload_length = row["payload_length"]
    pkt.payload_header_length = row["payload_header_length"]
    pkt.payload_llid = row["payload_llid"]
    pkt.payload_flow = row["payload_flow"]
    pkt.have_payload = True
    return row["payload"] is not None


class Sniffer:
    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB,
                 writer=None, bus: EventBus | None = None,
                 enable_le: bool = True, batch_decode: bool = True,
                 device=None, **fe_kwargs):
        self.device = resolve_device(device)
        self.fe = FrontEnd(sample_rate, center_freq, squelch_threshold,
                           max_ac_errors=6, enable_le=enable_le,
                           device=self.device, **fe_kwargs)
        self.writer = writer
        self.bus = bus or default_bus
        self.enable_le = enable_le
        self.batch_decode = batch_decode
        self.basic_rate_piconets: dict[int, BasicRatePiconet] = {}
        self.low_energy_piconets: dict[int, LowEnergyPiconet] = {}
        self._adv_chsel: dict[str, int] = {}      # AdvA -> ChSel bit seen
        self.decoded: list[ClassicPacket] = []
        self.le_packets: list[LePacket] = []

    # ------------------------------------------------------------ classic

    def _precompute_block(self, res):
        """Batch the block's data-parallel host work up front: one
        unpackbits for all hit windows, vectorized header_present, and
        core/batch_decode for hits whose piconet is in steady state
        (clock + UAP known at block start).  _decode validates that the
        state it used still holds before consuming a row (discovery,
        FHS offsets, or clock loss earlier in the same block change it —
        then the per-packet path runs, exactly as without batching)."""
        sym, sizes = self.fe.packet_symbols_matrix(res)
        K = sym.shape[0]
        if K == 0:
            return sym, sizes, np.zeros(0, bool), {}
        s = sym
        msb = s[:, 67].astype(np.int64)
        be = ((s[:, 68] ^ (1 - msb)) + (s[:, 69] ^ msb) +
              (s[:, 70] ^ (1 - msb)) + (s[:, 71] ^ msb))
        t = s[:, 72:126].reshape(K, 18, 3).astype(np.int64)
        a, b, c = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        be = be + (((a ^ b) | (b ^ c)) | (c ^ a)).sum(axis=1)
        from ..core.packets import ID_THRESHOLD
        hp = (sizes >= 126) & (be < ID_THRESHOLD)

        pre = {}
        if self.batch_decode:
            pre = self._batch_rows(res, sym, sizes, hp, range(K))
        return sym, sizes, hp, pre

    def _batch_rows(self, res, sym, sizes, hp, idxs):
        """core/batch_decode rows for the given hit indices whose piconet
        is currently in steady state (clock + UAP known)."""
        rows, clocks, uaps = [], [], []
        for j in idxs:
            if not hp[j]:
                continue
            h = res.hits[j]
            pn = self.basic_rate_piconets.get(h.lap)
            if pn is not None and pn.have_clk6 and pn.have_uap:
                clock = (h.clkn + pn.get_offset()) & \
                    (0x7FFFFFF if pn.have_clk27 else 0x3F)
                rows.append(j)
                clocks.append(clock)
                uaps.append(pn.uap)
        pre = {}
        if rows:
            rows = np.asarray(rows)
            results = batch_decode.decode_known_rows(
                sym[rows], sizes[rows], np.asarray(clocks),
                np.asarray(uaps))
            for i, j in enumerate(rows):
                if results[i] is not None:
                    pre[int(j)] = (results[i], int(clocks[i]),
                                   int(uaps[i]))
        return pre

    def _handle_ac(self, res, hit, sym=None, size=None, hp=None, pre=None):
        symbols = sym[: size] if sym is not None else \
            self.fe.packet_symbols(res, hit)
        pkt = ClassicPacket(symbols=symbols, clkn=hit.clkn,
                            channel=hit.channel, snr=hit.snr_db)
        pkt._lap = hit.lap      # device-computed; skip the host re-derive
        lap = pkt.lap
        self.bus.emit("ac_seen", clkn=hit.clkn, channel=hit.channel,
                      lap=lap, snr_db=hit.snr_db)
        if not (pkt.header_present() if hp is None else bool(hp)):
            self._id(lap)
            return
        pn = self.basic_rate_piconets.get(lap)
        if pn is None:
            pn = self.basic_rate_piconets[lap] = BasicRatePiconet(
                lap=lap, device=self.device)
        if pn.have_clk6 and pn.have_uap:
            self._decode(pkt, pn, first_run=True, pre=pre)
        else:
            self._discover(pkt, pn)
        if lap in (GIAC, LIAC):
            # inquiry responses: keeping state would only cause trouble
            self.basic_rate_piconets.pop(lap, None)

    def _id(self, lap: int):
        self.bus.emit("id_packet", lap=lap)
        log.info("ID packet, LAP %06x", lap)
        if self.writer is not None:
            self.writer.write_id(lap)

    def _decode(self, pkt: ClassicPacket, pn: BasicRatePiconet,
                first_run: bool, pre=None):
        clock = pkt.clkn + pn.get_offset()
        pkt.set_clock(clock, pn.have_clk27)
        pkt.set_uap(pn.uap)
        if pre is not None and pre[1] == pkt.clock and pre[2] == pn.uap:
            ok = _apply_batch_row(pkt, pre[0])
        else:
            ok = pkt.decode()
        if ok:
            self.decoded.append(pkt)
            self.bus.emit("packet_decoded", lap=pkt.lap, uap=pkt.uap,
                          clkn=pkt.clkn, channel=pkt.channel,
                          type=pkt.packet_type, type_name=pkt.type_name(),
                          payload_length=pkt.payload_length)
            if log.isEnabledFor(logging.INFO):
                log.info("time %6d ch %2d LAP %06x %s", pkt.clkn,
                         pkt.channel, pkt.lap,
                         pkt.summary().replace("\n", " | "))
            if self.writer is not None:
                if pn.have_nap:
                    pkt.nap = pn.nap
                    pkt.have_nap = True
                addr = ((pn.nap << 32) if pn.have_nap else 0) | \
                    (pkt.uap << 24) | pkt.lap
                self.writer.write_packet(pkt.tun_format(), addr)
            if pkt.packet_type == 2:
                self._fhs(pkt)
        elif first_run:
            log.info("lost clock on %06x! rediscovering", pkt.lap)
            self.bus.emit("clock_lost", lap=pkt.lap)
            pn.reset()
            self._discover(pkt, pn)
        else:
            log.debug("giving up on queued packet (LAP %06x)", pkt.lap)

    def _discover(self, pkt: ClassicPacket, pn: BasicRatePiconet):
        pn.enqueue(pkt)
        if pn.uap_from_header(pkt):
            self.bus.emit("uap_found", lap=pn.lap, uap=pn.uap,
                          clk_offset=pn.clk_offset)
            self._recall(pn)

    def _recall(self, pn: BasicRatePiconet):
        log.info("decoding %d queued packets for %06x",
                 len(pn.pkt_queue), pn.lap)
        while True:
            pkt = pn.dequeue()
            if pkt is None:
                break
            self._decode(pkt, pn, first_run=False)

    def _fhs(self, pkt: ClassicPacket):
        """Harvest UAP/NAP/clock from an FHS payload — instant piconet
        state restore (multi_sniffer_impl.cc:324-365)."""
        lap = pkt.lap_from_fhs()
        uap = pkt.uap_from_fhs()
        nap = pkt.nap_from_fhs()
        clk = pkt.clock_from_fhs() << 1
        offset = (clk - pkt.clkn) & 0x7FFFFFF
        bd = f"{(nap >> 8) & 0xff:02x}:{nap & 0xff:02x}:{uap:02x}:" \
             f"{(lap >> 16) & 0xff:02x}:{(lap >> 8) & 0xff:02x}:{lap & 0xff:02x}"
        log.info("FHS contents: BD_ADDR %s, CLK %07x", bd, clk)
        pn = self.basic_rate_piconets.get(lap)
        if pn is None:
            pn = self.basic_rate_piconets[lap] = BasicRatePiconet(
                lap=lap, device=self.device)
        pn.set_uap(uap)
        pn.set_nap(nap)
        pn.set_offset(offset)
        self.bus.emit("fhs_harvested", lap=lap, uap=uap, nap=nap,
                      clk=clk, offset=offset)

    # ------------------------------------------------------------ LE

    def _handle_le(self, res):
        for h in res.le_hits:
            pkt = LePacket(symbols=self.fe.le_packet_symbols(res, h),
                           freq=h.freq, clkn=h.clkn, snr=h.snr_db)
            self.le_packets.append(pkt)
            self.bus.emit("le_seen", clkn=pkt.clkn, index=pkt.index,
                          aa=pkt.aa, pdu_type=pkt.pdu_type,
                          length=pkt.length)
            log.info("time %6d, snr=%.1f, %s", pkt.clkn, h.snr_db,
                     pkt.summary().splitlines()[0])
            aa = pkt.aa
            pn = self.low_energy_piconets.get(aa)
            if pn is None:
                pn = self.low_energy_piconets[aa] = LowEnergyPiconet(aa=aa)
            if pkt.index >= 37:
                pn.enqueue(pkt)
                # CONNECT_REQ: seed a follower for the new connection's AA
                # (the reference only prints the LLData,
                # lib/packet_impl.cc:1619-1665)
                # advertiser ChSel tracking: CSA#2 requires BOTH the
                # advertiser's PDU and the CONNECT_IND to set ChSel=1
                # (BT 5.0 Vol 6 Part B §4.5.8) — a BT5 initiator
                # connecting to a legacy advertiser stays on CSA#1
                adv_a = pkt.adv_addr()
                if adv_a is not None and pkt.crc_ok():
                    self._adv_chsel[adv_a] = pkt.ch_sel
                fields = pkt.connect_req_fields()
                if fields is not None and pkt.crc_ok():
                    adv_cs = self._adv_chsel.get(fields["adv_a"])
                    if adv_cs is not None:
                        fields = dict(fields,
                                      ch_sel=fields["ch_sel"] & adv_cs)
                    conn = self.low_energy_piconets.get(fields["aa"])
                    if conn is None:
                        conn = LowEnergyPiconet(aa=fields["aa"])
                        self.low_energy_piconets[fields["aa"]] = conn
                    conn.from_connect_req(fields, pkt.clkn)
                    self.bus.emit("le_connection", aa=conn.aa,
                                  crc_init=conn.crc_init,
                                  hop=conn.hop_increment,
                                  interval=conn.interval,
                                  ch_map=conn.ch_map)
                    # re-validate data packets sniffed before this
                    # CONNECT_REQ against the now-known CRCInit (LE analog
                    # of the classic recall, multi_sniffer_impl.cc:287-318)
                    for rp, ok in conn.recall():
                        self.bus.emit("le_recalled", aa=conn.aa,
                                      clkn=rp.clkn, index=rp.index,
                                      crc_ok=ok)
            else:
                ok = pn.observe_data(pkt)
                self.bus.emit("le_data", aa=aa, index=pkt.index,
                              crc_ok=ok, llid=pkt.llid, length=pkt.length)

    # ------------------------------------------------------------ run

    def run(self, samples, start_clkn: int = 0):
        return self.run_blocks(self.fe.stream(samples, start_clkn))

    def run_blocks(self, results):
        for res in results:
            sym, sizes, hp, pre = self._precompute_block(res)
            # LAPs already in steady state when the block's rows were
            # precomputed; a piconet turning steady MID-block (discovery
            # win, FHS harvest) gets its remaining hits batch-precomputed
            # on the spot — without this, every hit of a newly discovered
            # piconet in its first block decodes per-packet (the dominant
            # discovery-mode cost, round-5 profile)
            steady = {lap for lap, pn in self.basic_rate_piconets.items()
                      if pn.have_clk6 and pn.have_uap}
            for j, h in enumerate(res.hits):
                self._handle_ac(res, h, sym=sym[j], size=int(sizes[j]),
                                hp=hp[j], pre=pre.get(j))
                if self.batch_decode and h.lap not in steady:
                    pn = self.basic_rate_piconets.get(h.lap)
                    if pn is not None and pn.have_clk6 and pn.have_uap:
                        steady.add(h.lap)
                        rest = [k for k in range(j + 1, len(res.hits))
                                if res.hits[k].lap == h.lap]
                        if rest:
                            pre.update(self._batch_rows(res, sym, sizes,
                                                        hp, rest))
            if self.enable_le:
                self._handle_le(res)
            self.cursor = res.slot_base + res.n_slots
        return self.decoded

    # ------------------------------------------------------- checkpoint

    cursor: int = 0

    def save_state(self, path: str):
        """Checkpoint piconet registries + stream cursor (SURVEY §5: the
        reference has no checkpointing; FHS is its only 'restore')."""
        from ..io import checkpoint
        checkpoint.save_state(path, cursor=self.cursor,
                              basic_rate=self.basic_rate_piconets,
                              low_energy=self.low_energy_piconets)

    def restore_state(self, path: str) -> int:
        """Load a checkpoint; returns the clkn cursor to resume from."""
        from ..io import checkpoint
        self.cursor = checkpoint.attach(self, path)
        return self.cursor
