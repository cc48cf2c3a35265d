"""Hopper mode — parity with multi_hopper (lib/multi_hopper_impl.cc):
recover a target piconet's full CLK1-27 by hop-sequence reversal, then follow
the hopping sequence live and decode only the predicted channel.

Phase 1 (multi_hopper_impl.cc:88-139): scan for the target LAP, run the
CLK1-6/UAP attack; once CLK1-6 is known, init hop reversal and winnow the
recorded (time offset, channel) pattern after every new packet.

Phase 2 — hopalong (multi_hopper_impl.cc:152-209): clock27 = clkn + offset;
predicted channel = hop(clock27) (through the aliased map if requested);
decode packets with LAP match on that channel only.

The front end demodulates the full band either way (that's the batched
design — and it is the benchmark metric); "hopping" is a per-slot channel
filter on the already-computed candidates.

The port of gr_bluetooth_tpu/models/hopper.py over the port's FrontEnd;
it runs on the CUDA card unless given another device, and its piconet's
CLK1-27 winnow runs there too.
"""
from __future__ import annotations

from ..constants import DEFAULT_SNR_DB
from ..core.packets import ClassicPacket
from ..utils.device import resolve_device
from ..utils.log import EventBus, bus as default_bus, get_logger
from .frontend import FrontEnd
from .piconet import BasicRatePiconet

__all__ = ["Hopper"]

log = get_logger("hopper")


class Hopper:
    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB, lap: int = 0,
                 aliased: bool = False, writer=None,
                 bus: EventBus | None = None, device=None, **fe_kwargs):
        self.device = resolve_device(device)
        self.fe = FrontEnd(sample_rate, center_freq, squelch_threshold,
                           max_ac_errors=6, device=self.device, **fe_kwargs)
        self.lap = lap
        self.aliased = aliased
        self.writer = writer
        self.bus = bus or default_bus
        self.piconet = BasicRatePiconet(lap=lap, device=self.device)
        self.decoded: list[ClassicPacket] = []
        self.followed_slots = 0

    # ------------------------------------------------------------ phase 1

    def _acquire(self, res, hit) -> None:
        pkt = ClassicPacket(symbols=self.fe.packet_symbols(res, hit),
                            clkn=hit.clkn, channel=hit.channel,
                            snr=hit.snr_db)
        if pkt.lap != self.lap or not pkt.header_present():
            return
        pn = self.piconet
        had_clk6 = pn.have_clk6
        pn.uap_from_header(pkt)
        if not pn.have_clk6:
            return
        if not had_clk6:
            n0 = pn.init_hop_reversal(self.aliased)
            self.bus.emit("hop_reversal_started", lap=self.lap,
                          candidates=n0)
        pn.winnow()
        if pn.have_clk27:
            self.bus.emit("clock_acquired", lap=self.lap,
                          clk_offset=pn.clk_offset)
            log.info("Acquired CLK1-27 offset=0x%07x for LAP %06x",
                     pn.clk_offset, self.lap)

    # ------------------------------------------------------------ phase 2

    def _hopalong(self, res) -> None:
        pn = self.piconet
        for h in res.hits:
            if h.lap != self.lap:
                continue
            clock27 = (h.clkn + pn.get_offset()) & 0x7FFFFFF
            predicted = pn.hop(clock27)
            observed = pn.aliased_channel(predicted) if self.aliased \
                else predicted
            if h.channel != observed:
                continue                      # not the piconet's slot/channel
            self.followed_slots += 1
            pkt = ClassicPacket(symbols=self.fe.packet_symbols(res, h),
                                clkn=h.clkn, channel=h.channel, snr=h.snr_db)
            if not pkt.header_present():
                self.bus.emit("hop_id", clock27=clock27, channel=h.channel)
                if self.writer is not None:
                    self.writer.write_id((pn.uap << 24) | self.lap)
                continue
            pkt.set_uap(pn.uap)
            pkt.set_clock(clock27, True)
            if pkt.decode():
                self.decoded.append(pkt)
                self.bus.emit("hop_decoded", clock27=clock27,
                              channel=h.channel, type=pkt.packet_type,
                              type_name=pkt.type_name(),
                              payload_length=pkt.payload_length)
                log.info("clock 0x%07x, channel %2d: %s", clock27, h.channel,
                         pkt.summary().replace("\n", " | "))
                if self.writer is not None:
                    addr = (pkt.uap << 24) | pkt.lap
                    self.writer.write_packet(pkt.tun_format(), addr)

    # ------------------------------------------------------------ run

    def run(self, samples, start_clkn: int = 0):
        return self.run_blocks(self.fe.stream(samples, start_clkn))

    def run_blocks(self, results):
        for res in results:
            if self.piconet.have_clk27:
                self._hopalong(res)
            else:
                for h in res.hits:
                    self._acquire(res, h)
                    if self.piconet.have_clk27:
                        break
                if self.piconet.have_clk27:
                    self._hopalong(res)
        return self.decoded
