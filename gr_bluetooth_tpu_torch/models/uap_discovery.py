"""UAP discovery mode — parity with multi_UAP (lib/multi_UAP_impl.cc).

Watches for packets of a target LAP (max_ac_errors=2, multi_UAP_impl.cc:71),
feeds headers into the piconet's CLK1-6/UAP candidate-elimination attack,
and stops once the UAP is known (the reference exit(0)s,
multi_UAP_impl.cc:103-106; we return instead).

The port of gr_bluetooth_tpu/models/uap_discovery.py over the port's
FrontEnd; it runs on the CUDA card unless given another device.
"""
from __future__ import annotations

from ..constants import DEFAULT_SNR_DB
from ..core.packets import ClassicPacket
from ..utils.device import resolve_device
from ..utils.log import EventBus, bus as default_bus, get_logger
from .frontend import FrontEnd
from .piconet import BasicRatePiconet

__all__ = ["UapDiscovery"]

log = get_logger("uap_discovery")


class UapDiscovery:
    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB, lap: int = 0,
                 bus: EventBus | None = None, device=None, **fe_kwargs):
        self.device = resolve_device(device)
        self.fe = FrontEnd(sample_rate, center_freq, squelch_threshold,
                           max_ac_errors=2, device=self.device, **fe_kwargs)
        self.lap = lap
        self.piconet = BasicRatePiconet(lap=lap, device=self.device)
        self.bus = bus or default_bus

    def run(self, samples, start_clkn: int = 0):
        """Returns the discovered UAP, or None if the capture ran out."""
        return self.run_blocks(self.fe.stream(samples, start_clkn))

    def run_blocks(self, results):
        for res in results:
            for h in res.hits:
                if h.lap != self.lap:
                    continue
                pkt = ClassicPacket(symbols=self.fe.packet_symbols(res, h),
                                    clkn=h.clkn, channel=h.channel,
                                    snr=h.snr_db)
                if not pkt.header_present():
                    continue
                if self.piconet.uap_from_header(pkt):
                    uap = self.piconet.uap
                    self.bus.emit("uap_found", lap=self.lap, uap=uap,
                                  clk_offset=self.piconet.clk_offset)
                    print(f"UAP = 0x{uap:02x} found for LAP {self.lap:06x}")
                    return uap
        return None
