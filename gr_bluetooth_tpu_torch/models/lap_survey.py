"""LAP survey mode — parity with multi_LAP (lib/multi_LAP_impl.cc).

The port of gr_bluetooth_tpu/models/lap_survey.py over the port's
FrontEnd.  The reference's multi_LAP delegates to libbtbb's btbb_find_ac
with max_ac_errors=1 (multi_LAP_impl.cc:74) and prints channel/LAP/
errors/slot for every detection; the device step has already found every
access code, so this mode formats and collects.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..constants import DEFAULT_SNR_DB
from ..utils.log import EventBus, bus as default_bus, get_logger
from .frontend import FrontEnd

__all__ = ["LapSurvey", "LapObservation"]

log = get_logger("lap_survey")


@dataclass
class LapObservation:
    clkn: int
    channel: int
    lap: int
    errors: int
    snr_db: float


class LapSurvey:
    """Print/collect the LAP of every detected access code."""

    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB,
                 max_ac_errors: int = 1, bus: EventBus | None = None,
                 **fe_kwargs):
        self.fe = FrontEnd(sample_rate, center_freq, squelch_threshold,
                           max_ac_errors=max_ac_errors, **fe_kwargs)
        self.bus = bus or default_bus
        self.observations: list[LapObservation] = []

    def run(self, samples, start_clkn: int = 0, emit_console: bool = True):
        return self.run_blocks(self.fe.stream(samples, start_clkn),
                               emit_console=emit_console)

    def run_blocks(self, results, emit_console: bool = True):
        """Consume an iterator of BlockResults (streaming sources)."""
        for res in results:
            for h in res.hits:
                obs = LapObservation(h.clkn, h.channel, h.lap, h.errors,
                                     h.snr_db)
                self.observations.append(obs)
                self.bus.emit("lap_seen", clkn=h.clkn, channel=h.channel,
                              lap=h.lap, errors=h.errors, snr_db=h.snr_db)
                if emit_console:
                    print(f"time {h.clkn:6d}, channel {h.channel:2d}, "
                          f"LAP {h.lap:06x} errs {h.errors} "
                          f"snr={h.snr_db:.1f}")
        return self.observations

    def laps(self) -> set:
        return {o.lap for o in self.observations}
