"""Capture source: FrontEnd hit stream -> LAP frames -> tracker/queue.

The port of gr_bluetooth_tpu/kismet/source.py over the port's FrontEnd.
The reference's bluetooth_kismet_block::work scans every channel per slot,
takes at most ONE access code per channel per slot (sniff_ac returns the
first; bluetooth_kismet_block.cc:66-84), and enqueues a 14-byte LAP frame.
Here the dense detector returns all hits per block; this adapter applies
the same one-per-(channel, slot) rule before framing, so frame counts
match the reference's behavior on the same capture.

The front end runs on the CUDA card unless `device` names another torch
device; with no card and no device it raises, as FrontEnd does.
"""
from __future__ import annotations

from ..constants import DEFAULT_SNR_DB
from ..models.frontend import FrontEnd
from .frames import FrameQueue, LapFrame
from .tracker import TrackerBluetooth

__all__ = ["KismetSource"]


class KismetSource:
    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB,
                 tracker: TrackerBluetooth | None = None,
                 queue: FrameQueue | None = None,
                 gps_provider=None, device=None, **fe_kwargs):
        # max_ac_errors=1: the kismet block uses sniff_ac's default single
        # candidate path with the plugin's stock tolerance
        self.fe = FrontEnd(sample_rate, center_freq, squelch_threshold,
                           max_ac_errors=1, device=device, **fe_kwargs)
        self.tracker = tracker or TrackerBluetooth()
        # `is None`, not `or`: an empty FrameQueue is falsy (its len is
        # 0), and the JAX package's `queue or FrameQueue()` replaces a
        # caller's empty queue with a default one of 20 frames
        self.queue = queue if queue is not None else FrameQueue()
        self.gps_provider = gps_provider   # callable -> GpsFix | None

    def run(self, samples, start_clkn: int = 0):
        return self.run_blocks(self.fe.stream(samples, start_clkn))

    def run_blocks(self, results):
        n_frames = 0
        for res in results:
            seen = set()                       # one per (channel, slot)
            for h in res.hits:
                key = (h.channel, h.clkn)
                if key in seen:
                    continue
                seen.add(key)
                frame = LapFrame(lap=h.lap, channel=h.channel, clkn=h.clkn)
                self.queue.put(frame)
                gps = self.gps_provider() if self.gps_provider else None
                self.tracker.observe(h.lap, gps=gps)
                n_frames += 1
        return n_frames
