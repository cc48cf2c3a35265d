"""Channel selection for the wideband front end.

Only `select_channels` is ported so far (the polyphase bank needs it);
the odd-rate strided conv bank of gr_bluetooth_tpu/ops/channelizer.py is
a later ROADMAP item.
"""
from __future__ import annotations

from ..constants import BASE_FREQUENCY, CHANNEL_WIDTH

__all__ = ["select_channels"]


def select_channels(fs: float, center_freq: float) -> tuple:
    """BR channels fitting in bandwidth with >= 0.9 MHz margin
    (multi_block.cc:305-324)."""
    center = (center_freq - BASE_FREQUENCY) / CHANNEL_WIDTH
    bw = fs / CHANNEL_WIDTH
    low = max(0, int(center - bw / 2 + 0.45 + 1))
    high = min(78, int(center + bw / 2 - 0.45))
    if high < low:
        raise ValueError("no BR channels fit in this bandwidth")
    return tuple(range(low, high + 1))
