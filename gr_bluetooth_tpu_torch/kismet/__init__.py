"""Live survey subsystem — the port of gr_bluetooth_tpu/kismet, the
standalone equivalent of the reference's Kismet plugin
(kismet/plugin-bluetooth/, ~3.1k LoC).

The reference integrates into Kismet's process: a GNU Radio block feeds
14-byte LAP frames through a mutex/socketpair queue
(bluetooth_kismet_block.cc:95-130) into Kismet's packet chain, a
per-LAP network tracker with GPS aggregation (tracker_bluetooth.cc), a
BTBBDEV text protocol served to Kismet clients, and an ncurses device-list
UI with a sort menu (bluetooth_ui.cc).

Here the same capabilities are a standalone package:
    frames   — the 14-byte LAP frame codec + the bounded wake-fd queue
    tracker  — two-sighting LAP tracker with GPS aggregation
    server   — BTBBDEV line protocol over TCP (periodic dirty blits)
    source   — FrontEnd stream -> frame queue (the kismet block's work())
    ui       — curses device list with the same four sort orders
Only `source` touches the device (through the port's FrontEnd).
"""
from .frames import LapFrame, FrameQueue
from .tracker import BluetoothNetwork, GpsFix, TrackerBluetooth
from .server import BtbbDevServer
from .source import KismetSource

__all__ = ["LapFrame", "FrameQueue", "BluetoothNetwork", "GpsFix",
           "TrackerBluetooth", "BtbbDevServer", "KismetSource"]
