"""Device-list UI — parity with the plugin's ncurses panel
(bluetooth_ui.cc): a sortable table of tracked networks with the same four
sort orders (bdaddr / first seen / last seen / packet count,
bluetooth_ui.cc:49-107).

A copy of gr_bluetooth_tpu/kismet/ui.py (host code, no device).

`render()` is a pure function (testable without a tty); `run_curses()`
wraps it in a live curses loop with the sort-menu keys:
    a=bdaddr  f=first  l=last  p=packets  q=quit
"""
from __future__ import annotations

import time

from .tracker import BluetoothNetwork, TrackerBluetooth

__all__ = ["SORT_KEYS", "sort_networks", "render", "run_curses"]

SORT_KEYS = {
    "bdaddr": lambda n: n.lap,
    "firsttime": lambda n: n.first_time,
    "lasttime": lambda n: n.last_time,
    "packets": lambda n: -n.num_packets,   # most packets first
}


def sort_networks(nets: list[BluetoothNetwork],
                  sort: str = "bdaddr") -> list[BluetoothNetwork]:
    if sort not in SORT_KEYS:
        raise ValueError(f"sort must be one of {sorted(SORT_KEYS)}")
    return sorted(nets, key=SORT_KEYS[sort])


def render(tracker: TrackerBluetooth, sort: str = "bdaddr",
           width: int = 72, now: float | None = None) -> str:
    """Plain-text device table (what the curses panel draws)."""
    now = time.time() if now is None else now
    lines = [f"{'BD_ADDR':<18} {'Packets':>8} {'First':>8} {'Last':>8} GPS",
             "-" * min(width, 60)]
    for n in sort_networks(tracker.snapshot(), sort):
        g = n.gpsdata
        gps = (f"{g.aggregate_lat / g.aggregate_points:.4f},"
               f"{g.aggregate_lon / g.aggregate_points:.4f}"
               if g.aggregate_points else "-")
        lines.append(f"{n.bd_addr:<18} {n.num_packets:>8} "
                     f"{int(now - n.first_time):>7}s {int(now - n.last_time):>7}s "
                     f"{gps}")
    lines.append(f"[{len(tracker.tracked_nets)} nets, "
                 f"{len(tracker.first_nets) - len(tracker.tracked_nets)} "
                 f"candidates, sort={sort}]")
    return "\n".join(lines)


def run_curses(tracker: TrackerBluetooth, refresh_s: float = 1.0):
    """Live curses loop (requires a tty)."""
    import curses

    def main(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        sort = "bdaddr"
        keymap = {ord("a"): "bdaddr", ord("f"): "firsttime",
                  ord("l"): "lasttime", ord("p"): "packets"}
        while True:
            scr.erase()
            text = render(tracker, sort, width=scr.getmaxyx()[1] - 1)
            for i, line in enumerate(text.splitlines()):
                if i >= scr.getmaxyx()[0] - 2:
                    break
                scr.addnstr(i, 0, line, scr.getmaxyx()[1] - 1)
            scr.addnstr(scr.getmaxyx()[0] - 1, 0,
                        "sort: [a]ddr [f]irst [l]ast [p]ackets   [q]uit",
                        scr.getmaxyx()[1] - 1)
            scr.refresh()
            ch = scr.getch()
            if ch == ord("q"):
                return
            if ch in keymap:
                sort = keymap[ch]
            time.sleep(refresh_s)

    curses.wrapper(main)
