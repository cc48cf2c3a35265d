"""Structured logging (replaces the reference's printf observability,
SURVEY §5: 'structured event log instead of printf').

Two channels:
  * a standard logging.Logger per subsystem (human console)
  * an in-process event sink: models emit typed events (lap_seen, uap_found,
    clock_acquired, packet_decoded, ...) that apps/tests can subscribe to —
    this is what gives reference-parity console output AND machine-readable
    results without parsing stdout.
"""
from __future__ import annotations

import logging
import sys
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["get_logger", "EventBus", "bus"]

_FMT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"grbt.{name}")
    if not logging.getLogger("grbt").handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        root = logging.getLogger("grbt")
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return logger


HISTORY_CAP = 1 << 16      # bounded: a live sniffer emits ~3 events/packet
                           # forever; an unbounded list would leak


@dataclass
class EventBus:
    """Tiny synchronous pub/sub for decoded-packet / discovery events."""
    subscribers: dict = field(default_factory=lambda: defaultdict(list))
    history: deque = field(default_factory=lambda: deque(maxlen=HISTORY_CAP))
    keep_history: bool = True

    def subscribe(self, kind: str, fn: Callable[[dict], Any]):
        self.subscribers[kind].append(fn)

    def emit(self, kind: str, **payload):
        subs = self.subscribers
        if not (self.keep_history or subs):
            return                     # hot path: nobody is listening
        ev = {"kind": kind, **payload}
        if self.keep_history:
            self.history.append(ev)
        for fn in subs.get(kind, []):
            fn(ev)
        for fn in subs.get("*", []):
            fn(ev)

    def events(self, kind: str | None = None) -> list:
        if kind is None:
            return list(self.history)
        return [e for e in self.history if e["kind"] == kind]

    def clear(self):
        self.history.clear()


bus = EventBus()
