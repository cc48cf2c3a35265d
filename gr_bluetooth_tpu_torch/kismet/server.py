"""BTBBDEV line-protocol server — the network half of the Kismet plugin.

The port of gr_bluetooth_tpu/kismet/server.py, with the same records
byte for byte.  The reference registers a "BTBBDEV" protocol with
Kismet's client/server core: on client enable it blits every tracked
network, and a 1 Hz timer blits dirty networks to all clients
(tracker_bluetooth.cc:131-158, 209-233).  Kismet's wire format is
`*PROTO: field field ...\n` with space-separated positional fields:

    *BTBBDEV: <bdaddr> <firsttime> <lasttime> <packets> <gps...17 fields>

Clients connect, immediately receive a full snapshot, then receive
dirty-network updates on every `tick()` (call it at ~1 Hz like the
reference's SERVER_TIMESLICES_SEC timer, or after each processed block).

Each client has an ordered send queue.  Its snapshot is formatted and
queued, and the client registered, in one step under the tracker lock;
every send happens outside that lock, so a slow client never stalls the
processing thread.  A tick() that blits between a client's snapshot and
the snapshot's send therefore still reaches that client, after its
snapshot.  (The JAX package sends the snapshot first and registers the
client after it, so such a tick's update never reaches the client.)
"""
from __future__ import annotations

import socket
import threading

from .tracker import BTBBDEV_FIELDS, TrackerBluetooth

__all__ = ["BtbbDevServer", "format_record", "parse_record"]


def format_record(net) -> str:
    f = net.fields()
    vals = []
    for name in BTBBDEV_FIELDS:
        v = f[name]
        vals.append(f"{v:.6f}" if isinstance(v, float) else str(v))
    return "*BTBBDEV: " + " ".join(vals) + "\n"


def parse_record(line: str) -> dict:
    if not line.startswith("*BTBBDEV: "):
        raise ValueError("not a BTBBDEV record")
    parts = line[len("*BTBBDEV: "):].split()
    if len(parts) != len(BTBBDEV_FIELDS):
        raise ValueError(f"want {len(BTBBDEV_FIELDS)} fields, got {len(parts)}")
    out = {}
    for name, raw in zip(BTBBDEV_FIELDS, parts):
        if name == "bdaddr":
            out[name] = raw
        elif "." in raw:
            out[name] = float(raw)
        else:
            out[name] = int(raw)
    return out


class _Client:
    """One connection and its queue of payloads not yet sent, sent in
    order by whichever thread holds the client's lock."""

    def __init__(self, conn: socket.socket, first: bytes):
        self.conn = conn
        self._lock = threading.Lock()
        self._pending = [first]

    def send(self, payload: bytes | None = None) -> bool:
        """Queue `payload` (if any) and send everything queued; False if
        the connection failed."""
        with self._lock:
            if payload is not None:
                self._pending.append(payload)
            try:
                while self._pending:
                    self.conn.sendall(self._pending[0])
                    self._pending.pop(0)
            except OSError:
                return False
        return True


class BtbbDevServer:
    """TCP fanout of tracker blits. Thread-safe; clients handled inline.

    `on_snapshot`, when set, is called on the accept thread after a new
    client's snapshot is queued and before it is sent (a test hook)."""

    def __init__(self, tracker: TrackerBluetooth, host: str = "127.0.0.1",
                 port: int = 0):
        self.tracker = tracker
        self.on_snapshot = None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.address = self._srv.getsockname()
        self._clients: list[_Client] = []
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._running = True
        self._accept_thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            # protocol enable: full snapshot to the new client
            # (Protocol_BTBBDEV_enable -> BlitDevices(fd)), queued ahead
            # of any later blit
            with self.tracker.lock:
                payload = "".join(format_record(net)
                                  for net in self.tracker.snapshot()).encode()
                client = _Client(conn, payload)
                with self._lock:
                    self._clients.append(client)
            if self.on_snapshot is not None:
                self.on_snapshot()
            if not client.send():
                self._drop(client)

    def _drop(self, client: _Client):
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)
        client.conn.close()

    def tick(self):
        """Blit dirty networks to all clients (the 1 Hz timer path)."""
        with self.tracker.lock:
            records = [format_record(n) for n in self.tracker.blit()]
        if not records:
            return 0
        payload = "".join(records).encode()
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            if not c.send(payload):
                self._drop(c)
        return len(records)

    def close(self):
        self._running = False
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        with self._lock:
            for c in self._clients:
                c.conn.close()
            self._clients.clear()
