"""Per-piconet multiprocess host decode: scale the sniffer's host half
across CPU cores.

The device front end emits hit tables faster than one Python thread can
decode them under a hostile air load (bench.py `sniffer_hostile`), and
the per-packet work is GIL-bound small-array overhead, so threads do not
help.  Piconet state, however, partitions EXACTLY by LAP — discovery,
clock tracking, FHS offsets, and payload decode of different piconets
never interact (the reference's multi_sniffer keeps one registry only
because it is single-threaded, lib/multi_sniffer_impl.cc:82-166).  This
module shards hits by hash(LAP) across N worker processes, each running
the standard classic-decode flow (including core/batch_decode) with its
own piconet registry and strict in-order processing per LAP.

Semantics vs a single Sniffer: per-LAP decode order, state evolution,
and outputs are identical (tested); only the interleaving of DIFFERENT
LAPs' log lines differs.  LE handling stays in the caller (LE state is
per-AA and cheap).  Incompatible with checkpoint/resume (worker-resident
state) — use the single-process Sniffer for that.

The port of gr_bluetooth_tpu/models/parallel_host.py.  The workers are
host processes: every piconet they build runs on the CPU (device="cpu"),
so no worker opens a CUDA context of its own, whatever card the front end
that feeds them runs on.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from dataclasses import dataclass

import numpy as np

__all__ = ["DecodedPacket", "ParallelHostDecoder"]


@dataclass
class DecodedPacket:
    lap: int
    uap: int
    clkn: int
    channel: int
    packet_type: int
    payload_length: int
    payload: bytes | None          # unwhitened payload bits, packed
    crc_ok: bool | None


def _worker_main(conn, log_level):
    """Worker loop: owns a LAP-partitioned piconet registry and decodes
    its share of each block's hits in order."""
    import logging
    logging.disable(log_level)
    from ..constants import GIAC, LIAC
    from ..core import batch_decode
    from ..core.packets import ClassicPacket
    from .piconet import BasicRatePiconet

    piconets: dict[int, BasicRatePiconet] = {}

    _CRC_TYPES = (3, 4, 8, 10, 11, 14, 15)   # ACL types carrying a CRC-16

    def decode_one(pkt, pn, first_run, pre=None):
        clock = pkt.clkn + pn.get_offset()
        pkt.set_clock(clock, pn.have_clk27)
        pkt.set_uap(pn.uap)
        crc_ok = None
        if pre is not None and pre[1] == pkt.clock and pre[2] == pn.uap:
            from .sniffer import _apply_batch_row
            ok = _apply_batch_row(pkt, pre[0])
            crc_ok = pre[0].get("crc_ok")
        else:
            ok = pkt.decode()
            if ok and pkt.packet_type in _CRC_TYPES and \
                    pkt.payload_length >= 2:
                crc_ok = pkt._payload_crc_ok()
        out = []
        if ok:
            out.append(DecodedPacket(
                pkt.lap, pkt.uap, pkt.clkn, pkt.channel, pkt.packet_type,
                pkt.payload_length,
                np.packbits(pkt.payload).tobytes()
                if pkt.payload is not None else None, crc_ok))
            if pkt.packet_type == 2:           # FHS: offset/uap harvest
                lap = pkt.lap_from_fhs()
                # stored locally; if the advertised LAP hashes to another
                # shard, its worker simply rediscovers via the header
                # attack (graceful, like a sniffer that missed the FHS)
                p2 = piconets.get(lap)
                if p2 is None:
                    p2 = piconets[lap] = BasicRatePiconet(lap=lap,
                                                          device="cpu")
                p2.set_uap(pkt.uap_from_fhs())
                p2.set_nap(pkt.nap_from_fhs())
                p2.set_offset(((pkt.clock_from_fhs() << 1) - pkt.clkn)
                              & 0x7FFFFFF)
        elif first_run:
            pn.reset()
            out += discover(pkt, pn)
        return out

    def discover(pkt, pn):
        pn.enqueue(pkt)
        out = []
        if pn.uap_from_header(pkt):
            while True:
                q = pn.dequeue()
                if q is None:
                    break
                out += decode_one(q, pn, first_run=False)
        return out

    def do_block(rows):
        decoded = []
        syms = [np.unpackbits(np.frombuffer(r["sym"], np.uint8))
                [: r["size"]] for r in rows]
        # precompute batch rows for known piconets (block-start state)
        known = [i for i, r in enumerate(rows)
                 if r["hp"] and (pn := piconets.get(r["lap"])) is not None
                 and pn.have_clk6 and pn.have_uap]
        pre = {}
        if known:
            w = max(rows[i]["size"] for i in known)
            symp = np.zeros((len(known), max(w, 126)), np.uint8)
            for j, i in enumerate(known):
                symp[j, : rows[i]["size"]] = syms[i]
            clocks, uaps = [], []
            for i in known:
                pn = piconets[rows[i]["lap"]]
                clocks.append((rows[i]["clkn"] + pn.get_offset()) &
                              (0x7FFFFFF if pn.have_clk27 else 0x3F))
                uaps.append(pn.uap)
            sizes = np.array([rows[i]["size"] for i in known])
            res = batch_decode.decode_known_rows(
                symp, sizes, np.asarray(clocks), np.asarray(uaps))
            for j, i in enumerate(known):
                if res[j] is not None:
                    pre[i] = (res[j], int(clocks[j]), int(uaps[j]))
        for i, r in enumerate(rows):
            if not r["hp"]:
                continue                        # ID packet: caller logs
            pkt = ClassicPacket(symbols=syms[i], clkn=r["clkn"],
                                channel=r["channel"], snr=r["snr"])
            pkt._lap = r["lap"]     # device-computed; skip the re-derive
            lap = pkt.lap
            pn = piconets.get(lap)
            if pn is None:
                pn = piconets[lap] = BasicRatePiconet(lap=lap, device="cpu")
            if pn.have_clk6 and pn.have_uap:
                decoded += decode_one(pkt, pn, True, pre.get(i))
            else:
                decoded += discover(pkt, pn)
            if lap in (GIAC, LIAC):
                piconets.pop(lap, None)
        return decoded

    while True:
        msg = conn.recv()
        if msg is None:
            break
        kind = msg[0]
        if kind == "block":
            try:
                conn.send(("ok", do_block(msg[1])))
            except Exception:
                import traceback
                conn.send(("error", traceback.format_exc()))
        elif kind == "stats":
            conn.send(("ok", {lap: (pn.uap if pn.have_uap else None)
                              for lap, pn in piconets.items()}))
    conn.close()


class ParallelHostDecoder:
    """Shard a block stream's classic hits across N decode workers.

    drive(fe, results) iterates BlockResults (from FrontEnd.stream or a
    sharded front end) and returns DecodedPacket records, globally
    ordered by (clkn, channel)."""

    def __init__(self, n_workers: int | None = None):
        import logging
        self.n = n_workers or max(1, (os.cpu_count() or 2) - 1)
        ctx = mp.get_context("spawn")
        self._conns = []
        self._procs = []
        for _ in range(self.n):
            a, b = ctx.Pipe()
            p = ctx.Process(target=_worker_main, args=(b, logging.INFO),
                            daemon=True)
            p.start()
            self._conns.append(a)
            self._procs.append(p)

    def close(self):
        for c in self._conns:
            try:
                c.send(None)
                c.close()
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
        self._conns, self._procs = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def drive(self, fe, results, depth: int = 4) -> list[DecodedPacket]:
        """Pipelined: up to `depth` blocks' shards are in flight per
        worker before the oldest result is awaited — workers process
        their queues strictly in order (state-safe), and the pipe
        round-trip overlaps the next block's shard preparation."""
        import queue as _q
        import threading

        decoded = []
        pending: list[list[int]] = []
        # all sends run on a feeder thread: the main thread then NEVER
        # blocks in conn.send(), so it can always drain results — the
        # classic both-pipe-buffers-full deadlock (main blocked sending a
        # large shard while a worker blocks sending a large result)
        # cannot form.  Each Connection has exactly one
        # sender (feeder) and one receiver (main), full duplex.
        sendq: _q.Queue = _q.Queue()
        feed_err: list = []

        def _feeder():
            while True:
                item = sendq.get()
                if item is None:
                    return
                w, payload = item
                try:
                    self._conns[w].send(payload)
                except Exception as e:     # worker died; reap surfaces it
                    feed_err.append(e)
                    return

        feeder = threading.Thread(target=_feeder, daemon=True)
        feeder.start()

        def reap():
            for w in pending.pop(0):
                while not self._conns[w].poll(30):
                    if feed_err:
                        raise RuntimeError(
                            f"decode pool send failed: {feed_err[0]!r}")
                status, payload = self._conns[w].recv()
                if status == "error":
                    raise RuntimeError(f"decode worker failed:\n{payload}")
                decoded.extend(payload)

        try:
            for res in results:
                sym, sizes = fe.packet_symbols_matrix(res)
                if sym.shape[0]:
                    s = sym
                    msb = s[:, 67].astype(np.int64)
                    be = ((s[:, 68] ^ (1 - msb)) + (s[:, 69] ^ msb) +
                          (s[:, 70] ^ (1 - msb)) + (s[:, 71] ^ msb))
                    t = s[:, 72:126].reshape(s.shape[0], 18,
                                             3).astype(np.int64)
                    a, b, c = t[:, :, 0], t[:, :, 1], t[:, :, 2]
                    be = be + (((a ^ b) | (b ^ c)) | (c ^ a)).sum(axis=1)
                    from ..core.packets import ID_THRESHOLD
                    hp = (sizes >= 126) & (be < ID_THRESHOLD)
                else:
                    hp = np.zeros(0, bool)
                shards: list[list] = [[] for _ in range(self.n)]
                for j, h in enumerate(res.hits):
                    shards[hash(h.lap) % self.n].append(dict(
                        lap=h.lap, clkn=h.clkn, channel=h.channel,
                        snr=h.snr_db, hp=bool(hp[j]), size=int(sizes[j]),
                        sym=np.packbits(sym[j]).tobytes()))
                busy = []
                for w, rows in enumerate(shards):
                    if rows:
                        sendq.put((w, ("block", rows)))
                        busy.append(w)
                pending.append(busy)
                if len(pending) > depth:
                    reap()
            while pending:
                reap()
        finally:
            sendq.put(None)
            feeder.join(timeout=10)
        decoded.sort(key=lambda d: (d.clkn, d.channel))
        return decoded
