"""Time-parallel streaming with halo exchange, over several devices and
processes.

The port of gr_bluetooth_tpu/parallel/sharded.py.  A long capture is
split into superblocks of n_dev contiguous chunks, one per shard; shard
d runs the front end's whole step (the fused chain of the polyphase
banks, _fused_step, or the conv bank's step at odd rates, _conv_step,
LE included when the front end has it) on its chunk plus a halo: the
first `overlap_samples` of shard d+1's chunk, the overlap-save history
the reference gets from GNU Radio's set_history
(lib/multi_block.cc:100-119).  The last shard's halo lies in the NEXT
superblock, so each step takes that superblock's head as a side input
(zeros past the capture's end, as FrontEnd.stream pads its tail).
Chunk boundaries therefore see exactly the samples of the unsharded
stream, and the hits are the same.

Devices.  The shards are a list of torch devices, one entry per shard
(the JAX package's `time` mesh axis).  The same device may appear more
than once, and then holds several shards, which the caller asks for
explicitly ([cuda:0] * 4, [cpu] * 4); shards are never mapped onto
fewer devices than given.  The front end's constants are copied once to
each distinct device.  On a card each shard has its own CUDA stream:
its chunk's H2D copy, its halo copy and its step are enqueued there,
and every halo copy waits on an event recorded after its source chunk's
H2D copy.  A halo between two cards is a peer copy, on one card a
device-local copy.

Processes.  Under a torch.distributed process group of P processes
(`process_group=`), process p holds the contiguous p-th 1/P of each
superblock on its own shards (device_put_local).  The halo of its last
shard is the head of process p+1's chunk, received point to point; the
last process's last shard takes the next superblock's head.  With the
gloo backend, which carries only CPU tensors, that halo goes through
host memory: each process sends the head of its chunk from the host
copy it was given.  With NCCL it goes from device to device.  The
backend is the caller's process group's; nothing here picks one.
Outputs are gathered to process 0, which assembles the BlockResults,
as tests/_multihost_worker.py does with process_allgather.

`measure_scaling_efficiency` compares the sharded step with a twin whose
halos arrive pre-placed (nothing exchanged) and with a one-device loop
over the superblock's blocks, at equal total work.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..models.frontend import (BlockResult, FrontEnd, _conv_step,
                               _fused_step, consts_to_device)
from ..utils.device import resolve_device
from ..utils.graph import StepCache

__all__ = ["ShardedFrontEnd", "measure_scaling_efficiency"]


# ------------------------------------------------------------ shard column

def as_devices(devices) -> list[torch.device]:
    """Shard devices as torch.devices, "cuda" resolved to the current
    card.  None means one shard on every card there is, and raises when
    there is none."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("need at least one shard device")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"shards must all be CUDA or all CPU devices, got "
                         f"{[str(d) for d in out]}")
    return out


def host_consts(fe: FrontEnd) -> dict:
    """The front end's step constants as host arrays."""
    return {k: v.cpu().numpy() for k, v in fe.consts.items()}


def _on(stream):
    """The shard's stream (and its device) as the current one; nothing
    for a CPU shard."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class Column:
    """Time shards of one front end's step: shard i holds a block buffer
    (2, step + overlap) on devices[i], has its own stream there and
    reads consts[i] (the step's constants on its device).

    Each shard replays its own compiled step (utils/graph.py), captured
    on that shard's stream and device with a memory pool of its own (the
    shards' graphs run concurrently), as the JAX package jits the
    sharded step; the halo copies and any exchange between processes
    stay outside the graphs."""

    def __init__(self, fe: FrontEnd, devices, consts):
        self.devices = devices
        self.consts = consts
        self.statics = fe.statics
        self.step_fn = _fused_step if fe.is_pfb else _conv_step
        self.step = fe.step_samples
        self.overlap = fe.overlap_samples
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in devices]
        self.graphs = [StepCache(d, s)
                       for d, s in zip(devices, self.streams)]

    def compiled(self, i: int):
        """Shard i's compiled step on a (2, step + overlap) block."""
        c = self.consts[i]

        def step(xb):
            return self.step_fn(xb, **c, **self.statics)

        return self.graphs[i].get(
            self.step_fn, step,
            [((2, self.step + self.overlap), torch.float32)])

    def place(self, x):
        """(2, n * step) host planes -> per-shard blocks with the chunks
        written (H2D on each shard's stream, marked by an event) and the
        halos not yet."""
        blocks, events = [], []
        for i, (dev, s) in enumerate(zip(self.devices, self.streams)):
            src = torch.from_numpy(np.ascontiguousarray(
                x[:, i * self.step:(i + 1) * self.step], np.float32))
            with _on(s):
                xb = torch.empty((2, self.step + self.overlap),
                                 dtype=torch.float32, device=dev)
                if s is None:
                    xb[:, :self.step].copy_(src)
                    ev = None
                else:
                    xb[:, :self.step].copy_(src.pin_memory(),
                                            non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(s)
            blocks.append(xb)
            events.append(ev)
        return blocks, events

    def halos(self, blocks, events):
        """Each shard's halo but the last's: the head of the next shard's
        chunk, copied after that chunk's H2D copy (a peer copy between
        cards, a device-local one on one card)."""
        step, ov = self.step, self.overlap
        for i in range(len(blocks) - 1):
            dst, src = blocks[i], blocks[i + 1]
            s_dst, s_src = self.streams[i], self.streams[i + 1]
            if s_dst is None:
                dst[:, step:].copy_(src[:, :ov])
                continue
            s_dst.wait_event(events[i + 1])
            # between cards the copy runs on the source card's current
            # stream (s_src) and the destination's (s_dst) waits for it
            with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
                dst[:, step:].copy_(src[:, :ov], non_blocking=True)
            if src.device == dst.device:
                src.record_stream(s_dst)

    def set_halo(self, i: int, blocks, halo):
        """Shard i's halo from host planes or a tensor (2, overlap)."""
        s = self.streams[i]
        if not isinstance(halo, torch.Tensor):
            halo = torch.from_numpy(np.ascontiguousarray(halo, np.float32))
            if s is not None:
                halo = halo.pin_memory()
        with _on(s):
            blocks[i][:, self.step:].copy_(halo, non_blocking=True)

    def launch(self, blocks):
        """Every shard's compiled step on its stream (the block copied
        into the step's static input there, then one replay); returns the
        outputs stacked per shard on devices[0], on the caller's stream
        there."""
        outs = []
        for i, (xb, s) in enumerate(zip(blocks, self.streams)):
            with _on(s):
                outs.append(self.compiled(i)(xb))
        return stack_outputs(outs, self.devices, self.streams)


def stack_outputs(outs, devices, streams):
    """Per-shard step 7-tuples -> the JAX package's stacked outputs on
    devices[0]: (n, S, C), (n, 1), (n, K, 4), (n, K, W8) [+ (n, 1),
    (n, K_le, 3), (n, K_le, W_le) with LE on]."""
    n_out = 4 if outs[0][4] is None else 7
    dev0 = devices[0]
    cur = torch.cuda.current_stream(dev0) if dev0.type == "cuda" else None
    cols = [[] for _ in range(n_out)]
    for o, dev, s in zip(outs, devices, streams):
        with _on(s):
            moved = [t.reshape(1) if t.ndim == 0 else t for t in o[:n_out]]
            if dev != dev0:
                moved = [t.to(dev0, non_blocking=True) for t in moved]
        if s is not None and dev == dev0:
            cur.wait_stream(s)
        for j, t in enumerate(moved):
            cols[j].append(t)
    stacked = tuple(torch.stack(c, 0) for c in cols)
    # the outputs are the shards' static tensors: a shard's next replay
    # waits for the stack that read them (the copy to another card ran
    # on the shard's own stream)
    for dev, s in zip(devices, streams):
        if s is not None and dev == dev0:
            s.wait_stream(cur)
    return stacked


def to_host(out) -> list[np.ndarray]:
    return [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in out]


def superblocks(samples, sb: int, ov: int):
    """(chunk (2, sb), head (2, ov)) over a capture, each zero-padded
    past its end."""
    n = samples.shape[1]
    for pos in range(0, n, sb):
        chunk = samples[:, pos:pos + sb]
        if chunk.shape[1] < sb:
            pad = np.zeros((2, sb), np.float32)
            pad[:, :chunk.shape[1]] = chunk
            chunk = pad
        head = samples[:, pos + sb:pos + sb + ov]
        if head.shape[1] < ov:
            hp = np.zeros((2, ov), np.float32)
            hp[:, :head.shape[1]] = head
            head = hp
        yield chunk, head


class Placed:
    """A superblock's local chunks on their shards (Column.place) and
    the host copy of this process's first `overlap` samples, which the
    previous process receives as its last halo over gloo."""

    def __init__(self, blocks, events, head):
        self.blocks = blocks
        self.events = events
        self.head = head


# ------------------------------------------------------------ front end

class ShardedFrontEnd:
    """Run a FrontEnd's device step time-sharded over `devices` (and,
    with `process_group`, over that group's processes: `devices` are
    then this process's shards, the same count in every process).

    fe.block_samples = step + overlap; each shard holds `step` samples,
    receives `overlap` halo samples from the next shard, and the last
    shard receives the next superblock's head."""

    def __init__(self, fe: FrontEnd, devices=None, process_group=None):
        if fe.step_samples < fe.overlap_samples:
            raise ValueError("chunk must be at least as long as the halo; "
                             "increase block_slots")
        self.fe = fe
        self.devices = as_devices(devices)
        self.group = process_group
        if process_group is None:
            self.world, self.rank, self.backend = 1, 0, None
        else:
            import torch.distributed as dist
            self.world = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
            self.backend = dist.get_backend(process_group)
        self.n_local = len(self.devices)
        self.n_dev = self.n_local * self.world
        host = host_consts(fe)
        on_dev: dict = {}
        for d in self.devices:
            if d not in on_dev:
                on_dev[d] = consts_to_device(host, d)
        self.column = Column(fe, self.devices,
                             [on_dev[d] for d in self.devices])
        self.with_le = bool(fe.enable_le and fe.le_rows)
        self.chunk_samples = fe.step_samples
        self.overlap_samples = fe.overlap_samples
        self.total_samples = fe.step_samples * self.n_dev   # one superblock
        self.superblock_slots = fe.block_slots * self.n_dev

    def device_put(self, x: np.ndarray) -> Placed:
        """Place (2, n_dev*step) float32 planes on the shards; under a
        process group, this process's contiguous part of them."""
        part = self.total_samples // self.world
        return self.device_put_local(
            np.asarray(x)[:, self.rank * part:(self.rank + 1) * part])

    def device_put_local(self, local: np.ndarray) -> Placed:
        """Multi-process ingest: this process's contiguous time chunk
        [p*total/P, (p+1)*total/P) of the superblock onto its own shards.
        Each process's feeder streams a distinct time span straight to
        its own devices; only the halo crosses between processes.  In
        one process it is device_put."""
        local = np.asarray(local, np.float32)
        want = (2, self.n_local * self.chunk_samples)
        if local.shape != want:
            raise ValueError(f"local chunk must be {want}, got "
                             f"{local.shape}")
        blocks, events = self.column.place(local)
        return Placed(blocks, events,
                      np.ascontiguousarray(local[:, :self.overlap_samples]))

    def step(self, placed: Placed, next_head):
        """One superblock step over this process's shards; returns their
        stacked outputs on the first shard's device, (n_local, S, C),
        (n_local, 1), (n_local, K, 4), (n_local, K, W8) [+ LE triple
        when enabled] (gather() brings every process's to process 0)."""
        col = self.column
        col.halos(placed.blocks, placed.events)
        last = self.n_local - 1
        if self.rank == self.world - 1:
            col.set_halo(last, placed.blocks, next_head)
        if self.world > 1:
            self._exchange(placed)
        return col.launch(placed.blocks)

    def _exchange(self, placed: Placed):
        """Send this process's chunk head to process p-1 and receive the
        last shard's halo from process p+1."""
        import torch.distributed as dist
        col, ov = self.column, self.overlap_samples
        g = self.group
        # gloo carries only CPU tensors, so its halo goes through host
        # memory; other backends (NCCL) send device to device
        on_host = self.backend == "gloo" or self.devices[0].type == "cpu"
        works = []
        if self.rank > 0:
            peer = dist.get_global_rank(g, self.rank - 1)
            if on_host:
                works.append(dist.isend(torch.from_numpy(placed.head),
                                        peer, group=g))
            else:
                with _on(col.streams[0]):
                    head = placed.blocks[0][:, :ov].contiguous()
                    works.append(dist.isend(head, peer, group=g))
        if self.rank < self.world - 1:
            peer = dist.get_global_rank(g, self.rank + 1)
            last = self.n_local - 1
            dev = self.devices[last] if not on_host else torch.device("cpu")
            with _on(None if on_host else col.streams[last]):
                buf = torch.empty((2, ov), dtype=torch.float32, device=dev)
                recv = dist.irecv(buf, peer, group=g)
                recv.wait()
            col.set_halo(last, placed.blocks, buf)
        for w in works:
            w.wait()

    def gather(self, out):
        """Every process's step outputs, as host arrays stacked in shard
        order, on process 0 (None on the others); the outputs themselves
        in one process."""
        host = to_host(out)
        if self.world == 1:
            return host
        import torch.distributed as dist
        got = [None] * self.world if self.rank == 0 else None
        dist.gather_object(host, got, dst=dist.get_global_rank(self.group, 0),
                           group=self.group)
        if self.rank != 0:
            return None
        return [np.concatenate([p[j] for p in got], 0)
                for j in range(len(host))]

    # ------------------------------------------------------------- host

    def _assemble(self, out, slot_base: int) -> list[BlockResult]:
        host = to_host(out)
        if self.with_le:
            snr_db, n_hits, tab, windows, n_le, le_tab, le_windows = host
        else:
            snr_db, n_hits, tab, windows = host
            n_le = le_tab = le_windows = None
        results = []
        for d in range(snr_db.shape[0]):
            base = slot_base + d * self.fe.block_slots
            res = self.fe.assemble_block(
                snr_db[d], int(n_hits[d, 0]), tab[d], windows[d],
                int(n_le[d, 0]) if n_le is not None else None,
                le_tab[d] if le_tab is not None else None,
                le_windows[d] if le_windows is not None else None,
                slot_base=base)
            results.append(res)
        return results

    def stream(self, samples: np.ndarray, start_clkn: int = 0):
        """Iterate BlockResults over a long capture, superblock by
        superblock: the multi-device equivalent of FrontEnd.stream.

        Each step's last-shard halo is the next superblock's real head
        (zeros past end-of-capture, matching the unsharded tail pad), so
        hits are identical to the unsharded stream over the same span.
        Under a process group every process passes the whole capture and
        places its own part; process 0 yields the results, the others
        none."""
        samples = self.fe._host_planes(samples)
        slot_base = start_clkn
        for chunk, head in superblocks(samples, self.total_samples,
                                          self.overlap_samples):
            out = self.gather(self.step(self.device_put(chunk), head))
            if out is not None:
                yield from self._assemble(out, slot_base)
            slot_base += self.superblock_slots

    def process(self, samples: np.ndarray, start_clkn: int = 0):
        """Run the whole capture; returns the list of per-shard
        BlockResults (one per shard per superblock)."""
        return list(self.stream(samples, start_clkn))


# ------------------------------------------------------------ scaling

def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure_scaling_efficiency(fe: FrontEnd, devices=None,
                               n_superblocks: int = 2, repeats: int = 2,
                               seed: int = 0):
    """Isolate the cost of sharding's halo exchange.

    Three runs at equal total work, their repeats interleaved:

      * the sharded step (ShardedFrontEnd.stream: H2D, halo copies
        ordered by events, the steps, assembly);
      * **efficiency**'s twin: the same shards, streams and step, whose
        halos arrive pre-placed on each shard's device (a device-local
        copy into the block, nothing exchanged).  The TRUE ratio is the
        fraction of time not spent on the halo exchange and lies in
        (0, 1]; the measured per-repeat ratios are time quotients under
        timer jitter and can exceed 1 when the halo cost is below the
        jitter (the median and the [q25, q75] spread are the quoted
        statistics, and `noise_floor` flags the jitter-dominated
        regime);
      * **speedup_vs_scan_1dev**: a loop over the superblock's blocks on
        the first device, one after another through shard 0's compiled
        step (the stand-in for the JAX package's one-dispatch lax.scan).  With
        shards on several cards it approaches n_devices x; with all
        shards on one card it measures what concurrent streams buy.
    """
    sfe = ShardedFrontEnd(fe, devices)
    col = sfe.column
    rng = np.random.default_rng(seed)
    sb, ov, step = sfe.total_samples, sfe.overlap_samples, sfe.chunk_samples
    n = sb * n_superblocks + ov
    x = rng.standard_normal((2, n)).astype(np.float32) * 0.05
    dev0 = sfe.devices[0]
    bs = fe.block_samples

    halos = [[torch.from_numpy(np.ascontiguousarray(
        x[:, s * sb + (d + 1) * step: s * sb + (d + 1) * step + ov])).to(
            sfe.devices[d]) for d in range(sfe.n_dev)]
        for s in range(n_superblocks)]

    def run_ideal():
        t0 = time.perf_counter()
        for s in range(n_superblocks):
            placed = sfe.device_put(x[:, s * sb: (s + 1) * sb])
            for d in range(sfe.n_dev):
                col.set_halo(d, placed.blocks, halos[s][d])
            sfe._assemble(col.launch(placed.blocks),
                          slot_base=s * sfe.superblock_slots)
        return time.perf_counter() - t0

    def run_scan_1dev():
        t0 = time.perf_counter()
        g = col.compiled(0)
        for s in range(n_superblocks):
            xs = torch.from_numpy(np.ascontiguousarray(
                x[:, s * sb: (s + 1) * sb + ov])).to(dev0)
            # shard 0's graph, once per block; its outputs cloned, as the
            # next replay rewrites them
            outs = [[None if o is None else o.clone()
                     for o in g(xs[:, i * step: i * step + bs])]
                    for i in range(sfe.n_dev)]
            sfe._assemble(stack_outputs(outs, [dev0] * len(outs),
                                        [None] * len(outs)),
                          slot_base=s * sfe.superblock_slots)
        return time.perf_counter() - t0

    def run_sharded():
        t0 = time.perf_counter()
        for _ in sfe.stream(x[:, :n_superblocks * sb]):
            pass
        return time.perf_counter() - t0

    # warm every path, then INTERLEAVE the repeats, in turns forwards
    # and backwards (s, i, u, u, i, s, ...), so drift and each run's
    # neighbour hit all sides equally, and report medians with spread
    runs = {"s": run_sharded, "i": run_ideal, "u": run_scan_1dev}
    for f in runs.values():
        f()
    _sync(sfe.devices)
    times = {k: [] for k in runs}
    for r in range(max(repeats, 3)):
        for k in ("siu" if r % 2 == 0 else "uis"):
            times[k].append(runs[k]())
    ts_l, ti_l, tu_l = times["s"], times["i"], times["u"]
    ts, ti, tu = (float(np.median(v)) for v in (ts_l, ti_l, tu_l))

    def iqr(v):
        q25, q75 = np.percentile(v, [25, 75])
        return float(q75 - q25)
    halo_pairs = [a - b for a, b in zip(ts_l, ti_l)]
    # the spread of either side's times and of their paired differences
    jitter = max(iqr(ts_l), iqr(ti_l), iqr(halo_pairs))
    halo_cost = float(np.median(halo_pairs))
    total_samples = sb * n_superblocks
    sharded_sps = total_samples / ts
    ideal_sps = total_samples / ti
    scan_sps = total_samples / tu
    eff_pairs = sorted(b / a for a, b in zip(ts_l, ti_l))
    q25, q75 = np.percentile(eff_pairs, [25, 75])
    return {
        "n_devices": sfe.n_dev,
        "repeats": len(ts_l),
        "sharded_sps": sharded_sps,
        "ideal_sps": ideal_sps,
        "scan_1dev_sps": scan_sps,
        "efficiency": sharded_sps / ideal_sps,
        "efficiency_q25": float(q25),
        "efficiency_q75": float(q75),
        "efficiency_min": float(eff_pairs[0]),
        "efficiency_max": float(eff_pairs[-1]),
        "halo_cost_ms": halo_cost * 1e3,
        "timer_jitter_ms": jitter * 1e3,
        # halo bytes exchanged per superblock: one (2, overlap) float32
        # copy per shard
        "halo_bytes_per_superblock": 2 * ov * 4 * sfe.n_dev,
        "noise_floor": bool(abs(halo_cost) <= jitter),
        "speedup_vs_scan_1dev": sharded_sps / scan_sps,
    }
