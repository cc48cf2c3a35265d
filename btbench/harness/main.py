"""One run of one cell: set-up, the measured window, the correctness
check against the plain reference, and the result line.

    python3 btbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration, its traffic mix, its metrics and the
limits of its check are found by name (harness/spec.py).  With
--trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read under the profiler.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import spec as specs
from .check import Collector, compare, verdict
from .drive import drive, drive_sharded

__all__ = ["main", "run_cell", "FORBIDDEN", "forbidden_modules"]

# top-level module names a run may not hold: JAX, and the JAX package
# (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "gr_bluetooth_tpu")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(prog="btbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_process=None) -> int:
    a = _parse(argv)
    sp = specs.load_spec(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < sp.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"btbench: {a.workload} needs {sp.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 3
    out, report = run_cell(sp, a.seed, a.seconds, bool(a.trace),
                           device="cuda", t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"btbench: the run imported {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for line in report:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


def _devices(sp, device):
    import torch
    if torch.device(device).type != "cuda":
        return [torch.device(device)] * sp.chips
    return [torch.device("cuda", i) for i in range(sp.chips)]


class _Sniffing:
    """The sniffer cells: wire chunks through the ingest into
    Sniffer.run_blocks (btrx -S once its source has bytes)."""

    def __init__(self, sp, tr, p, device):
        from gr_bluetooth_tpu_torch.io.ingest import PipelinedIngest
        from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
        c = sp.config
        self.mode = Sniffer(c["sample_rate"], c["center_freq"],
                            squelch_threshold=c["squelch_db"],
                            enable_le=c["enable_le"],
                            block_slots=c["block_slots"], device=device)
        self.ingest = PipelinedIngest(self.mode.fe, c["wire"])
        self.tr, self.p = tr, p

    def warm(self, n_blocks):
        p = self.p
        self.mode.run_blocks(self.ingest.run(
            (p.chunks[j % p.n_blocks] for j in range(n_blocks)), 0,
            initial_carry=p.carry))
        self.mode.decoded.clear()
        self.mode.le_packets.clear()

    def window(self, seconds, start_clkn, **kw):
        tr, p = self.tr, self.p
        # open loop: one block due per block of air
        period_s = self.mode.fe.block_slots * 625e-6
        return drive(self.mode, self.ingest, p.chunks, p.carry,
                     loop=tr.loop, seconds=seconds, period_s=period_s,
                     start_clkn=start_clkn, **kw)


class _Surveying:
    """The survey cells: superblocks of float32 planes through a
    ShardedFrontEnd, one time shard per card, into LapSurvey.run_blocks
    (btrx with no -l over long captures, README's sharded front end)."""

    def __init__(self, sp, tr, p, device):
        from gr_bluetooth_tpu_torch.models.lap_survey import LapSurvey
        from gr_bluetooth_tpu_torch.parallel.sharded import ShardedFrontEnd
        c = sp.config
        devs = _devices(sp, device)
        self.mode = LapSurvey(c["sample_rate"], c["center_freq"],
                              squelch_threshold=c["squelch_db"],
                              max_ac_errors=tr.params["max_ac_errors"],
                              block_slots=c["block_slots"],
                              enable_le=tr.params["enable_le"],
                              device=devs[0])
        self.sharded = ShardedFrontEnd(self.mode.fe, devs)
        st, ov = self.sharded.total_samples, self.sharded.overlap_samples
        n = p.planes.shape[1]
        if n % st:
            raise ValueError("the pass is not whole superblocks")
        cyc = np.concatenate([p.planes, p.planes[:, :ov]], 1)
        self.superblocks = [(np.ascontiguousarray(cyc[:, i:i + st]),
                             np.ascontiguousarray(cyc[:, i + st:i + st + ov]))
                            for i in range(0, n, st)]

    def run_blocks(self, results):
        return self.mode.run_blocks(results, emit_console=False)

    def warm(self, n_blocks):
        sf = self.sharded
        base = 0
        for i in range(-(-n_blocks // sf.n_dev)):
            chunk, head = self.superblocks[i % len(self.superblocks)]
            out = sf.gather(sf.step(sf.device_put(chunk), head))
            self.run_blocks(sf._assemble(out, base))
            base += sf.superblock_slots
        self.mode.observations.clear()

    def window(self, seconds, start_clkn, **kw):
        return drive_sharded(self.run_blocks, self.sharded, self.superblocks,
                             seconds=seconds, start_clkn=start_clkn, **kw)


MODES = {"sniffer": _Sniffing, "survey": _Surveying}


def run_cell(sp, seed: int, seconds: float, trace: bool, device="cuda",
             t_process=None) -> tuple:
    """Set up the cell, measure one window, check it.  Returns the result
    line's object and the report for standard error: the set-up's
    phases, the window's per-block stages, the first faults found and,
    last, each compared number beside its limit."""
    import torch

    from gr_bluetooth_tpu_torch.utils.metrics import metrics
    from ..reference.frontend import RefFrontEnd
    from ..traffic.generator import block_planes, load_traffic, make_pass
    from . import costs
    from .trace import Tracer, reduce_events

    t_process = time.perf_counter() if t_process is None else t_process
    marks = [("imports", time.perf_counter())]
    cfg = sp.config
    tr = load_traffic(sp.traffic_path)
    cuda = torch.device(device).type == "cuda"
    settings = dict(max_ac_errors=tr.params.get("max_ac_errors",
                                                cfg["max_ac_errors"]),
                    enable_le=tr.params.get("enable_le", cfg["enable_le"]))
    ref = RefFrontEnd(cfg["sample_rate"], cfg["center_freq"],
                      squelch_db=cfg["squelch_db"],
                      block_slots=cfg["block_slots"], device="cpu",
                      **settings)

    # set-up: the pass from the seed, the mode over its front end; whole
    # passes of warm-up build the compiled steps and let the sniffer
    # learn every piconet's UAP and CLK1-6
    if cuda:
        # the kernels' build cache in the checkout (nvcc on a first run)
        from gr_bluetooth_tpu_torch.utils import cuda_build
        cuda_build.build_all()
    marks.append(("build_cache", time.perf_counter()))
    p = make_pass(tr, cfg, seed, step_samples=ref.step_samples,
                  overlap_samples=ref.overlap_samples,
                  samples_per_slot=ref.samples_per_slot,
                  block_slots=ref.block_slots)
    marks.append(("synthesis", time.perf_counter()))
    cell = MODES[tr.mode](sp, tr, p, device)
    marks.append(("mode", time.perf_counter()))
    # the harness is the mode's sink: no log line per packet or hit
    logging.getLogger("grbt").setLevel(logging.WARNING)
    n_warm = tr.warmup_passes * p.n_blocks
    cell.warm(n_warm)
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    metrics.reset()

    col = Collector(p.n_blocks, ref.block_slots, cell.mode)
    tracer = Tracer(cuda) if trace else None
    with tracer if tracer is not None else contextlib.nullcontext():
        w = cell.window(seconds, n_warm * ref.block_slots,
                        on_result=col.on_result, on_done=col.on_done,
                        span=tracer.span if tracer is not None else
                        (lambda name: contextlib.nullcontext()))
        if cuda:
            torch.cuda.synchronize()
    gc.unfreeze()
    setup_s = w.t0 - t_process
    marks.append(("warm_up", w.t0))
    stages = {k: (v.calls, v.total_s) for k, v in metrics.stages.items()}
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in _devices(sp, device)) if cuda else 0
    tr_read = None
    if tracer is not None:
        tr_read = reduce_events(tracer.events(), sp.chips)
        tracer = None

    # the program's state goes before the reference runs, on the card
    col.mode = None
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = RefFrontEnd(cfg["sample_rate"], cfg["center_freq"],
                      squelch_db=cfg["squelch_db"],
                      block_slots=cfg["block_slots"], device=device,
                      **settings)
    ref_blocks = []
    for k in range(p.n_blocks):
        snr, tab, n_hits, le_tab, n_le = ref.step(
            block_planes(p, k, ref.step_samples, ref.overlap_samples))
        classic, le = ref.hits(tab, n_hits, le_tab, n_le)
        ref_blocks.append((np.asarray(snr, np.float64), classic, le))
    numbers = compare(col, ref_blocks, ref, p.truth)
    numbers["unfinished"] = len(w.handed) - len(w.done)
    correct, rows = verdict(numbers, sp.limits)

    run = SimpleNamespace(
        spec=sp, config=cfg, traffic=tr, window=w, stages=stages,
        trace=tr_read, setup_s=setup_s, step_samples=ref.step_samples,
        k1=costs.k1_work(ref), kernel_patterns=specs.kernel_patterns)
    wanted = sp.per_layer if trace else sp.end_to_end
    values = {}
    for m in wanted:
        v = specs.load_reader(m["name"], sp.bench_dir)(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else device,
               kind=torch.cuda.get_device_name(0) if cuda else device,
               count=sp.chips, memory_peak_bytes=int(peak))
    if tr_read is not None:
        dev.update(busy_s=tr_read["busy_s"], window_s=tr_read["window_s"])
    out = dict(correct=bool(correct),
               attempted=len(w.handed),
               failed=min(len(w.handed),
                          numbers["unfinished"] + numbers["bad_blocks"]),
               metrics=values, device=dev)
    if tr_read is not None:
        out["breakdown"] = dict(device_ops=tr_read["device_ops"],
                                idle_gaps=tr_read["idle_gaps"])
    out["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    prev, parts = t_process, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    nb = max(len(w.done), 1)

    def per_block(stage):
        return stages.get(stage, (0, 0.0))[1] / nb * 1e3

    mode_ms = sum(d - y for d, y in zip(w.done, w.yielded)) / nb * 1e3
    report = [
        f"setup {setup_s:.3f} s: " + ", ".join(parts),
        f"window {w.seconds:.3f} s, {len(w.done)} blocks; per block: h2d "
        f"{per_block('h2d'):.3f} ms, device_step "
        f"{per_block('device_step'):.3f} ms, assemble "
        f"{per_block('assemble'):.3f} ms, mode {mode_ms:.3f} ms, hits "
        f"{sum(w.hits) / nb:.1f}"]
    report += [f"fault {n}" for n in numbers["notes"]]
    report += [f"check {n} {v!r} limit {lim!r}" for n, v, lim in rows]
    return out, report
