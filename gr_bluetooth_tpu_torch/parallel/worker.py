"""One process of a multi-process time-sharded stream, and a launcher
for several.

Each process joins a torch.distributed process group (the backend is a
flag: gloo, or nccl with one card per process), holds `--shards` shards
on `--device`, and streams a capture through ShardedFrontEnd with its
contiguous part of each superblock; process 0 writes the assembled hits
as JSON:

    python -m gr_bluetooth_tpu_torch.parallel.worker --rank 0 --world 2 \\
        --init tcp://localhost:29500 --backend gloo --device cpu \\
        --shards 2 --rate 4e6 --block-slots 8 --capture cap.npy \\
        --out hits.json

The capture is a (2, N) float32 .npy file of IQ planes, read by every
process.  launch() starts the processes and waits for them, each with a
time limit.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["hit_keys", "launch", "main"]


def hit_keys(results):
    """(classic, LE) hit keys of BlockResults, in order:
    [channel, clkn, sym_offset, lap, errors] and
    [channel, index, clkn, sym_offset, distance]."""
    classic = [[h.channel, h.clkn, h.sym_offset, h.lap, h.errors]
               for r in results for h in r.hits]
    le = [[h.channel, h.index, h.clkn, h.sym_offset, h.distance]
          for r in results for h in r.le_hits]
    return classic, le


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sharded-worker",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True,
                   help="init method, e.g. tcp://localhost:PORT")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", required=True,
                   help="this process's device; {rank} is replaced by "
                        "its rank (cuda:{rank}: a card per process)")
    p.add_argument("--shards", type=int, required=True,
                   help="shards of this process, all on --device")
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--freq", type=float, default=2441e6)
    p.add_argument("--block-slots", type=int, required=True)
    p.add_argument("--max-ac-errors", type=int, default=6)
    p.add_argument("--le", action="store_true", help="enable LE")
    p.add_argument("--capture", required=True)
    p.add_argument("--out", required=True)
    return p


def main(argv=None) -> int:
    import torch.distributed as dist

    from ..models.frontend import FrontEnd
    from .sharded import ShardedFrontEnd

    a = build_parser().parse_args(argv)
    threads = os.environ.get("OMP_NUM_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    device = torch.device(a.device.format(rank=a.rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(a.backend, init_method=a.init,
                            world_size=a.world, rank=a.rank)
    try:
        fe = FrontEnd(a.rate, a.freq, block_slots=a.block_slots,
                      max_ac_errors=a.max_ac_errors, enable_le=a.le,
                      device=device)
        sfe = ShardedFrontEnd(fe, [device] * a.shards,
                              process_group=dist.group.WORLD)
        x = np.load(a.capture, mmap_mode="r")
        t0 = time.perf_counter()
        results = sfe.process(x)
        dt = time.perf_counter() - t0
        if a.rank == 0:
            classic, le = hit_keys(results)
            with open(a.out, "w") as f:
                json.dump({"hits": classic, "le_hits": le,
                           "blocks": len(results), "seconds": dt,
                           "backend": dist.get_backend()}, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n_procs: int, capture: str, *, rate: float, block_slots: int,
           shards: int, device: str, backend: str = "gloo",
           freq: float = 2441e6, enable_le: bool = False,
           max_ac_errors: int = 6, timeout: float = 600.0,
           env: dict | None = None) -> dict:
    """Run n_procs worker processes on the capture (.npy planes) under a
    process group on a free localhost port; returns process 0's JSON.
    Raises if a process fails, and kills them all if they outlast
    `timeout` seconds."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "hits.json")
        base = [sys.executable, "-m", "gr_bluetooth_tpu_torch.parallel.worker",
                "--world", str(n_procs),
                "--init", f"tcp://localhost:{_free_port()}",
                "--backend", backend, "--device", device,
                "--shards", str(shards), "--rate", str(rate),
                "--freq", str(freq), "--block-slots", str(block_slots),
                "--max-ac-errors", str(max_ac_errors),
                "--capture", capture, "--out", out]
        if enable_le:
            base.append("--le")
        procs, logs, timed_out = [], [], False
        try:
            for r in range(n_procs):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    base + ["--rank", str(r)], stdout=log,
                    stderr=subprocess.STDOUT, env=env, cwd=root))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"rank {r}: {log.read()[-3000:]}")
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if timed_out or bad:
            why = (f"outlasted {timeout} s" if timed_out
                   else f"{bad} failed")
            raise RuntimeError(f"sharded workers {why}:\n" +
                               "\n".join(tails))
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    raise SystemExit(main())
