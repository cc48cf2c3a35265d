"""btsurvey — standalone live LAP survey (the Kismet-plugin capability as
a CLI): capture -> tracker -> BTBBDEV TCP server and/or curses UI.

The port of gr_bluetooth_tpu/kismet/__main__.py: the same flags, output
and exit codes, plus --device as in the port's btrx.  It runs on the
CUDA card; with no card and no --device it exits 1.  torch's CPU thread
count follows OMP_NUM_THREADS when it is set.

    python -m gr_bluetooth_tpu_torch.kismet -r 8e6 -f 2.441e9 -i cap.cfile \
        --serve 127.0.0.1:2501
    python -m gr_bluetooth_tpu_torch.kismet -r 8e6 --synthetic 256 --table \
        --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

from .server import BtbbDevServer
from .source import KismetSource
from .tracker import TrackerBluetooth
from .ui import render


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="btsurvey", description=__doc__)
    p.add_argument("-r", "--sample-rate", type=float, required=True)
    p.add_argument("-f", "--freq", type=float, default=2.441e9)
    p.add_argument("-t", "--snr", type=float, default=10.0)
    p.add_argument("-i", "--input-file", default=None)
    p.add_argument("--synthetic", type=int, default=None, metavar="SLOTS")
    p.add_argument("--serve", default=None, metavar="HOST:PORT",
                   help="serve BTBBDEV records over TCP")
    p.add_argument("--table", action="store_true",
                   help="print the device table at exit")
    p.add_argument("--ui", action="store_true",
                   help="live curses UI (requires a tty)")
    p.add_argument("--sort", default="packets",
                   choices=["bdaddr", "firsttime", "lasttime", "packets"])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    threads = os.environ.get("OMP_NUM_THREADS")
    if threads:
        import torch
        torch.set_num_threads(int(threads))
    from ..utils.device import resolve_device
    try:
        device = resolve_device(opts.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    tracker = TrackerBluetooth()
    src = KismetSource(opts.sample_rate, opts.freq, opts.snr,
                       tracker=tracker, device=device)

    server = None
    if opts.serve:
        host, _, port = opts.serve.rpartition(":")
        server = BtbbDevServer(tracker, host or "127.0.0.1", int(port))
        print(f"serving BTBBDEV on {server.address[0]}:{server.address[1]}",
              file=sys.stderr)

    if opts.synthetic is not None:
        from ..testing import PiconetSim, make_piconet_capture
        sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
        samples, _ = make_piconet_capture(
            sim, n_slots=opts.synthetic, fs=opts.sample_rate,
            center_freq=opts.freq, seed=7)
    elif opts.input_file:
        from ..io.sources import load_file
        samples = load_file(opts.input_file, False, None)
    else:
        print("need -i FILE or --synthetic SLOTS", file=sys.stderr)
        return 1

    n = src.run(samples)
    if server is not None:
        server.tick()
    print(f"{n} frames, {len(tracker.tracked_nets)} tracked networks",
          file=sys.stderr)
    if opts.table:
        print(render(tracker, sort=opts.sort))
    if opts.ui:
        from .ui import run_curses
        run_curses(tracker)
    if server is not None:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
