"""btrx — Bluetooth baseband receiver CLI (parity with apps/btrx:16-166).

The port of gr_bluetooth_tpu/apps/btrx.py: the same flags, defaults,
messages and exit codes, run as

    python -m gr_bluetooth_tpu_torch.apps.btrx -r RATE ...

It runs on the CUDA card; --device names another torch device (`cpu`
runs the plain PyTorch versions of the kernels).  With no card and no
--device it exits non-zero and never carries on on the CPU.  torch's
CPU thread count follows OMP_NUM_THREADS when it is set.

Mode dispatch mirrors the reference exactly (apps/btrx:140-158):
    -S               all-piconet sniffer        (multi_sniffer)
    (no -l)          LAP survey                 (multi_LAP)
    -l LAP -p        clock recovery + hopping   (multi_hopper)
    -l LAP           UAP discovery              (multi_UAP)

Sources: -i FILE (.cfile complex64), -i - (stdin stream), -s interleaved
shorts, or --synthetic N (synthesize an N-slot piconet-consistent capture
— the replacement for the reference's stripped samples/*.cfile).  SDR
hardware sources (osmosdr) are out of scope; captures and pipes are the
replayable path (doc/README.first:39-67).

Output: console log lines; -w TAP interface "btbb" for live Wireshark
(degrades to console-only like multi_sniffer_impl.cc:66-71); -W FILE.pcap
portable offline equivalent.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="btrx", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-f", "--freq", type=float, default=2.476e9,
                   help="center frequency in Hz (default 2.476e9)")
    p.add_argument("-r", "--sample-rate", type=float, required=True,
                   help="sample rate of input in Hz (>= 2e6)")
    p.add_argument("-N", "--nsamples", type=float, default=None,
                   help="number of samples to process (default: all)")
    p.add_argument("-S", "--sniff", action="store_true",
                   help="all-piconet sniffer")
    p.add_argument("--aliased", action="store_true",
                   help="aliased (folded-band) receiver implementation")
    p.add_argument("-i", "--input-file", default=None,
                   help="input capture file; '-' for stdin")
    p.add_argument("-l", "--lap", default=None,
                   help="LAP of the master device (hex)")
    p.add_argument("-p", "--hop", action="store_true",
                   help="reverse hopping sequence to determine master clock")
    p.add_argument("-s", "--input-shorts", action="store_true",
                   help="input interleaved shorts instead of complex floats")
    p.add_argument("-8", "--input-bytes", action="store_true",
                   help="input interleaved int8 IQ (quarter the wire "
                        "bandwidth of complex floats; the on-the-wire "
                        "analog of the reference's aliasing fidelity/"
                        "coverage trade, doc/README.aliasing)")
    p.add_argument("--u8", "--rtlsdr", dest="input_u8", action="store_true",
                   help="input rtl_sdr-style UNSIGNED offset bytes "
                        "(x = (b - 127.5)/127.5) — pipe `rtl_sdr -f FREQ "
                        "-s RATE -` straight in (doc/sdr_pipeline.md)")
    p.add_argument("-4", "--input-nibbles", dest="input_i4",
                   action="store_true",
                   help="input int4-packed IQ (one byte per complex "
                        "sample, I nibble low) — the full-band wire "
                        "format for a bandwidth-starved host link; "
                        "stdin/--live only")
    p.add_argument("-t", "--snr", type=float, default=10.0,
                   help="SNR squelch threshold in dB (default 10.0)")
    p.add_argument("-w", "--wireshark", action="store_true",
                   help="direct output to the 'btbb' TAP interface")
    p.add_argument("-W", "--pcap", default=None,
                   help="write decoded packets to a pcap file")
    p.add_argument("--synthetic", type=int, default=None, metavar="SLOTS",
                   help="synthesize a SLOTS-slot test capture")
    p.add_argument("--synthetic-lap", default="24d952")
    p.add_argument("--synthetic-uap", default="47")
    p.add_argument("--synthetic-clk0", default="12780")
    p.add_argument("--block-slots", type=int, default=16,
                   help="slots per device block (default 16)")
    p.add_argument("--stats", action="store_true",
                   help="print counters and per-stage timings at exit")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (trace.json) to DIR")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="save piconet state + stream cursor at exit "
                        "(sniffer mode)")
    p.add_argument("--resume", default=None, metavar="FILE.npz",
                   help="restore piconet state from a checkpoint before "
                        "processing (sniffer mode)")
    p.add_argument("--no-le", action="store_true",
                   help="disable the LE detection path in sniffer mode")
    p.add_argument("--live", action="store_true",
                   help="treat stdin as a live stream: when processing "
                        "falls behind, drop the OLDEST samples (bounded "
                        "memory) and count overruns — the stand-in for a "
                        "live SDR source (apps/btrx:88-120)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")
    return p


def make_writer(opts):
    if opts.wireshark:
        from ..io.writers import TapWriter
        try:
            return TapWriter("btbb")
        except Exception as e:  # degrade like multi_sniffer_impl.cc:66-71
            print(f"could not open TAP interface ({e}); "
                  "output to console only", file=sys.stderr)
    if opts.pcap:
        from ..io.writers import PcapWriter
        return PcapWriter(opts.pcap)
    return None


def make_mode(opts, writer, device):
    rate, freq, snr = opts.sample_rate, opts.freq, opts.snr
    kw = dict(block_slots=opts.block_slots, device=device)
    if opts.sniff:
        from ..models.sniffer import Sniffer
        return Sniffer(rate, freq, snr, writer=writer,
                       enable_le=not opts.no_le, **kw)
    if opts.lap is None:
        from ..models.lap_survey import LapSurvey
        return LapSurvey(rate, freq, snr, **kw)
    lap = int(opts.lap, 16)
    if opts.hop:
        from ..models.hopper import Hopper
        return Hopper(rate, freq, snr, lap=lap, aliased=opts.aliased,
                      writer=writer, **kw)
    from ..models.uap_discovery import UapDiscovery
    return UapDiscovery(rate, freq, snr, lap=lap, **kw)


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    if opts.sample_rate < 2e6:
        print(f"Sample rate ({opts.sample_rate:.0f}) below minimum "
              "(2000000)", file=sys.stderr)           # apps/btrx:66-78
        return 1
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

    writer = make_writer(opts)
    mode = make_mode(opts, writer, device)

    start_clkn = 0
    if opts.resume:
        if not hasattr(mode, "restore_state"):
            print("--resume requires sniffer mode (-S)", file=sys.stderr)
            return 1
        start_clkn = mode.restore_state(opts.resume)
        print(f"resumed from {opts.resume} at clkn {start_clkn}",
              file=sys.stderr)

    from ..utils.metrics import metrics, profile
    with profile(opts.profile):
        rc = _run_source(opts, mode, start_clkn)
    if rc != 0:
        return rc

    if opts.checkpoint:
        if not hasattr(mode, "save_state"):
            print("--checkpoint requires sniffer mode (-S)", file=sys.stderr)
        else:
            mode.save_state(opts.checkpoint)
            print(f"checkpointed to {opts.checkpoint} at clkn {mode.cursor}",
                  file=sys.stderr)
    if opts.stats:
        print(metrics.report(), file=sys.stderr)

    if writer is not None:
        writer.close()
        print(f"wrote {writer.n_written} frames", file=sys.stderr)
    return 0


def _run_source(opts, mode, start_clkn: int) -> int:
    nsamples = int(opts.nsamples) if opts.nsamples else None
    if opts.synthetic is not None:
        from ..testing import PiconetSim, make_piconet_capture
        sim = PiconetSim(lap=int(opts.synthetic_lap, 16),
                         uap=int(opts.synthetic_uap, 16),
                         clk0=int(opts.synthetic_clk0, 16))
        samples, sent = make_piconet_capture(
            sim, n_slots=opts.synthetic, fs=opts.sample_rate,
            center_freq=opts.freq, seed=7)
        mode.run(samples[:nsamples] if nsamples else samples,
                 start_clkn=start_clkn)
    elif opts.input_file is None:
        print("no input: use -i FILE, -i -, or --synthetic SLOTS",
              file=sys.stderr)
        return 1
    elif opts.input_file == "-":
        # production ingest: raw wire chunks, device-side conversion +
        # overlap-save carry, double-buffered H2D (io/ingest.py); clkn
        # stays locked to air time across live overruns (clock slips)
        fe = mode.fe
        if fe.resampler is not None:
            # the wire chunk loop runs at the bank's internal rate; the
            # host resampler only fronts the file/array paths today
            print(f"error: stdin/live input at off-grid rate "
                  f"{fe.input_rate/1e6:g} Msps is not supported — use a "
                  f"capture file, or an integer-Msps radio rate",
                  file=sys.stderr)
            return 2
        wire = ("i4" if getattr(opts, "input_i4", False) else
                "u8" if getattr(opts, "input_u8", False) else
                "i8" if opts.input_bytes else
                "i16" if opts.input_shorts else "f32")
        from ..io.ingest import PipelinedIngest, live_chunks
        ingest = PipelinedIngest(fe, wire)
        if opts.live:
            from ..io.sources import LiveSource
            source = LiveSource(sys.stdin.fileno(), fe.step_samples,
                                wire=wire)
            chunks = live_chunks(source, fe.samples_per_slot)
        else:
            from ..io.sources import stream_stdin_raw
            source = None
            chunks = stream_stdin_raw(fe.step_samples, wire, nsamples)
        try:
            mode.run_blocks(ingest.run(chunks, start_clkn,
                                       bus=getattr(mode, "bus", None)))
        finally:
            if opts.live:
                if source.overruns:
                    print(f"live source: {source.overruns} overruns, "
                          f"{source.dropped_bytes} bytes dropped",
                          file=sys.stderr)
                source.close()
    else:
        from ..io.sources import load_file
        if getattr(opts, "input_u8", False):
            # replayed rtl_sdr recording: same offset-byte conversion as
            # the stdin path, via numpy (files are not the hot path)
            from ..io.ingest import wire_decode_np
            raw = np.fromfile(opts.input_file, dtype=np.uint8)
            raw = raw[: (len(raw) // 2) * 2]   # drop a torn final sample
            if nsamples:
                raw = raw[: 2 * nsamples]
            x = wire_decode_np(raw.reshape(-1, 2), "u8")
        else:
            x = load_file(opts.input_file, opts.input_shorts, nsamples,
                          opts.input_bytes)
        mode.run(x, start_clkn=start_clkn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
