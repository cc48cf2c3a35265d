"""Declarative block registry — the functional equivalent of the
reference's GRC descriptors (grc/*.xml, 7 files of *unfilled* template
stubs, e.g. grc/gr_bluetooth_multi_sniffer.xml).

Each descriptor names a composable unit, its parameters (name, type,
default), and a factory.  `describe()` emits the same information the GRC
XML would have carried (for tooling/docs); `build()` instantiates from a
plain config dict, and `build_flowgraph()` wires source -> mode -> writer
from one config — the programmatic counterpart of dropping blocks onto a
GRC canvas.

Example:
    fg = build_flowgraph({
        "source": {"block": "synthetic_source",
                   "n_slots": 256, "lap": 0x24D952},
        "mode":   {"block": "multi_sniffer", "sample_rate": 8e6,
                   "center_freq": 2.441e9},
        "writer": {"block": "pcap_writer", "path": "out.pcap"},
    })
    fg.run()

The port of gr_bluetooth_tpu/blocks.py, with the same registry keys.
Every mode factory passes the port's explicit `device` through (the
CUDA card unless another is named: a "device" entry of the mode's
config, or build_flowgraph's device argument); the Flowgraph records the
device its mode runs on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["BlockParam", "BlockDescriptor", "BLOCKS", "describe", "build",
           "build_flowgraph", "Flowgraph"]


@dataclass(frozen=True)
class BlockParam:
    name: str
    type: str
    default: object = None
    doc: str = ""


@dataclass(frozen=True)
class BlockDescriptor:
    key: str                  # registry key (reference GRC file analog)
    label: str
    category: str             # source / mode / writer
    params: tuple
    grc_analog: str           # the reference grc/*.xml it replaces
    make: object = field(compare=False, default=None)


def _mk_lap_survey(sample_rate, center_freq, squelch=10.0, device=None,
                   **kw):
    from .models.lap_survey import LapSurvey
    return LapSurvey(sample_rate, center_freq, squelch, device=device, **kw)


def _mk_uap(sample_rate, center_freq, lap, squelch=10.0, device=None, **kw):
    from .models.uap_discovery import UapDiscovery
    return UapDiscovery(sample_rate, center_freq, squelch, lap=lap,
                        device=device, **kw)


def _mk_hopper(sample_rate, center_freq, lap, squelch=10.0, aliased=False,
               writer=None, device=None, **kw):
    from .models.hopper import Hopper
    return Hopper(sample_rate, center_freq, squelch, lap=lap,
                  aliased=aliased, writer=writer, device=device, **kw)


def _mk_sniffer(sample_rate, center_freq, squelch=10.0, enable_le=True,
                writer=None, device=None, **kw):
    from .models.sniffer import Sniffer
    return Sniffer(sample_rate, center_freq, squelch, writer=writer,
                   enable_le=enable_le, device=device, **kw)


def _mk_file_source(path, shorts=False, nsamples=None):
    from .io.sources import load_file
    return lambda: load_file(path, shorts, nsamples)


def _mk_synth_source(n_slots, lap=0x24D952, uap=0x47, clk0=0,
                     sample_rate=8e6, center_freq=2.441e9, seed=7):
    from .testing import PiconetSim, make_piconet_capture

    def make():
        sim = PiconetSim(lap=lap, uap=uap, clk0=clk0)
        samples, _ = make_piconet_capture(sim, n_slots=n_slots,
                                          fs=sample_rate,
                                          center_freq=center_freq, seed=seed)
        return samples
    return make


def _mk_pcap(path):
    from .io.writers import PcapWriter
    return PcapWriter(path)


def _mk_tap(name="btbb"):
    from .io.writers import TapWriter
    return TapWriter(name)


_COMMON = (
    BlockParam("sample_rate", "float", None, "input rate, >= 2 Msps"),
    BlockParam("center_freq", "float", None, "tuner center frequency (Hz)"),
    BlockParam("squelch", "float", 10.0, "SNR squelch threshold (dB)"),
    BlockParam("device", "str", None,
               "torch device (default: the CUDA card)"),
)

BLOCKS: dict[str, BlockDescriptor] = {d.key: d for d in [
    BlockDescriptor(
        "multi_lap", "Bluetooth LAP survey", "mode", _COMMON,
        "grc/gr_bluetooth_multi_LAP.xml", _mk_lap_survey),
    BlockDescriptor(
        "multi_uap", "Bluetooth UAP discovery", "mode",
        _COMMON + (BlockParam("lap", "int", None, "target LAP"),),
        "grc/gr_bluetooth_multi_UAP.xml", _mk_uap),
    BlockDescriptor(
        "multi_hopper", "Bluetooth hopper (clock recovery + follow)", "mode",
        _COMMON + (BlockParam("lap", "int", None, "target LAP"),
                   BlockParam("aliased", "bool", False, "folded-band rx")),
        "grc/gr_bluetooth_multi_hopper.xml", _mk_hopper),
    BlockDescriptor(
        "multi_sniffer", "Bluetooth all-piconet sniffer", "mode",
        _COMMON + (BlockParam("enable_le", "bool", True, "LE detection"),),
        "grc/gr_bluetooth_multi_sniffer.xml", _mk_sniffer),
    BlockDescriptor(
        "file_source", "IQ file source (.cfile)", "source",
        (BlockParam("path", "str"), BlockParam("shorts", "bool", False),
         BlockParam("nsamples", "int", None)),
        "gnuradio blocks.file_source (apps/btrx:124-126)", _mk_file_source),
    BlockDescriptor(
        "synthetic_source", "Synthetic piconet capture", "source",
        (BlockParam("n_slots", "int"), BlockParam("lap", "int", 0x24D952),
         BlockParam("uap", "int", 0x47), BlockParam("clk0", "int", 0),
         BlockParam("sample_rate", "float", 8e6),
         BlockParam("center_freq", "float", 2.441e9)),
        "(new; replaces stripped samples/*.cfile)", _mk_synth_source),
    BlockDescriptor(
        "pcap_writer", "Wireshark pcap writer", "writer",
        (BlockParam("path", "str"),),
        "lib/tun.cc (offline equivalent)", _mk_pcap),
    BlockDescriptor(
        "tap_writer", "Live TAP interface 'btbb'", "writer",
        (BlockParam("name", "str", "btbb"),),
        "lib/tun.cc", _mk_tap),
]}


def describe(key: str) -> dict:
    d = BLOCKS[key]
    return {
        "key": d.key, "label": d.label, "category": d.category,
        "grc_analog": d.grc_analog,
        "params": [{"name": p.name, "type": p.type, "default": p.default,
                    "doc": p.doc} for p in d.params],
    }


def build(config: dict):
    cfg = dict(config)
    key = cfg.pop("block")
    d = BLOCKS[key]
    return d.make(**cfg)


@dataclass
class Flowgraph:
    source: object            # callable returning samples
    mode: object              # one of the four mode objects
    writer: object = None
    device: object = None     # the torch device the mode runs on

    def run(self, start_clkn: int = 0):
        samples = self.source()
        out = self.mode.run(samples, start_clkn)
        if self.writer is not None:
            self.writer.close()
        return out


def build_flowgraph(config: dict, device=None) -> Flowgraph:
    writer = build(config["writer"]) if config.get("writer") else None
    mode_cfg = dict(config["mode"])
    if device is not None:
        mode_cfg["device"] = device
    # only the decoding modes take a writer (multi_LAP/multi_UAP print only,
    # matching the reference's constructor signatures)
    if writer is not None and mode_cfg["block"] in ("multi_sniffer",
                                                    "multi_hopper"):
        mode_cfg["writer"] = writer
    mode = build(mode_cfg)
    source = build(config["source"])
    return Flowgraph(source=source, mode=mode, writer=writer,
                     device=mode.fe.device)
