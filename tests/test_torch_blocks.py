"""The port's block registry (blocks.py) against the JAX package's:
tests/test_blocks.py's five cases through the port on the CPU, the
registry keys equal to the JAX package's, and the same flowgraph giving
the same observations in both packages."""
import os

import pytest

from gr_bluetooth_tpu import blocks as jblocks
from gr_bluetooth_tpu_torch import blocks
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_registry_covers_reference_blocks():
    assert list(blocks.BLOCKS) == list(jblocks.BLOCKS)
    for key, d in blocks.BLOCKS.items():
        j = jblocks.BLOCKS[key]
        assert (d.label, d.category, d.grc_analog) == \
            (j.label, j.category, j.grc_analog)
    analogs = {d.grc_analog for d in blocks.BLOCKS.values()}
    for xml in ["grc/gr_bluetooth_multi_LAP.xml",
                "grc/gr_bluetooth_multi_UAP.xml",
                "grc/gr_bluetooth_multi_hopper.xml",
                "grc/gr_bluetooth_multi_sniffer.xml"]:
        assert xml in analogs, xml


def test_describe_shape():
    d = blocks.describe("multi_sniffer")
    assert d["category"] == "mode"
    names = {p["name"] for p in d["params"]}
    assert {"sample_rate", "center_freq", "squelch", "enable_le",
            "device"} <= names
    # the JAX package's parameters, plus the port's device
    jnames = {p["name"] for p in jblocks.describe("multi_sniffer")["params"]}
    assert names == jnames | {"device"}


def test_build_flowgraph_end_to_end():
    cfg = {
        "source": {"block": "synthetic_source", "n_slots": 96,
                   "lap": 0x24D952, "uap": 0x47, "clk0": 0x12780,
                   "sample_rate": 8e6, "center_freq": 2.441e9},
        "mode": {"block": "multi_lap", "sample_rate": 8e6,
                 "center_freq": 2.441e9},
    }
    fg = blocks.build_flowgraph(cfg, device="cpu")
    assert fg.device.type == "cpu" and fg.mode.fe.device.type == "cpu"
    obs = fg.run()
    assert {o.lap for o in obs} == {0x24D952}
    want = jblocks.build_flowgraph(cfg).run()
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in obs] == [key(o) for o in want]


def test_build_flowgraph_writer_wiring(tmp_path):
    path = str(tmp_path / "o.pcap")
    fg = blocks.build_flowgraph({
        "source": {"block": "synthetic_source", "n_slots": 64,
                   "sample_rate": 8e6, "center_freq": 2.441e9},
        "mode": {"block": "multi_sniffer", "sample_rate": 8e6,
                 "center_freq": 2.441e9, "enable_le": False,
                 "device": "cpu"},
        "writer": {"block": "pcap_writer", "path": path},
    })
    assert fg.mode.writer is fg.writer
    assert fg.device.type == "cpu"
    fg.run()
    assert os.path.getsize(path) >= 24   # header written + closed cleanly


def test_unknown_block_raises():
    with pytest.raises(KeyError):
        blocks.build({"block": "nope"})
