"""The port's spans (utils/metrics.py): a stage's self time, the
profiler range it opens only while a profiler records, and the spans
that PipelinedIngest and Sniffer.run_blocks open per block, in the
profiler's own trace and in btrx --profile's trace.json."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.apps import btrx
from gr_bluetooth_tpu_torch.io.ingest import PipelinedIngest, wire_chunks
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.utils import metrics as metrics_mod
from gr_bluetooth_tpu_torch.utils.log import EventBus
from gr_bluetooth_tpu_torch.utils.metrics import SPANS, Metrics, metrics
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

INGEST = ("h2d", "ingest.slot_wait", "ingest.stage", "device_step",
          "assemble", "ingest.result_wait")
SNIFFER = ("sniffer.block", "sniffer.precompute", "sniffer.classic",
           "sniffer.le")
PARENT = {"ingest.slot_wait": ("h2d",), "ingest.stage": ("h2d",),
          "ingest.result_wait": ("assemble",),
          "sniffer.precompute": ("sniffer.block",),
          "sniffer.classic": ("sniffer.block",),
          "sniffer.le": ("sniffer.block",),
          "sniffer.batch_decode": ("sniffer.precompute", "sniffer.classic")}


def test_self_time_leaves_out_the_children():
    m = Metrics()
    for _ in range(2):
        with m.stage("a"):
            time.sleep(0.002)
            with m.stage("b"):
                time.sleep(0.003)
                with m.stage("c"):
                    time.sleep(0.001)
    a, b, c = (m.stages[k] for k in "abc")
    assert (a.calls, b.calls, c.calls) == (2, 2, 2)
    assert a.total_s >= 0.012 and b.total_s >= 0.008 and c.total_s >= 0.002
    assert a.self_s == pytest.approx(a.total_s - b.total_s, abs=1e-9)
    assert b.self_s == pytest.approx(b.total_s - c.total_s, abs=1e-9)
    assert c.self_s == c.total_s
    assert a.mean_s == a.total_s / 2
    snap = m.snapshot()["stages"]["b"]
    assert set(snap) == {"calls", "total_s", "mean_s", "self_s"}
    assert snap["calls"] == 2
    # a stage left by an exception still counts, and the stack unwinds
    with pytest.raises(ValueError):
        with m.stage("a"):
            raise ValueError
    assert m.stages["a"].calls == 3 and m._open.stack == []
    assert m.spans == []
    m.reset()
    assert not m.stages and not m.counters


def test_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    built = []
    real = metrics_mod._range

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(metrics_mod, "_range", counting)
    m = Metrics()
    for _ in range(3):
        with m.stage("h2d"):
            with m.stage("ingest.stage"):
                pass
    assert built == [] and m.spans == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.stage("h2d"):
            with m.stage("ingest.stage"):
                pass
    assert built == ["h2d", "ingest.stage"]
    assert [s[0] for s in m.spans] == ["ingest.stage", "h2d"]
    (_, c0, c1), (_, p0, p1) = m.spans
    assert p0 <= c0 <= c1 <= p1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("h2d") == 1 and names.count("ingest.stage") == 1
    assert m.stages["h2d"].calls == 4


def _inside(child, parents):
    s, e = child
    return any(a <= s and e <= b for a, b in parents)


def test_ingest_and_sniffer_spans_per_block_in_the_profiler_trace():
    sim = testing.PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, _ = testing.make_piconet_capture(sim, n_slots=256, fs=8e6,
                                        center_freq=2441e6, seed=7)
    sn = Sniffer(8e6, 2441e6, device="cpu", bus=EventBus(), block_slots=32)
    ingest = PipelinedIngest(sn.fe, "f32")
    carry, chunks = wire_chunks(x, sn.fe, "f32")
    chunks = list(chunks)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sn.run_blocks(ingest.run(iter(chunks), 0, initial_carry=carry))
    n = len(chunks)
    assert n >= 6 and sn.decoded
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPANS:
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in INGEST + SNIFFER:
        assert len(spans[name]) == n, name
    assert 1 <= len(spans["sniffer.batch_decode"]) <= 2 * n
    assert metrics.counters["sniffer.batch_rows"] >= \
        len(spans["sniffer.batch_decode"])
    for name, iv in spans.items():
        iv.sort()
        assert metrics.stages[name].calls == len(iv), name
        for child in iv:
            if name in PARENT:
                assert _inside(child, [p for k in PARENT[name]
                                       for p in spans[k]]), name
    # one block after another: the j-th h2d starts before the j-th
    # assemble, which ends before the j-th sniffer.block starts
    for j in range(n):
        assert spans["h2d"][j][0] < spans["assemble"][j][0]
        assert spans["assemble"][j][1] <= spans["sniffer.block"][j][0]
        if j:
            assert spans["sniffer.block"][j - 1][1] <= \
                spans["assemble"][j][0]
    # every stage the run opened is a registered name, and the spans log
    # holds each once per call, in the order they closed
    assert set(metrics.stages) <= set(SPANS)
    assert sorted(s[0] for s in metrics.spans) == sorted(
        name for name, iv in spans.items() for _ in iv)
    h2d_log = [s for s in metrics.spans if s[0] == "h2d"]
    assert all(a[2] <= b[1] for a, b in zip(h2d_log, h2d_log[1:]))
    metrics.reset()


def test_btrx_profile_trace_holds_the_program_spans(tmp_path, capsys):
    rc = btrx.main(["-S", "-r", "8e6", "-f", "2441e6", "--synthetic", "128",
                    "--device", "cpu", "--profile", str(tmp_path)])
    assert rc == 0
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"h2d", "ingest.stage", "assemble", "sniffer.block",
            "sniffer.classic"} <= names
    assert not torch.autograd._profiler_enabled()
