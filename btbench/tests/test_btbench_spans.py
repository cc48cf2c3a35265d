"""The program's spans as the benchmark reads them: the readers of the
sniffer's and the ingest's spans and counters, reckoned by hand, None
where a program lacks them, and a traced run that reads them; the
program's spans leave the device reading of a trace as it was."""
import json
from types import SimpleNamespace

import pytest
import torch

from btbench.harness.main import run_cell
from btbench.harness.spec import load_reader
from btbench.harness.trace import Tracer, reduce_events
from gr_bluetooth_tpu_torch.utils import metrics as metrics_mod
from gr_bluetooth_tpu_torch.utils.metrics import SPANS, metrics
from small_cell import add_live_cell, small_copy, spec

MAXRATE = ("sniffer.precompute_ms", "sniffer.batch_us_per_row",
           "sniffer.classic_us_per_hit", "ingest.stage_ms",
           "ingest.device_wait_ms", "ingest.launch_ms")
NEW = MAXRATE + ("ingest.hold_ms_p95.live",)


@pytest.fixture
def program():
    """The port's process-global Metrics, empty before and after."""
    metrics.reset()
    yield metrics
    metrics.reset()


def _stage(m, name, calls, total_s, self_s=None):
    s = m.stages[name]
    s.calls, s.total_s = calls, total_s
    s.self_s = total_s if self_s is None else self_s


def _run(m, loop="closed"):
    return SimpleNamespace(
        stages={k: (v.calls, v.total_s) for k, v in m.stages.items()},
        window=SimpleNamespace(loop=loop))


def test_each_reader_gives_the_value_reckoned_by_hand(program):
    _stage(program, "sniffer.precompute", 4, 0.010, 0.006)
    _stage(program, "sniffer.batch_decode", 5, 0.003)
    _stage(program, "sniffer.classic", 4, 0.020, 0.018)
    _stage(program, "h2d", 4, 0.012, 0.001)
    _stage(program, "ingest.slot_wait", 4, 0.002)
    _stage(program, "ingest.stage", 4, 0.009)
    _stage(program, "device_step", 4, 0.0016)
    _stage(program, "assemble", 4, 0.004, 0.003)
    _stage(program, "ingest.result_wait", 4, 0.001)
    program.count("sniffer.batch_rows", 60)
    program.count("classic_hits", 72)
    run = _run(program)
    read = {n: load_reader(n)(run) for n in NEW}
    assert read["sniffer.precompute_ms"] == pytest.approx(0.006 / 4 * 1e3)
    assert read["sniffer.batch_us_per_row"] == pytest.approx(0.003 / 60 * 1e6)
    assert read["sniffer.classic_us_per_hit"] == \
        pytest.approx(0.018 / 72 * 1e6)
    assert read["ingest.stage_ms"] == pytest.approx(0.009 / 4 * 1e3)
    assert read["ingest.device_wait_ms"] == \
        pytest.approx((0.002 + 0.001) / 4 * 1e3)
    assert read["ingest.launch_ms"] == pytest.approx(0.0016 / 4 * 1e3)
    assert read["ingest.hold_ms_p95.live"] is None       # a closed loop


def test_the_hold_pairs_the_jth_h2d_with_the_jth_assemble(program):
    # the span log in the order the spans closed, as a DEPTH-2 ingest
    # leaves it: block j's assemble starts when block j + 3 is handed
    period, log = 0.040, []
    for j in range(8):
        t = j * period
        log.append(("ingest.stage", t + 0.0001, t + 0.002))
        log.append(("h2d", t, t + 0.003))
        if j >= 3:
            log.append(("assemble", t + 0.004 + j * 1e-4, t + 0.005))
    for j in range(5, 8):                       # the drain
        log.append(("assemble", 0.4 + j * 0.001, 0.4 + j * 0.001 + 0.0005))
    program.spans.extend(log)
    holds = [3 * period + 0.004 + (j + 3) * 1e-4 for j in range(5)] + \
        [0.4 + j * 0.001 - j * period for j in range(5, 8)]
    ordered = sorted(holds)
    x = 0.95 * (len(ordered) - 1)
    i = int(x)
    p95 = ordered[i] + (ordered[i + 1] - ordered[i]) * (x - i)
    run = _run(program, loop="open")
    assert load_reader("ingest.hold_ms_p95.live")(run) == \
        pytest.approx(p95 * 1e3)
    assert load_reader("ingest.hold_ms_p95.live")(
        _run(program, loop="closed")) is None


def test_no_span_reads_none_never_zero(program, monkeypatch):
    for loop in ("open", "closed"):
        assert [load_reader(n)(_run(program, loop)) for n in NEW] == \
            [None] * len(NEW)
    # a program whose stages keep no self time and no span log, and which
    # opens no sniffer or ingest.* stage, as before the spans came
    old = SimpleNamespace(
        stages={"sniffer.precompute": SimpleNamespace(calls=3, total_s=1.0),
                "sniffer.classic": SimpleNamespace(calls=3, total_s=1.0)},
        counters={"classic_hits": 30})
    monkeypatch.setattr(metrics_mod, "metrics", old)
    run = SimpleNamespace(stages={"h2d": (3, 0.01), "assemble": (3, 0.01)},
                          window=SimpleNamespace(loop="open"))
    assert [load_reader(n)(run) for n in NEW] == [None] * len(NEW)


def _events():
    """A window of 1000 ns: the harness's spans, two device ops, and the
    program's spans inside the harness's."""
    base = [("window", None, 0, 1000), ("ingest", None, 50, 300),
            ("mode", None, 300, 600), ("ingest", None, 600, 950),
            ("kernel_a", 0, 100, 200), ("Memcpy HtoD", 0, 650, 700)]
    prog = [("h2d", None, 60, 150), ("ingest.slot_wait", None, 61, 62),
            ("ingest.stage", None, 62, 140), ("device_step", None, 150, 170),
            ("assemble", None, 200, 290),
            ("ingest.result_wait", None, 201, 250),
            ("sniffer.block", None, 310, 590),
            ("sniffer.precompute", None, 311, 400),
            ("sniffer.batch_decode", None, 350, 390),
            ("sniffer.classic", None, 400, 580),
            ("sniffer.le", None, 580, 589)]
    assert {n for n, *_ in prog} <= set(SPANS)
    return base, prog


def test_program_spans_leave_the_device_reading_as_it_was():
    base, prog = _events()
    without = reduce_events(base)
    with_prog = reduce_events(base + prog)
    assert with_prog == without
    assert without["busy_s"] == pytest.approx(150e-9)
    assert without["window_s"] == pytest.approx(1000e-9)
    assert set(without["op_s"]) == {"kernel_a", "Memcpy HtoD"}


def test_the_tracer_holds_the_program_spans_on_the_host(program):
    tracer = Tracer(cuda=False)
    with tracer:
        with tracer.span("window"):
            with program.stage("h2d"):
                with program.stage("ingest.stage"):
                    torch.ones(4).sum()
    ev = tracer.events()
    mine = [(n, d) for n, d, s, e in ev if n in ("h2d", "ingest.stage")]
    assert sorted(mine) == [("h2d", None), ("ingest.stage", None)]
    assert [s[0] for s in program.spans] == ["ingest.stage", "h2d"]


@pytest.mark.gpu
def test_no_program_span_lands_on_the_card_timeline(program):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1 << 20, device="cuda")
    tracer = Tracer(cuda=True)
    with tracer:
        with tracer.span("window"):
            with program.stage("device_step"):
                y = (x * 2).sum()
            with program.stage("assemble"):
                y.item()
        torch.cuda.synchronize()
    ev = tracer.events()
    assert any(n == "device_step" and d is None for n, d, *_ in ev)
    assert not [n for n, d, *_ in ev if d is not None and n in SPANS]
    assert any(d is not None for n, d, *_ in ev)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = small_copy(tmp_path_factory.mktemp("spans"))
    add_live_cell(r)
    bench = json.loads((r / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "ingest.hold_ms_p95.live":
            m["workloads"].append("band8.live")
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


def test_a_traced_run_reads_every_new_metric(root):
    out, _ = run_cell(spec(root, "band8.maxrate"), 2 ** 31 + 5, 0.6, True,
                      device="cpu")
    assert out["correct"], out["check"]
    got = out["metrics"]
    for name in MAXRATE:
        assert got[name]["value"] > 0, name
    assert got["sniffer.classic_us_per_hit"]["unit"] == "us"
    assert "ingest.hold_ms_p95.live" not in got


def test_a_traced_live_run_reads_the_hold(root):
    out, _ = run_cell(spec(root, "band8.live"), 2 ** 31 + 6, 0.6, True,
                      device="cpu")
    assert out["correct"], out["check"]
    # a block's assemble starts once the chunk five blocks later is in:
    # at least five 64-slot periods of 40 ms, less a chunk's hand-over
    assert out["metrics"]["ingest.hold_ms_p95.live"]["value"] > 4 * 40.0
