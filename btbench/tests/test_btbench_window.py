"""The window on a fake clock: the open loop's schedule and lateness,
the closed loop's stop and drain, and the latency over every due block
with an unfinished one counted as failed."""
import math
from types import SimpleNamespace

import pytest

from btbench.harness import drive as drive_mod
from btbench.harness.readings import block_latencies, p95
from btbench.harness.spec import load_reader


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)


class FakeIngest:
    """Holds `depth` blocks past the one it yields, as PipelinedIngest
    does, and spends `cost` seconds per chunk."""

    def __init__(self, clock, depth=4, cost=0.001):
        self.clock, self.depth, self.cost = clock, depth, cost

    def run(self, chunks, start_clkn, initial_carry=None):
        pending = []
        for j, c in enumerate(chunks):
            self.clock.t += self.cost
            if len(pending) > self.depth:
                yield pending.pop(0)
            pending.append(SimpleNamespace(j=j, hits=[0] * 3, le_hits=[]))
        while pending:
            yield pending.pop(0)


class FakeMode:
    def __init__(self, clock, cost):
        self.clock, self.cost, self.seen = clock, cost, []

    def run_blocks(self, results):
        for r in results:
            self.clock.t += self.cost(r.j)
            self.seen.append(r.j)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(drive_mod, "time", c)
    return c


def test_live_schedule_and_lateness_on_a_fake_clock(clock):
    period = 0.040
    # block 10 takes 0.2 s to handle: the generator falls behind, and
    # every later chunk is handed over late until it catches up
    mode = FakeMode(clock, lambda j: 0.2 if j == 10 else 0.002)
    w = drive_mod.drive(mode, FakeIngest(clock), ["c0", "c1"], None,
                        loop="open", seconds=1.0, period_s=period,
                        start_clkn=0)
    assert w.n_due == 25 and len(w.due) == 25 and len(w.done) == 25
    assert w.due == [pytest.approx(100.0 + (j + 1) * period)
                     for j in range(25)]
    late = [h - d for h, d in zip(w.handed, w.due)]
    assert all(x >= -1e-12 for x in late)
    assert max(late) > 0.1                  # the stall shows as lateness
    assert late[0] == pytest.approx(0.0, abs=1e-9)
    lat = block_latencies(SimpleNamespace(window=w))
    # a block's result comes out when the chunk 5 blocks later arrives
    assert lat[0] == pytest.approx(5 * period + 0.001 + 0.002, abs=1e-6)
    run = SimpleNamespace(window=w)
    assert load_reader("gen.lateness_ms_p95.live")(run) > 100.0
    assert load_reader("result_latency_p95_ms")(run) == pytest.approx(
        p95(lat) * 1e3)
    assert load_reader("samples_per_s")(run) is None


def test_closed_loop_stops_after_its_seconds_and_drains(clock):
    mode = FakeMode(clock, lambda j: 0.005)
    w = drive_mod.drive(mode, FakeIngest(clock), ["a", "b", "c"], None,
                        loop="closed", seconds=0.5, period_s=0.04,
                        start_clkn=0)
    assert len(w.handed) == len(w.done) == len(mode.seen)
    assert mode.seen == list(range(len(w.done)))
    assert w.handed[-1] < w.t0 + 0.5 <= w.handed[-1] + 0.006 + 1e-9
    assert w.t_end == w.done[-1] and w.seconds > 0.5
    run = SimpleNamespace(window=w, step_samples=1000)
    assert load_reader("samples_per_s")(run) == pytest.approx(
        len(w.done) * 1000 / w.seconds)
    assert load_reader("result_latency_p95_ms")(run) is None
    assert load_reader("sniffer.us_per_hit")(SimpleNamespace(window=w)) == \
        pytest.approx(0.005 / 3 * 1e6)


def test_latency_covers_every_due_block_and_an_unfinished_one_fails():
    w = drive_mod.Window(loop="open")
    w.due = [1.0, 2.0, 3.0, 4.0]
    w.done = [1.5, 2.5, 3.25]                 # block 3 never completed
    lat = block_latencies(SimpleNamespace(window=w))
    assert lat[:3] == [0.5, 0.5, 0.25] and math.isinf(lat[3])
    assert math.isinf(p95(lat))
    assert p95([0.5, 0.5, 0.25]) == pytest.approx(0.5)
    assert p95(list(range(101))) == pytest.approx(95.0)
