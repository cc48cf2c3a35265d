"""The port's Kismet survey (gr_bluetooth_tpu_torch.kismet) against the
JAX package's (gr_bluetooth_tpu.kismet), on the same calls and captures.

  * frame bytes, queue behaviour, tracker fields, GPS aggregates, BTBBDEV
    records and the rendered table equal the JAX modules', exactly;
  * KismetSource(8e6, ..., device="cpu") gives the same frames and
    tracker as the JAX KismetSource over test_kismet.py's
    test_source_end_to_end capture;
  * both btsurvey CLIs print the same table (time columns stripped);
  * the servers send the same bytes, and the port's delivers a tick that
    falls between a client's snapshot and its send (the JAX server
    registers a client only after its snapshot is sent, so such a tick's
    update never reaches it).
Socket waits use a 60 s deadline.
"""
import re
import select
import socket
import threading

import pytest

from gr_bluetooth_tpu import kismet as jk
from gr_bluetooth_tpu.kismet import server as jserver
from gr_bluetooth_tpu.kismet import ui as jui
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu_torch import kismet as tk
from gr_bluetooth_tpu_torch.kismet import server as tserver
from gr_bluetooth_tpu_torch.kismet import ui as tui
from torch_parity import SURVEY_CLIS, one_torch_thread, run_clis  # noqa: F401

WAIT_S = 60
PKGS = {"jax": (jk, jserver, jui), "port": (tk, tserver, tui)}


@pytest.mark.parametrize("lap,channel,clkn", [(0x24D952, 39, 7),
                                              (0, 0, 0),
                                              (0xFFFFFF, 78, 0x7FFFFFF)])
def test_frame_bytes_equal_jax(lap, channel, clkn):
    raw = {k: m.LapFrame(lap=lap, channel=channel, clkn=clkn).pack()
           for k, (m, _, _) in PKGS.items()}
    assert raw["port"] == raw["jax"] and len(raw["port"]) == 14
    back = tk.LapFrame.unpack(raw["jax"], channel=channel, clkn=clkn)
    want = jk.LapFrame.unpack(raw["jax"], channel=channel, clkn=clkn)
    assert (back.lap, back.channel, back.clkn) == \
        (want.lap, want.channel, want.clkn) == (lap, channel, clkn)
    for m, _, _ in PKGS.values():
        with pytest.raises(ValueError):
            m.LapFrame.unpack(b"\x00" * 14)


def _queue_trace(m, maxsize, n_put):
    q = m.FrameQueue(maxsize=maxsize)
    try:
        puts = [q.put(m.LapFrame(lap=i, channel=i % 79)) for i in range(n_put)]
        woke = select.select([q.wake_fd], [], [], 0)[0] == [q.wake_fd]
        trace = (puts, len(q), q.n_dropped, woke,
                 [(f.lap, f.channel) for f in q.drain()])
        after = select.select([q.wake_fd], [], [], 0)[0]
        return trace + (after, len(q))
    finally:
        q.close()


@pytest.mark.parametrize("maxsize,n_put", [(20, 25), (20, 3), (5, 5)])
def test_queue_behaviour_equal_jax(maxsize, n_put):
    assert _queue_trace(tk, maxsize, n_put) == \
        _queue_trace(jk, maxsize, n_put)


SIGHTINGS = [  # (lap, when, gps fix or None)
    (0xABCDEF, 100.0, None),
    (0xABCDEF, 105.0, (37.0, -122.0, 10.0, 1.0, 2)),
    (0x111111, 106.0, (0.0, 0.0, 0.0, 0.0, 0)),
    (0x5, 107.5, (37.2, -122.4, 30.0, 3.0, 3)),
    (0x5, 108.0, (36.9, -121.9, 5.0, 0.5, 2)),
    (0xABCDEF, 109.0, (37.1, -122.2, 12.0, 2.0, 2)),
    (0x5, 110.0, None),
]


def _tracker_trace(m):
    t = m.TrackerBluetooth(clock=lambda: 99.0)
    seen = []
    for i, (lap, when, g) in enumerate(SIGHTINGS):
        gps = m.GpsFix(*g) if g is not None else None
        net = t.observe(lap, gps=gps, when=None if i == 0 else when)
        seen.append(None if net is None else net.fields())
        if i == 3:
            seen.append([n.fields() for n in t.blit()])
    return (seen, sorted(t.first_nets), sorted(t.tracked_nets),
            t.n_sightings, [n.fields() for n in t.snapshot()],
            [n.fields() for n in t.blit()], [n.fields() for n in t.blit()],
            {lap: vars(n.gpsdata) for lap, n in t.first_nets.items()},
            {lap: n.bd_addr for lap, n in t.first_nets.items()})


def test_tracker_fields_and_gps_aggregates_equal_jax():
    port, jax = _tracker_trace(tk), _tracker_trace(jk)
    assert port == jax
    assert jax[2] == [0x5, 0xABCDEF]          # two sightings each


def test_records_equal_jax():
    records = {}
    for k, (m, srv, _) in PKGS.items():
        t = m.TrackerBluetooth(clock=lambda: 42.0)
        t.observe(0x24D952)
        t.observe(0x24D952, gps=m.GpsFix(37.5, -122.25, 12.0, 0.5))
        t.observe(0x000F0F)
        t.observe(0x000F0F)
        records[k] = [srv.format_record(n) for n in t.snapshot()]
    assert records["port"] == records["jax"]
    for line in records["jax"]:
        assert tserver.parse_record(line) == jserver.parse_record(line)
    for bad in ("*BTBBDEV: 1 2\n", "*OTHER: x\n"):
        for srv in (tserver, jserver):
            with pytest.raises(ValueError):
                srv.parse_record(bad)


@pytest.mark.parametrize("sort", ["bdaddr", "firsttime", "lasttime",
                                  "packets"])
def test_render_equal_jax(sort):
    text, order = {}, {}
    for k, (m, _, ui) in PKGS.items():
        t = m.TrackerBluetooth(clock=lambda: 50.0)
        for i, (lap, count) in enumerate([(0x300000, 3), (0x100000, 5),
                                          (0x200000, 2), (0x400000, 1)]):
            for j in range(count):
                t.observe(lap, when=50.0 + 3 * i + j,
                          gps=m.GpsFix(37.0 + i, -122.0) if j else None)
        text[k] = ui.render(t, sort=sort, width=50, now=60.0)
        order[k] = [n.lap for n in ui.sort_networks(t.snapshot(), sort)]
    assert text["port"] == text["jax"]
    assert order["port"] == order["jax"]
    with pytest.raises(ValueError):
        tui.sort_networks([], "bogus")


def _run_source(m, **kw):
    """test_kismet.py::test_source_end_to_end's capture through a
    package's KismetSource: (frames, tracked networks' fields, count)."""
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    samples, _ = make_piconet_capture(sim, n_slots=512, fs=8e6,
                                      center_freq=2441e6, seed=5)
    src = m.KismetSource(8e6, 2441e6, queue=m.FrameQueue(maxsize=1000),
                         tracker=m.TrackerBluetooth(clock=lambda: 3.0),
                         gps_provider=lambda: m.GpsFix(37.0, -122.0), **kw)
    try:
        n = src.run(samples)
        frames = [(f.lap, f.channel, f.clkn) for f in src.queue.drain()]
        nets = {lap: net.fields() for lap, net in
                src.tracker.tracked_nets.items()}
        return (n, frames, src.queue.maxsize, src.queue.n_dropped, nets,
                sorted(src.tracker.first_nets))
    finally:
        src.queue.close()


def test_source_matches_jax():
    """Equal frames and tracker.  One deliberate divergence: the JAX
    source replaces the caller's empty 1000-frame queue with a default
    20-frame one (`queue or FrameQueue()`, and an empty queue is falsy),
    so it drops the frames past 20; the port keeps the caller's queue."""
    n, frames, maxsize, dropped, nets, first = _run_source(tk, device="cpu")
    jn, jframes, jmaxsize, jdropped, jnets, jfirst = _run_source(jk)
    assert (n, nets, first) == (jn, jnets, jfirst)
    assert (maxsize, dropped) == (1000, 0)
    assert (jmaxsize, jdropped) == (20, n - 20)
    assert frames[:20] == jframes and len(frames) == n > 20
    assert set(nets) == {0x24D952}
    assert nets[0x24D952]["packets"] == n
    assert nets[0x24D952]["aggpoints"] == n


_TIMES = re.compile(r"\s+-?\d+s\s+-?\d+s\s")


def test_btsurvey_clis_print_the_same_table():
    runs = run_clis(lambda _: ["-r", "8e6", "-f", "2441e6", "--synthetic",
                               "128", "--table"], clis=SURVEY_CLIS)
    out = {}
    for name, r in runs.items():
        assert r.returncode == 0, r.stderr.decode()[-800:]
        assert b"tracked networks" in r.stderr
        out[name] = ([_TIMES.sub(" <t> <t> ", ln)
                      for ln in r.stdout.decode().splitlines()],
                     r.stderr.decode().splitlines()[-1])
    assert out["port"] == out["jax"]
    assert any("00:00:00:24:d9:52" in ln for ln in out["port"][0])


def _read_lines(conn, n):
    f = conn.makefile()
    return [f.readline() for _ in range(n)]


def _tracked(m):
    t = m.TrackerBluetooth(clock=lambda: 1.0)
    for lap in (0x42, 0x42, 0x24D952, 0x24D952):
        t.observe(lap, gps=m.GpsFix(37.5, -122.25))
    return t


def test_servers_send_the_same_snapshot_bytes():
    got = {}
    for k, (m, _, _) in PKGS.items():
        srv = m.BtbbDevServer(_tracked(m))
        try:
            with socket.create_connection(srv.address,
                                          timeout=WAIT_S) as c:
                c.settimeout(WAIT_S)
                got[k] = _read_lines(c, 2)
        finally:
            srv.close()
    assert got["port"] == got["jax"]
    assert [tserver.parse_record(ln)["packets"] for ln in got["port"]] == \
        [2, 2]


def test_server_snapshot_and_blit():
    t = tk.TrackerBluetooth(clock=lambda: 1.0)
    t.observe(0x42)
    t.observe(0x42)          # tracked, dirty
    srv = tk.BtbbDevServer(t)
    try:
        with socket.create_connection(srv.address, timeout=WAIT_S) as c:
            c.settimeout(WAIT_S)
            f = c.makefile()
            # enable path: snapshot arrives on connect
            assert tserver.parse_record(f.readline())["packets"] == 2
            # timer path: new sighting -> dirty -> tick sends an update
            t.observe(0x42)
            assert srv.tick() == 1
            assert tserver.parse_record(f.readline())["packets"] == 3
            assert srv.tick() == 0            # nothing dirty now
    finally:
        srv.close()


def test_tick_between_snapshot_and_send_reaches_the_client():
    """A tick whose blit falls after a new client's snapshot is taken
    and before that snapshot is sent (forced by the accept thread's hook)
    reaches the client, after its snapshot."""
    t = tk.TrackerBluetooth(clock=lambda: 1.0)
    t.observe(0x42)
    t.observe(0x42)
    srv = tk.BtbbDevServer(t)
    ticked, done = [], threading.Event()

    def tick_now():
        t.observe(0x42)
        ticked.append(srv.tick())
        done.set()

    srv.on_snapshot = tick_now
    try:
        with socket.create_connection(srv.address, timeout=WAIT_S) as c:
            c.settimeout(WAIT_S)
            lines = _read_lines(c, 2)
        assert done.wait(WAIT_S) and ticked == [1]
        assert [tserver.parse_record(ln)["packets"] for ln in lines] == \
            [2, 3]
    finally:
        srv.close()
