"""The port's UAP-discovery, hopper and sniffer modes against the JAX
package's, on the captures of tests/test_models.py (8 Msps, made from a
seed with numpy by each package's own testing module, which are held
equal here too).

Both packages run on the CPU: the JAX side as tests/test_models.py runs
it, the port with device="cpu" (its plain PyTorch versions).  Each
scenario must give the same UAP and clock offsets, the same decoded
packets (LAP, UAP, clkn, channel, type, payload bits) and the same
EventBus event sequence, with SNR values (the only floats in the events)
within 1e-3 dB, the tolerance of the two packages' slot SNR.  A
checkpoint that the JAX sniffer writes mid-capture restores into the
port's sniffer, which then decodes the rest as the JAX sniffer does.
"""
import numpy as np
import pytest
import torch

from gr_bluetooth_tpu import testing as jtesting
from gr_bluetooth_tpu.models.hopper import Hopper as JHopper
from gr_bluetooth_tpu.models.sniffer import Sniffer as JSniffer
from gr_bluetooth_tpu.models.uap_discovery import UapDiscovery as JUap
from gr_bluetooth_tpu.utils.log import EventBus as JBus
from gr_bluetooth_tpu_torch import convert, testing
from gr_bluetooth_tpu_torch.models.hopper import Hopper
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.models.uap_discovery import UapDiscovery
from gr_bluetooth_tpu_torch.utils.log import EventBus
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 8e6, 2441e6
LAP, UAP, CLK0 = 0x24D952, 0x47, 0x12780
SNR_TOL = 1e-3


def _modes(kind, *args, **kw):
    """(JAX mode, port mode), each on its own EventBus."""
    j, t = {"sniffer": (JSniffer, Sniffer), "hopper": (JHopper, Hopper),
            "uap": (JUap, UapDiscovery)}[kind]
    return (j(*args, bus=JBus(), **kw),
            t(*args, bus=EventBus(), device="cpu", **kw))


def _same_events(a, b):
    assert [e["kind"] for e in a] == [e["kind"] for e in b]
    for ea, eb in zip(a, b):
        assert ea.keys() == eb.keys(), (ea, eb)
        for k, va in ea.items():
            if isinstance(va, float):
                assert abs(va - eb[k]) <= SNR_TOL, (k, ea, eb)
            else:
                assert va == eb[k], (k, ea, eb)


def _pkt_key(p):
    return (p.lap, p.uap, p.clkn, p.channel, p.packet_type,
            None if p.payload is None else p.payload.tobytes())


def _same_decoded(a, b):
    assert [_pkt_key(p) for p in a] == [_pkt_key(p) for p in b]


def _capture(fn, sims, *args, **kw):
    """The same capture from each package's testing module (`sims` makes
    the module's simulated masters): equal, sample for sample."""
    (xj, sj), (xt, st) = (getattr(m, fn)(sims(m), *args, **kw)
                          for m in (jtesting, testing))
    assert np.array_equal(xj, xt) and sj == st
    return xt, st


def _sim(**kw):
    """PiconetSim of LAP/UAP (clk0 CLK0 unless given) for _capture."""
    kw = dict(dict(lap=LAP, uap=UAP, clk0=CLK0), **kw)
    return lambda m: m.PiconetSim(**kw)


@pytest.fixture(scope="module")
def capture():
    """tests/test_models.py's 512-slot capture of one piconet."""
    return _capture("make_piconet_capture", _sim(), n_slots=512, fs=FS,
                    center_freq=CENTER, seed=9)


def test_uap_discovery_matches_jax(capture):
    x, sent = capture
    jm, tm = _modes("uap", FS, CENTER, lap=LAP)
    assert jm.run(x) == tm.run(x) == UAP
    for attr in ("clk_offset", "have_clk6", "first_pkt_time",
                 "pattern_indices", "pattern_channels"):
        assert getattr(jm.piconet, attr) == getattr(tm.piconet, attr), attr
    slot = sent[0][0]
    assert ((slot + tm.piconet.clk_offset) & 0x3F) == ((CLK0 + slot) & 0x3F)
    _same_events(jm.bus.events(), tm.bus.events())


def test_hopper_matches_jax(capture):
    x, _ = capture
    jm, tm = _modes("hopper", FS, CENTER, lap=LAP)
    jd, td = jm.run(x), tm.run(x)
    assert tm.piconet.have_clk27 and tm.piconet.get_offset() == CLK0
    assert jm.piconet.get_offset() == CLK0
    assert tm.followed_slots == jm.followed_slots
    _same_decoded(jd, td)
    assert len(td) > 0
    _same_events(jm.bus.events(), tm.bus.events())
    assert len(tm.bus.events("clock_acquired")) == 1
    # the CLK1-27 scan started on the piconet's device, above the
    # threshold where the set moves to the host
    n0 = tm.bus.events("hop_reversal_started")[0]["candidates"]
    assert n0 > tm.piconet.DEVICE_WINNOW_THRESHOLD
    assert tm.piconet.device == torch.device("cpu")


def test_sniffer_matches_jax(capture):
    x, _ = capture
    jm, tm = _modes("sniffer", FS, CENTER, enable_le=False)
    jd, td = jm.run(x), tm.run(x)
    _same_decoded(jd, td)
    assert len(td) > 3 and all(p.type_name() == "DM1" for p in td)
    _same_events(jm.bus.events(), tm.bus.events())
    assert [(e["lap"], e["uap"]) for e in tm.bus.events("uap_found")] == \
        [(LAP, UAP)]
    assert tm.cursor == jm.cursor


def test_sniffer_fhs_harvest_matches_jax():
    bank = set(Sniffer(FS, CENTER, enable_le=False,
                       device="cpu").fe.bank.channels)
    clk0 = next(c for c in range(0x51234, 0x51234 + 4096)
                if testing.PiconetSim(LAP, UAP, 0xBEEF, c).channel_at(10)
                in bank)

    def payload_fn(slot):
        return (2, b"", True) if slot == 10 else (3, b"\x11\x22\x33", False)

    x, _ = _capture("make_piconet_capture", _sim(nap=0xBEEF, clk0=clk0),
                    n_slots=128, fs=FS, center_freq=CENTER, seed=4,
                    payload_fn=payload_fn)
    jm, tm = _modes("sniffer", FS, CENTER, enable_le=False)
    _same_decoded(jm.run(x), tm.run(x))
    _same_events(jm.bus.events(), tm.bus.events())
    ev = tm.bus.events("fhs_harvested")
    assert ev and ev[0]["uap"] == UAP and ev[0]["nap"] == 0xBEEF
    pn = tm.basic_rate_piconets[LAP]
    assert pn.have_clk27 and (pn.get_offset() - clk0) & 0x7FFFFFD == 0


def test_sniffer_multi_piconet_matches_jax():
    x, sent = _capture(
        "make_multi_piconet_capture",
        lambda m: [m.PiconetSim(lap=LAP, uap=UAP, clk0=CLK0),
                   m.PiconetSim(lap=0x5A3F71, uap=0xC3, clk0=0x51234)],
        256, FS, CENTER, seed=23)
    jm, tm = _modes("sniffer", FS, CENTER, enable_le=False)
    jd, td = jm.run(x), tm.run(x)
    _same_decoded(jd, td)
    _same_events(jm.bus.events(), tm.bus.events())
    found = {e["lap"]: e["uap"] for e in tm.bus.events("uap_found")}
    assert found == {LAP: UAP, 0x5A3F71: 0xC3}
    by_slot = {s: (c, lap) for s, c, lap in sent}
    assert all(by_slot[p.clkn] == (p.channel, p.lap) for p in td)


def test_sniffer_hostile_matches_jax():
    """bench.py's `mixed` traffic (three piconets, every slot busy with
    1/3/5-slot DM/DH packets, seed 13) at 8 Msps.  Both packages first
    find piconet 0x654321 at a wrong CLK1-6, decode its slot-20 DM1 as an
    FHS at that clock, lose the clock and find it again: reference
    behaviour the port matches, not fixes."""
    x, sent = _capture(
        "make_hostile_capture",
        lambda m: [m.PiconetSim(lap=LAP, uap=UAP, clk0=CLK0),
                   m.PiconetSim(lap=0x1A2B3C, uap=0x99, clk0=0x450),
                   m.PiconetSim(lap=0x654321, uap=0x13, clk0=0x71111)],
        256, FS, CENTER, seed=13)
    jm, tm = _modes("sniffer", FS, CENTER)
    jd, td = jm.run(x), tm.run(x)
    _same_decoded(jd, td)
    _same_events(jm.bus.events(), tm.bus.events())
    found = [(e["lap"], e["clk_offset"]) for e in tm.bus.events("uap_found")]
    assert found[:2] == [(0x654321, 6), (0x654321, 17)]
    assert [(p.clkn, p.packet_type) for p in td if p.lap == 0x654321][0] == \
        (20, 2) and (20, 40, 0x654321, 3) in sent


def test_sniffer_type_breadth_matches_jax():
    """DH1, DM3, EV3, HV1, AUX1, DM5, DH5, EV4, EV5, HV2, DH3 and DV
    through both packages' full RF paths, batched and per packet."""
    bank = set(Sniffer(FS, CENTER, enable_le=False,
                       device="cpu").fe.bank.channels)
    sim = testing.PiconetSim(lap=LAP, uap=UAP, clk0=CLK0)
    rng = np.random.default_rng(0xD00D)
    types = [(t, bytes(rng.integers(0, 256, n).tolist())) for t, n in
             ((4, 10), (10, 30), (7, 8), (5, 10), (9, 12), (14, 80),
              (15, 120), (12, 60), (13, 100), (6, 20), (11, 60), (8, 7))]
    voice = bytes(rng.integers(0, 256, 10).tolist())
    assign, slot = {}, 20
    while types:
        if sim.channel_at(slot) in bank:
            assign[slot] = types.pop(0)
            slot += 6
        else:
            slot += 1

    def payload_fn(s):
        if s in assign:
            t, payload = assign[s]
            return (t, payload, False, voice) if t == 8 else \
                (t, payload, False)
        return 3, b"\x01\x02\x03\x04", False

    tx = sorted(list(range(0, 16, 2)) + list(assign))
    x, _ = _capture("make_piconet_capture", _sim(),
                    n_slots=max(assign) + 8, fs=FS, center_freq=CENTER,
                    seed=29, payload_fn=payload_fn, tx_slots=tx)
    for batch in (True, False):
        jm, tm = _modes("sniffer", FS, CENTER, enable_le=False,
                        batch_decode=batch)
        jd, td = jm.run(x), tm.run(x)
        _same_decoded(jd, td)
        _same_events(jm.bus.events(), tm.bus.events())
        got = {p.clkn: p.packet_type for p in td}
        assert all(got.get(s) == t for s, (t, _) in assign.items())
        dv = [p for p in td if p.packet_type == 8]
        assert dv and all(p.voice_bytes() == voice for p in dv)


@pytest.mark.parametrize("ch_sel", [0, 1])
def test_sniffer_le_connection_matches_jax(ch_sel):
    """CONNECT_REQ then CSA#1 (or CSA#2) hopped data packets: the same
    le_connection, le_data and le_seen events and LE packets."""
    fs, center = 8e6, 2426e6
    kw = dict(ch_map=(1 << 10) | (1 << 11), interval=6, win_offset=1,
              ch_sel=ch_sel, hop_increment=5)
    x, sent = _capture("make_le_connection_capture",
                       lambda m: m.LeConnectionSim(**kw), n_slots=128,
                       fs=fs, center_freq=center, connect_slot=2, n_events=8)
    jm, tm = _modes("sniffer", fs, center, enable_le=True)
    jm.run(x)
    tm.run(x)
    _same_events(jm.bus.events(), tm.bus.events())
    assert [(p.aa, p.index, p.clkn, p.crc_ok()) for p in jm.le_packets] == \
        [(p.aa, p.index, p.clkn, p.crc_ok()) for p in tm.le_packets]
    sim = testing.LeConnectionSim(**kw)
    (conn,) = tm.bus.events("le_connection")
    assert (conn["aa"], conn["crc_init"], conn["hop"]) == \
        (sim.conn_aa, sim.crc_init, sim.hop_increment)
    pn = tm.low_energy_piconets[sim.conn_aa]
    n_data = sum(1 for *_, kind in sent if kind == "DATA")
    assert pn.crc_ok_count >= n_data - 1 and pn.crc_bad_count == 0
    assert pn.ch_sel == ch_sel


def test_jax_checkpoint_restores_into_the_port(capture, tmp_path):
    """A JAX sniffer stops half-way and saves its state; the port's
    sniffer restores it (convert.state_from_jax) and decodes the rest of
    the capture exactly as a JAX sniffer restored from the same file,
    without discovering the piconet again."""
    x, _ = capture
    half = 256 * 625 * int(FS // 1e6)
    first = JSniffer(FS, CENTER, bus=JBus(), enable_le=False)
    first.run(x[:half])
    assert first.cursor == 256 and first.basic_rate_piconets[LAP].have_uap
    path = str(tmp_path / "sniffer.npz")
    first.save_state(path)

    jm, tm = _modes("sniffer", FS, CENTER, enable_le=False)
    assert jm.restore_state(path) == convert.state_from_jax(tm, path) == 256
    pn = tm.basic_rate_piconets[LAP]
    assert (pn.uap, pn.have_clk6, pn.device) == (UAP, True,
                                                 torch.device("cpu"))
    jd = jm.run(x[half:], start_clkn=256)
    td = tm.run(x[half:], start_clkn=256)
    _same_decoded(jd, td)
    assert len(td) > 3 and all(p.clkn >= 256 and p.uap == UAP for p in td)
    _same_events(jm.bus.events(), tm.bus.events())
    assert not tm.bus.events("uap_found")
    # and back: the port's state restores into the JAX package
    path2 = str(tmp_path / "port.npz")
    tm.save_state(path2)
    back = JSniffer(FS, CENTER, bus=JBus(), enable_le=False)
    assert back.restore_state(path2) == tm.cursor
    assert back.basic_rate_piconets[LAP].uap == UAP


def test_fullband_hits_match_jax():
    """bench.py's sniffer traffic at full band (80 Msps, 79 channels, LE
    on; three piconets, seed 13, as chip_smoke.py's modes phase), cut to
    48 slots and 8-slot blocks: the two packages' front ends give the same
    classic and LE hits, so the decode above them sees the same input."""
    from gr_bluetooth_tpu.models.frontend import FrontEnd as JFrontEnd
    from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
    sims = [jtesting.PiconetSim(lap=lap, uap=uap, clk0=clk0)
            for lap, uap, clk0 in ((LAP, UAP, CLK0), (0x1A2B3C, 0x99, 0x450),
                                   (0x654321, 0x13, 0x71111))]
    kw = dict(block_slots=8, max_ac_errors=6, enable_le=True)
    fes = (JFrontEnd(80e6, CENTER, **kw),
           FrontEnd(80e6, CENTER, device="cpu", **kw))
    for make in (jtesting.make_multi_piconet_capture,
                 jtesting.make_hostile_capture):
        x, sent = make(sims, 48, 80e6, CENTER, seed=13)
        j, t = (list(fe.stream(x)) for fe in fes)
        assert [(h.clkn, h.channel, h.lap, h.errors, h.sym_offset)
                for r in j for h in r.hits] == \
            [(h.clkn, h.channel, h.lap, h.errors, h.sym_offset)
             for r in t for h in r.hits]
        assert [(h.clkn, h.index, h.sym_offset, h.distance)
                for r in j for h in r.le_hits] == \
            [(h.clkn, h.index, h.sym_offset, h.distance)
             for r in t for h in r.le_hits]
        assert sum(len(r.hits) for r in t) >= len(sent)


def test_modes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, kw in ((Sniffer, {}), (Hopper, dict(lap=LAP)),
                    (UapDiscovery, dict(lap=LAP))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(FS, CENTER, **kw)
