"""The port's CLK1-27 winnower and piconet state against the JAX
package's host reference, and the checkpoint format across packages.

  * ops/hop_ops.DeviceWinnower(device="cpu") against core/hop's
    init_candidates + winnow chains (the cases of tests/test_hop_ops.py:
    randomized addresses and hop-consistent patterns in all four
    (aliased, afh) variants, random observations down to the empty set);
  * the port's BasicRatePiconet, whose hop reversal always runs on its
    DeviceWinnower, against the JAX piconet on its numpy path;
  * io/checkpoint: a file either package writes restores into the other
    (the cases of tests/test_checkpoint.py), with the same meta JSON.
"""
import json

import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.constants import SEQUENCE_LENGTH
from gr_bluetooth_tpu.core import hop as jhop
from gr_bluetooth_tpu.io import checkpoint as jcheckpoint
from gr_bluetooth_tpu.models import piconet as jpiconet
from gr_bluetooth_tpu_torch.io import checkpoint
from gr_bluetooth_tpu_torch.models import piconet
from gr_bluetooth_tpu_torch.ops import hop_ops
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

LAP, UAP = 0x24D952, 0x47


def _host_chain(address, clk6, pattern, aliased, afh):
    ac = jhop.address_precalc(address)
    cands = jhop.init_candidates(pattern[0][1], clk6, ac, aliased=aliased,
                                 afh=afh)
    for off, ch in pattern[1:]:
        cands = jhop.winnow(cands, off, ch, ac, aliased=aliased, afh=afh)
    return cands


@pytest.mark.parametrize("aliased,afh", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_winnower_matches_host(aliased, afh):
    rng = np.random.default_rng(17 + 2 * aliased + afh)
    for _ in range(2):
        address = int(rng.integers(0, 1 << 28))
        clk0 = int(rng.integers(0, SEQUENCE_LENGTH))
        ac = jhop.address_precalc(address)

        def obs(off):
            ch = int(jhop.hop((clk0 + off) & (SEQUENCE_LENGTH - 1), ac,
                              afh=afh))
            return (off, int(jhop.aliased_channel(ch)) if aliased else ch)

        pattern = [obs(o) for o in [0, 2, 5, 9, 14, 27, 33]]
        want = _host_chain(address, clk0 & 0x3F, pattern, aliased, afh)
        w = hop_ops.DeviceWinnower(address, clk0 & 0x3F, pattern[0][1],
                                   aliased=aliased, afh=afh, device="cpu")
        assert w.mask.device.type == "cpu"
        for off, ch in pattern[1:]:
            w.winnow(off, ch)
        got = w.candidates()
        assert w.count == len(got) and got.dtype == np.int64
        np.testing.assert_array_equal(np.sort(want), got)
        assert clk0 in set(got.tolist())


def test_winnower_random_observations():
    rng = np.random.default_rng(77)
    address, clk6 = 0x4724D952 & 0xFFFFFFF, 0x12
    ac = jhop.address_precalc(address)
    first = int(jhop.hop(clk6, ac))
    w = hop_ops.DeviceWinnower(address, clk6, first, device="cpu")
    cands = jhop.init_candidates(first, clk6, ac)
    np.testing.assert_array_equal(w.candidates(), np.sort(cands))
    for _ in range(6):
        off, ch = int(rng.integers(1, 1000)), int(rng.integers(0, 79))
        assert w.winnow(off, ch) == len(cands := jhop.winnow(cands, off, ch,
                                                             ac))
        np.testing.assert_array_equal(w.candidates(), np.sort(cands))
        if not len(cands):
            break


def test_hop_channels_match_core_hop():
    rng = np.random.default_rng(5)
    clocks = rng.integers(0, SEQUENCE_LENGTH, 5000)
    for address in (0x4724D952 & 0xFFFFFFF, int(rng.integers(0, 1 << 28))):
        ac = jhop.address_precalc(address)
        for afh in (False, True):
            got = hop_ops.hop_channels(
                torch.from_numpy(clocks.astype(np.int32)), ac.a1, ac.b,
                ac.c1, ac.d1, ac.e, afh=afh)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(),
                                          jhop.hop(clocks, ac, afh=afh))


def _pattern_piconet(mod, clk0=0x12780, **kw):
    ac = jhop.address_precalc(((UAP << 24) | LAP) & 0xFFFFFFF)
    pn = mod.BasicRatePiconet(lap=LAP, **kw)
    pn.uap, pn.have_uap, pn.have_clk6 = UAP, True, True
    pn.first_pkt_time, pn.clk_offset = 0, clk0 & 0x3F
    for off in [0, 1, 2, 3, 5, 8, 13, 21, 1000, 32771, 65539, 131072,
                (1 << 17) + 3, 1 << 20, (1 << 24) + 7]:
        pn.pattern_indices.append(off)
        pn.pattern_channels.append(
            int(jhop.hop((clk0 + off) & (SEQUENCE_LENGTH - 1), ac)))
        pn.packets_observed += 1
    return pn


def test_piconet_hop_reversal_matches_jax():
    """The port's piconet winnows on its device and hands the set to the
    numpy tail under DEVICE_WINNOW_THRESHOLD, as the JAX piconet's host
    path does: same counts and candidates."""
    port = _pattern_piconet(piconet, device="cpu")
    ref = _pattern_piconet(jpiconet)
    n0 = port.init_hop_reversal()
    assert port._winnower is not None and port.clock27_candidates is None
    assert port._winnower.mask.device.type == "cpu"
    assert n0 == ref.init_hop_reversal(use_device=False) > \
        port.DEVICE_WINNOW_THRESHOLD
    # two clocks stay: the pattern never crosses a c-conjugating clock bit
    assert port.winnow() == ref.winnow() == 2
    assert port._winnower is None
    assert port.have_clk27 == ref.have_clk27
    got = port.get_clock27_candidates()
    np.testing.assert_array_equal(got, ref.get_clock27_candidates())
    assert 0x12780 in got.tolist()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hop_ops.DeviceWinnower(0x4724D952, 0x12, 40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        piconet.BasicRatePiconet(lap=LAP)
    assert piconet.LowEnergyPiconet(aa=1).aa == 1       # has no device


def _registry(mod, **kw):
    pn = mod.BasicRatePiconet(lap=LAP, **kw)
    pn.uap, pn.have_uap = UAP, True
    pn.clk_offset, pn.have_clk6 = 0x2A, True
    pn.pattern_indices = [0, 5, 9]
    pn.pattern_channels = [12, 40, 66]
    pn.packets_observed = 3
    pn.clock6_candidates = np.arange(64, dtype=np.int64)
    le = mod.LowEnergyPiconet(aa=0xC0FFEE11)
    le.is_connection, le.crc_init, le.hop_increment = True, 0x123456, 9
    le.interval, le.anchor_clkn, le.ch_map = 6, 44, 0x1FFFFFFFFF
    return {LAP: pn}, {0xC0FFEE11: le}


def _meta(path):
    return json.loads(bytes(np.load(path)["__meta__"]).decode())


def test_checkpoint_registry_across_packages(tmp_path):
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jbr, jle = _registry(jpiconet)
    tbr, tle = _registry(piconet, device="cpu")
    jcheckpoint.save_state(jpath, cursor=321, basic_rate=jbr,
                           low_energy=jle)
    checkpoint.save_state(tpath, cursor=321, basic_rate=tbr, low_energy=tle)
    assert _meta(jpath) == _meta(tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)

    cursor, br, lep = checkpoint.load_state(jpath, device="cpu")
    assert cursor == 321
    q = br[LAP]
    assert q.device == torch.device("cpu")
    assert (q.uap, q.have_uap, q.clk_offset, q.have_clk6) == \
        (UAP, True, 0x2A, True)
    assert q.pattern_indices == [0, 5, 9] and \
        q.pattern_channels == [12, 40, 66]
    assert (q.clock6_candidates == np.arange(64)).all()
    l2 = lep[0xC0FFEE11]
    assert l2.is_connection and l2.crc_init == 0x123456
    assert l2.predict_channel(60) == jle[0xC0FFEE11].predict_channel(60)

    _, jbr2, _ = jcheckpoint.load_state(tpath)
    assert jbr2[LAP].pattern_channels == [12, 40, 66]


def test_checkpoint_hop_reversal_state_across_packages(tmp_path):
    """A port piconet mid-winnow (device-resident set) saves its
    materialized candidates; the JAX package restores them, and a JAX
    checkpoint of the same state restores into the port."""
    pn = _pattern_piconet(piconet, device="cpu")
    pn.pattern_indices, pn.pattern_channels = [0], [33]
    pn.packets_observed = 1
    pn.init_hop_reversal()
    assert pn._winnower is not None
    path = str(tmp_path / "h.npz")
    checkpoint.save_state(path, basic_rate={LAP: pn})
    _, jbr, _ = jcheckpoint.load_state(path)
    _, br, _ = checkpoint.load_state(path, device="cpu")
    for q in (jbr[LAP], br[LAP]):
        assert q.hop_reversal_inited
        np.testing.assert_array_equal(q.clock27_candidates,
                                      pn.get_clock27_candidates())
        for clk in (0, 12345, 0x7FFFFFF):
            assert q.hop(clk) == pn.hop(clk)
