"""The port's constants, wire codecs and package rules.

  * the bank and detector constants the port builds for itself equal the
    JAX package's (make_pfb_bank, make_stream_snr_consts, affine_code,
    _word_slot_consts), and convert.consts_from_jax reproduces them;
  * wire_decode is bit-identical to wire_decode_np for every format;
  * no file of the port (its CLI in apps/, the I/O, resampler,
    conv-bank, parallel-decode and blocks modules, the Kismet survey in
    kismet/, the sharded front ends in parallel/, the compiled steps in
    utils/graph.py, graft_entry.py and the benchmark bench.py among
    them), and not chip_smoke.py, imports jax or gr_bluetooth_tpu;
  * entry points with no device on a machine without a card raise, odd
    and off-grid rates build their own front ends (an odd rate's has no
    fused chain, and its fused_step raises), and the kernel wrappers
    refuse bad input;
  * the port builds its own copy of native/btio.cc with g++ into its
    _build directory and writes nothing under native/.
"""
import ast
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.core import access_code as jaccess_code
from gr_bluetooth_tpu.io import ingest as jingest
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import pfb as jpfb
from gr_bluetooth_tpu.ops import snr as jsnr
from gr_bluetooth_tpu.ops import synth as jsynth
from gr_bluetooth_tpu_torch import bench, convert, graft_entry
from gr_bluetooth_tpu_torch.core import access_code
from gr_bluetooth_tpu_torch.io import ingest, native
from gr_bluetooth_tpu_torch.kismet import KismetSource
from gr_bluetooth_tpu_torch.models import frontend, lap_survey
from gr_bluetooth_tpu_torch.ops import pfb, pfb_kernel, snr, synth
from gr_bluetooth_tpu_torch.parallel import ShardedFrontEnd

ROOT = Path(__file__).resolve().parent.parent
RATES = [(4e6, 2441e6), (8e6, 2426e6), (20e6, 2450e6), (80e6, 2441e6)]


@pytest.mark.parametrize("fs,center", RATES)
def test_bank_and_snr_consts_equal_jax(fs, center):
    bj, bt = jpfb.make_pfb_bank(fs, center), pfb.make_pfb_bank(fs, center)
    for f in ("fs", "center_freq", "sps", "decim", "ch_sps", "channels",
              "ntaps", "demod_gain"):
        assert getattr(bt, f) == getattr(bj, f), f
    for f in ("h0", "h1", "dft_c", "dft_s", "bin_odd"):
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    sj, st = jsnr.make_stream_snr_consts(bj), snr.make_stream_snr_consts(bt)
    assert st.slot_ch == sj.slot_ch and st.kappa == sj.kappa
    assert np.array_equal(st.taps_re, sj.taps_re)
    assert np.array_equal(st.taps_im, sj.taps_im)


def test_full_band_geometry():
    """The full-band cell: 79 channels + the probe row, M = 80, D = 40,
    533 taps, Q = 7; a 64-slot block is 3,450,692 samples, 43,125
    symbols and 192 hit rows."""
    fe = frontend.FrontEnd(80e6, 2441e6, block_slots=64, max_ac_errors=1,
                           device="cpu")
    b = fe.bank
    assert (b.n_channels, b.dft_c.shape, b.decim, b.ntaps, b.h0.shape[0]) \
        == (79, (80, 80), 40, 533, 7)
    assert (fe.block_samples, fe.step_samples, fe.n_sym, fe.max_hits) == \
        (3450692, 3200000, 43125, 192)


def test_access_code_and_word_consts_equal_jax():
    A, C = access_code.affine_code()
    Aj, Cj = jaccess_code.affine_code()
    assert np.array_equal(A, Aj) and np.array_equal(C, Cj)
    for lap in (0, 0x24D952, 0xFFFFFF, 0x9E8B33):
        assert np.array_equal(access_code.ac_bits(lap),
                              jaccess_code.ac_bits(lap))
    for n_words, delay in ((254, 4), (1346, 7), (97, 31)):
        for a, b in zip(frontend._word_slot_consts(n_words, delay),
                        jfrontend._word_slot_consts(n_words, delay)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fs,max_err,squelch", [(4e6, 1, True),
                                                (8e6, 6, False)])
def test_consts_from_jax_equal_port_consts(fs, max_err, squelch):
    fj = jfrontend.FrontEnd(fs, 2441e6, block_slots=8,
                            max_ac_errors=max_err, use_squelch=squelch,
                            use_pallas=True)
    ft = frontend.FrontEnd(fs, 2441e6, block_slots=8, max_ac_errors=max_err,
                           use_squelch=squelch, device="cpu")
    kw = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in fj._step_kwargs.items()}
    consts, statics = convert.consts_from_jax(kw)
    assert statics == ft.statics
    assert consts.keys() == ft.consts.keys()
    for k, v in consts.items():
        assert v.dtype == ft.consts[k].dtype and torch.equal(v, ft.consts[k]), k
    with pytest.raises(ValueError):
        convert.consts_from_jax(dict(kw, word_s0=None))


def test_synth_equals_jax():
    plan = [jsynth.PlannedPacket(channel=39, start_sample=1000,
                                 bits=jaccess_code.ac_bits(0x24D952))]
    a = synth.synthesize_capture(
        [synth.PlannedPacket(channel=39, start_sample=1000,
                             bits=access_code.ac_bits(0x24D952))],
        n_samples=20000, fs=4e6, center_freq=2441e6, seed=3)
    b = jsynth.synthesize_capture(plan, n_samples=20000, fs=4e6,
                                  center_freq=2441e6, seed=3)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("wire", sorted(ingest.WIRES))
def test_wire_decode_bit_identical(wire):
    r = np.random.default_rng(1)
    x = np.clip(r.normal(0, 0.4, (2, 5000)), -1.2, 1.2).astype(np.float32)
    x[:, :4] = [[0.0, -1.0, 0.999, -0.5], [1.0, -0.0, 0.5, 7.0]]
    inter = ingest.wire_encode(x, wire)
    assert np.array_equal(inter, jingest.wire_encode(x, wire))
    ref = ingest.wire_decode_np(inter, wire)
    assert np.array_equal(ref, jingest.wire_decode_np(inter, wire))
    got = ingest.wire_decode(torch.from_numpy(inter.copy()), wire)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "gr_bluetooth_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20 and files[-1].exists()
    scanned = {str(f.relative_to(ROOT / "gr_bluetooth_tpu_torch"))
               for f in files[:-1]}
    assert {"apps/__init__.py", "apps/btrx.py", "blocks.py", "io/native.py",
            "io/sources.py", "io/writers.py", "io/ingest.py",
            "models/parallel_host.py", "ops/resample.py",
            "ops/channelizer.py", "ops/snr.py", "kismet/__main__.py",
            "kismet/source.py", "kismet/server.py", "parallel/sharded.py",
            "parallel/sharded2d.py", "parallel/dryrun.py",
            "parallel/worker.py", "utils/graph.py",
            "graft_entry.py", "bench.py"} <= scanned
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gr_bluetooth_tpu"), \
                (str(f.relative_to(ROOT)), mod)


def test_native_build_is_the_ports_own(tmp_path, monkeypatch):
    """The port builds its own copy of btio.cc with g++ (not make) into
    its _build directory, named by a digest of the source, and writes
    nothing under native/."""
    before = {p.name: p.stat().st_size for p in (ROOT / "native").iterdir()}
    calls = []
    run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(cmd)
        return run(cmd, *a, **kw)

    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native.subprocess, "run", spy)
    lib = native.load()
    assert lib is not None
    so = native.library_path()
    assert so.parent == tmp_path / "_build" and so.exists()
    assert so.name.startswith("libbtio-") and lib._name == str(so)
    assert native.SOURCE == ROOT / "gr_bluetooth_tpu_torch" / "native" / \
        "btio.cc"
    (cmd,) = calls
    assert cmd[0] == "g++" and cmd[-1] == str(native.SOURCE)
    assert not any(str(ROOT / "native") in str(c) for c in cmd)
    after = {p.name: p.stat().st_size for p in (ROOT / "native").iterdir()}
    assert after == before
    # a second load reuses the library without building
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.load() is not None and len(calls) == 1


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontend.FrontEnd(8e6, 2441e6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lap_survey.LapSurvey(8e6, 2441e6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KismetSource(8e6, 2441e6)
    fe = frontend.FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedFrontEnd(fe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


@pytest.mark.parametrize("kw", [dict(sample_rate=5e6),
                                dict(sample_rate=7.68e6)])
def test_unported_paths_raise(kw):
    """The odd and off-grid rates, once unported, build their front ends:
    5 Msps the strided conv bank, whose one step is device_step (its
    fused_step raises), 7.68 Msps the resampler to 8 Msps and the
    polyphase bank on the true band's channels.  The banks themselves
    still refuse the rates they cannot take."""
    fe = frontend.FrontEnd(center_freq=2441e6, device="cpu", **kw)
    if kw["sample_rate"] == 5e6:
        assert not fe.is_pfb and fe.resampler is None
        assert fe.bank.decim == 2 and fe.bank.ch_sps == 2.5
        with pytest.raises(ValueError, match="no fused chain"):
            fe.fused_step(np.zeros((2, fe.block_samples), np.float32))
        with pytest.raises(ValueError, match="even"):
            pfb.make_pfb_bank(5e6, 2441e6)
    else:
        assert fe.is_pfb and fe.resampler is not None
        assert fe.bank.fs == 8e6 and fe.input_rate == 7.68e6
        assert fe.bank.channels == tuple(range(36, 43))
        with pytest.raises(ValueError, match="integer multiple"):
            pfb.make_pfb_bank(7.68e6, 2441e6)


def test_wrappers_take_cpu_or_cuda_only():
    from gr_bluetooth_tpu_torch.ops import demod_kernel, detect_kernel
    m = torch.device("meta")
    with pytest.raises(ValueError):
        pfb.deinterleave(torch.zeros((2, 400), device=m), 40)
    with pytest.raises(ValueError):
        pfb_kernel.pfb_channelize(torch.zeros((2, 2, 30), device=m),
                                  torch.zeros((7, 2), device=m),
                                  torch.zeros((7, 2), device=m),
                                  torch.zeros((4, 3), device=m),
                                  torch.zeros((4, 3), device=m),
                                  torch.zeros(3, device=m))
    with pytest.raises(ValueError):
        detect_kernel.detect_words(torch.zeros((2, 8), dtype=torch.int32,
                                               device=m), 32, 1,
                                   torch.zeros(75, dtype=torch.int32,
                                               device=m))
    h = torch.zeros((7, 2), device=m)
    with pytest.raises(ValueError):
        pfb_kernel.pfb_snr(torch.zeros((2, 400), device=m), h, h,
                           torch.zeros((4, 3), device=m),
                           torch.zeros((4, 3), device=m),
                           torch.zeros(3, device=m), 50)
    with pytest.raises(ValueError):
        demod_kernel.demod_pack(torch.zeros((2, 2048), device=m),
                                torch.zeros((2, 2048), device=m), 1.0, 512,
                                torch.zeros(3, device=m),
                                torch.zeros(3, device=m), 1)


def test_new_wrappers_check_their_input():
    """deinterleave and pfb_channelize refuse a wrong dtype or shape on
    any device, before they pick a version."""
    with pytest.raises(TypeError):
        pfb.deinterleave(torch.zeros((2, 400), dtype=torch.float64), 40)
    with pytest.raises(TypeError):
        pfb.deinterleave(torch.zeros((3, 400)), 40)
    with pytest.raises(ValueError):
        pfb.deinterleave(torch.zeros((2, 30)), 40)
    b = pfb.make_pfb_bank(4e6, 2441e6)
    bank = [torch.from_numpy(a.copy()) for a in
            (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd)]
    Q, D = b.h0.shape
    with pytest.raises(ValueError, match="n_x"):
        pfb_kernel.pfb_channelize(torch.zeros((2, D, 2 * Q)), *bank)
    with pytest.raises(ValueError, match="n_x"):
        pfb_kernel.pfb_channelize(torch.zeros((2, D + 1, 50)), *bank)
    with pytest.raises(TypeError):
        pfb_kernel.pfb_channelize(
            torch.zeros((2, D, 50), dtype=torch.float64), *bank)
