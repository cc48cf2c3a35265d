"""The port's benchmark (gr_bluetooth_tpu_torch/bench.py) on the CPU at a
small size, against the JAX system's own bench.py (the root module) and
the JAX package's modules.

Inputs are captures made from a seed with numpy at 8 Msps (7 of the 79
channels), in blocks of 8 or 16 slots:

  * the stream runner's checksum over n blocks equals bench.py's
    make_stream_runner's (the JAX staged step, its Pallas kernels in
    interpret mode), exactly; the parity runner's counts and hit tables
    equal make_parity_runner's;
  * the ingest runner, for each wire: every block's checksum and the
    final carry (bit for bit) equal make_ingest_runner's on the same
    carry and wire blocks;
  * the sniffer end to end, an operating point and the two hostile
    loads: the decoded packets (slot, channel, LAP, UAP, type), every
    decoded_* count and the hits equal those of the JAX package's
    Sniffer, PipelinedIngest and ParallelHostDecoder run as bench.py's
    loop bodies run them, at this size;
  * run(device="cpu") at a small size gives bench.py's JSON keys (read
    from bench.py by AST) plus device_kind and power_limit_w; at full
    band the roofline has no TPU key and its modeled time is the sum of
    the kernels' bounds from the shared cost functions, which are
    chip_smoke.py's kernel-table arithmetic;
  * chip_smoke.py's phase-10 check accepts a line that meets it and
    refuses one that does not.
"""
import ast
import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from gr_bluetooth_tpu import testing as jtesting
from gr_bluetooth_tpu.io import ingest as jingest
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.models.parallel_host import \
    ParallelHostDecoder as JPool
from gr_bluetooth_tpu.models.sniffer import Sniffer as JSniffer
from gr_bluetooth_tpu_torch import bench
from gr_bluetooth_tpu_torch.io.ingest import wire_encode
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd, step_geometry
from gr_bluetooth_tpu_torch.ops import demod_kernel, pfb_kernel
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import pallas_interpret, planted

ROOT = Path(__file__).resolve().parent.parent
FS, CENTER = 8e6, 2441e6
K = 3                     # distinct blocks
SLOTS, BS = 128, 16       # the sniffer sections' capture and blocks


@pytest.fixture(scope="module")
def fronts():
    """(JAX front end on its Pallas path, the port's on the CPU), the
    bench's configuration at 8 Msps in 8-slot blocks, and a planted
    capture of K blocks with access codes on every channel."""
    kw = dict(block_slots=8, max_ac_errors=1)
    fj = jfrontend.FrontEnd(FS, CENTER, use_pallas=True, **kw)
    ft = FrontEnd(FS, CENTER, device="cpu", **kw)
    x = planted(FS, 8 * K + 8, seed=4)
    need = K * ft.step_samples + ft.overlap_samples
    assert x.shape[1] >= need
    return fj, ft, x[:, :need]


def test_stream_runner_checksum_equals_jax(fronts):
    fj, ft, x = fronts
    with pallas_interpret():
        want = float(jbench.make_stream_runner(fj, K)(
            jax.device_put(jbench.stage_blocks(fj, x, K)), K + 1))
    xd = bench.stage_blocks(ft, x, K)
    assert xd.shape == (K, 2, ft.block_samples) and xd.dtype == torch.float32
    got = bench.make_stream_runner(ft, K)(xd, K + 1)
    assert got == want and got != 0.0


def test_parity_runner_equals_jax(fronts):
    fj, ft, x = fronts
    with pallas_interpret():
        jn, jtab = (np.asarray(o) for o in jbench.make_parity_runner(fj, K)(
            jax.device_put(jbench.stage_blocks(fj, x, K))))
    n, tab = bench.make_parity_runner(ft, K)(bench.stage_blocks(ft, x, K))
    assert np.array_equal(n.numpy(), jn) and np.array_equal(tab.numpy(), jtab)
    assert (jn >= 5).all()


@pytest.mark.parametrize("name,wire,np_dtype,scale,full",
                         bench.INGEST_WIRES,
                         ids=[w[0] for w in bench.INGEST_WIRES])
def test_ingest_runner_equals_jax(fronts, name, wire, np_dtype, scale, full):
    fj, ft, x = fronts
    ov, st = ft.overlap_samples, ft.step_samples
    if wire == "i4":
        xi = wire_encode(x, wire)
        blocks = [np.ascontiguousarray(xi[ov + i * st: ov + (i + 1) * st])
                  for i in range(K - 1)]
    else:
        xc = np.clip(x * scale, -full, full - 1).astype(np_dtype)
        blocks = [np.ascontiguousarray(xc[:, ov + i * st: ov + (i + 1) * st])
                  for i in range(K - 1)]
    k = K + 1                        # wraps round the blocks, as bench does
    jstep = jbench.make_ingest_runner(fj, np_dtype, 1.0 / full, wire=wire)
    carry, want = jax.device_put(x[:, :ov]), []
    with pallas_interpret():
        for i in range(k):
            carry, acc = jstep(carry, jax.device_put(blocks[i % len(blocks)]))
            want.append(float(acc))
    step = bench.make_ingest_runner(ft, np_dtype, 1.0 / full, wire=wire)
    _, accs, got_carry = bench.run_ingest(step, torch.from_numpy(x[:, :ov]),
                                          blocks, k)
    assert [float(a) for a in accs] == want
    assert got_carry is step.carry
    assert np.array_equal(got_carry.numpy().view(np.int32),
                          np.asarray(carry).view(np.int32))
    assert max(want) > 0


def _pkt(p):
    return (p.clkn, p.channel, p.lap, p.uap, p.packet_type)


def _planes(samples):
    return np.stack([samples.real, samples.imag]).astype(np.float32)


def test_sniffer_e2e_equals_jax():
    """bench_sniffer_e2e's warm Sniffer against the JAX package's, as
    bench.py:447-451 runs it."""
    sec, decoded = bench.sniffer_e2e(fs=FS, n_slots=SLOTS, block_slots=BS,
                                     reps=1, device="cpu")
    samples, sent = jtesting.make_piconet_capture(
        jtesting.PiconetSim(lap=jbench.LAP, uap=jbench.UAP, clk0=0x12780),
        n_slots=SLOTS, fs=FS, center_freq=CENTER, seed=13,
        tx_slots=range(0, SLOTS - 8, 2), noise_std=0.02)
    js = JSniffer(FS, CENTER, block_slots=BS)
    js.run_blocks(iter(list(js.fe.stream(_planes(samples)))))
    assert sec["planted_pkts"] == len(sent)
    assert sec["decoded_pkts"] == len(js.decoded) == len(decoded) >= 3
    assert [_pkt(p) for p in decoded] == [_pkt(p) for p in js.decoded]


def test_operating_point_equals_jax():
    """One e2e operating point (int8 wire, 16-slot blocks) against
    bench.py:543-557's loop body on the JAX package's modules."""
    got, decoded = bench.e2e_point(FS, "i8", 10.0, SLOTS, BS, reps=1,
                                   device="cpu")
    samples, sent = jtesting.make_piconet_capture(
        jtesting.PiconetSim(lap=jbench.LAP, uap=jbench.UAP, clk0=0x12780),
        n_slots=SLOTS, fs=FS, center_freq=CENTER, seed=13,
        tx_slots=range(0, SLOTS - 8, 2), noise_std=0.02)
    x = _planes(samples)
    sn = JSniffer(FS, CENTER, block_slots=BS, squelch_threshold=10.0)
    bank = set(sn.fe.bank.channels)
    planted_in_band = sum(1 for s, c, _ in sent if c in bank and s >= 1)
    carry, chunks = jingest.wire_chunks(x, sn.fe, "i8", pad_tail=True)
    sn.run_blocks(jingest.PipelinedIngest(sn.fe, "i8").run(
        iter([np.ascontiguousarray(c) for c in chunks]), 0,
        initial_carry=carry))
    assert got["planted_in_band"] == planted_in_band >= 3
    assert got["decoded"] == len(sn.decoded) == planted_in_band
    assert [_pkt(p) for p in decoded] == [_pkt(p) for p in sn.decoded]
    assert got["wire"] == "i8" and got["n_slots"] == SLOTS


def _jax_hostile(name, x, reps, n_workers):
    """bench.py:360-407's loop body on the JAX package's modules at this
    size: the counts and each decode mode's packets."""
    sn = JSniffer(FS, CENTER, block_slots=BS)
    blocks = list(sn.fe.stream(x))
    sec = {"hits": sum(len(r.hits) for r in blocks)}
    decoded = {}
    for mode, batch in (("scalar", False), ("batched", True)):
        s2 = JSniffer(FS, CENTER, block_slots=BS, batch_decode=batch)
        s2.run_blocks(iter(blocks))
        sec[f"decoded_{mode}"] = len(s2.decoded)
        decoded[mode] = list(s2.decoded)
        if not (name == "max_rate" and batch):
            for _ in range(reps):
                s2.run_blocks(iter(blocks))
    if name == "max_rate":
        s2b = JSniffer(FS, CENTER, block_slots=BS)
        s2b.run_blocks(iter(blocks))
        decoded["batched_run2"] = list(s2b.decoded)
        for _ in range(reps):
            s2.run_blocks(iter(blocks))
            s2b.run_blocks(iter(blocks))
        sec["decoded_batched_run2"] = len(s2b.decoded) // (reps + 1)
        with JPool(n_workers=n_workers) as pool:
            got = pool.drive(sn.fe, iter(blocks))
            for _ in range(reps):
                pool.drive(sn.fe, iter(blocks))
        sec[f"decoded_parallel{n_workers}"] = len(got)
        decoded["pool"] = got
    return sec, decoded


@pytest.mark.parametrize("name", ["mixed", "max_rate"])
def test_hostile_load_equals_jax(name, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")        # the pools' workers
    caps = bench.mode_captures(FS, CENTER, n_slots=SLOTS)
    samples, sent = caps[name]
    sims = [jtesting.PiconetSim(lap=lap, uap=uap, clk0=clk0)
            for lap, uap, clk0 in bench.PICONETS]
    maker = {"mixed": jtesting.make_hostile_capture,
             "max_rate": jtesting.make_multi_piconet_capture}[name]
    jsamples, jsent = maker(sims, SLOTS, FS, CENTER, seed=bench.MODE_SEED)
    assert np.array_equal(samples, jsamples) and sent == jsent
    sec, decoded = bench.hostile_load(name, samples, sent, FS, SLOTS,
                                      BS, reps=1, n_workers=2, device="cpu")
    want, jdecoded = _jax_hostile(name, _planes(samples), 1, 2)
    counts = {k: v for k, v in sec.items()
              if k == "hits" or k.startswith("decoded_")}
    assert counts == want and sec["planted_pkts"] == len(sent)
    assert decoded.keys() == jdecoded.keys()
    for mode, pkts in decoded.items():
        assert [_pkt(p) for p in pkts] == [_pkt(p) for p in jdecoded[mode]]
    assert min(want.values()) >= 3


def _bench_py_keys():
    """The keys of the dict that bench.py's main prints with json.dumps."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


@pytest.fixture(scope="module")
def small_run():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        yield bench.run(device="cpu", fs=4e6, n_slots=48, block_slots=8,
                        n_distinct=2, n1=1, n_ingest=1, reps=1,
                        points=(("band4MHz_int8", 4e6, "i8", 10.0, 48, 8),),
                        n_workers=2)
    finally:
        mp.undo()


def test_run_keys_equal_bench_py_keys(small_run):
    keys = _bench_py_keys()
    assert {"value", "roofline", "sniffer_hostile"} <= keys
    assert set(small_run) == keys | {"device_kind", "power_limit_w"}
    assert small_run["device_kind"] is None is small_run["power_limit_w"]
    roof = small_run["roofline"]
    assert roof["peaks"] is None and roof["modeled_ms"] is None
    assert roof["achieved_fraction"] is None and roof["actual_ms"] > 0
    assert 0 < len(roof["top_ops"]) <= 5
    assert set(small_run["e2e_operating_points"]) == {"band4MHz_int8", "note"}
    hostile = small_run["sniffer_hostile"]
    assert hostile["reps"] == 1 and "decoded_parallel2" in hostile["max_rate"]


def test_roofline_at_full_band_is_the_kernel_tables_sum():
    fe = FrontEnd(80e6, 2441e6, block_slots=64, max_ac_errors=1,
                  device="cpu")
    roof = bench.roofline(fe, 0.8e-3, "NVIDIA H100 80GB HBM3", 700.0)
    assert not [k for k in roof if "r3" in k or "r4" in k or "tpu" in k]
    assert roof["peaks"]["hbm_bytes_per_s"] == 3.35e12
    costs = bench.fused_costs(fe)
    assert list(costs) == list(roof["kernels"]) == ["pfb_snr", "demod_pack",
                                                    "detect_words"]
    want = sum(bench.bound(*c)[0] for c in costs.values())
    assert roof["modeled_ms"] == want
    assert roof["achieved_fraction"] == want / 0.8
    assert roof["hbm_bytes_per_block"] == sum(c[0] for c in costs.values())
    # the full-band bounds of the kernel table (ms): pfb_snr and demod_pack
    # by bytes, detect_words by operations
    got = {k: (round(r["bound_ms"], 4), r["bound_by"])
           for k, r in roof["kernels"].items()}
    assert got == {"pfb_snr": (0.025, "bytes"),
                   "demod_pack": (0.017, "bytes"),
                   "detect_words": (0.0026, "operations")}
    unknown = bench.roofline(fe, 0.8e-3, "NVIDIA A100-SXM4-80GB")
    assert unknown["peaks"] is None and unknown["modeled_ms"] is None
    assert unknown["achieved_fraction"] is None


def test_fused_costs_are_the_kernel_tables_arithmetic():
    """fused_costs(fe) at full band from chip_smoke.py's phase-3 formulas
    on the block's tensor shapes (x (2, N), y (C, n_frames), words (C,
    nw), pe (C, n_k), planes (C - 1, ceil(n_off / 32)))."""
    fe = FrontEnd(80e6, 2441e6, block_slots=64, max_ac_errors=1,
                  device="cpu")
    c, s = fe.consts, fe.statics
    Q, D = c["h0"].shape
    C, M, T = c["dft_c"].shape[1], 2 * D, c["probe_re"].shape[0]
    _, _, _, n_k, n_frames = step_geometry(fe.block_samples, Q, D,
                                           s["n_sym"], s["slot_ch"], T)
    G = n_frames // pfb_kernel.TF
    n_groups = demod_kernel.n_groups(s["n_sym"], n_k)
    F_read = min(n_frames, n_groups * demod_kernel.GROUP_FRAMES + 2)
    nw, n_hw = -(-s["n_sym"] // 32), -(-(s["n_sym"] - 71) // 32)
    ch = 4 * M * Q + min(8 * C * M, 5 * M * np.log2(M))
    instr = chip_smoke.detect_instr_per_word(1)["total"]
    assert bench.fused_costs(fe) == {
        "pfb_snr": (2 * fe.block_samples * 4 + 2 * C * n_frames * 4
                    + C * G * 4, n_frames * (ch + C * 4), bench.FP32_OPS),
        "demod_pack": (2 * C * F_read * 4 + C * nw * 4 + C * n_k * 4,
                       C * (F_read * 32 + n_groups * demod_kernel.GROUP * 84
                            + n_k * T * 8), bench.FP32_OPS),
        "detect_words": ((C - 1) * nw * 4 + 2 * (C - 1) * n_hw * 4,
                         (C - 1) * n_hw * instr, bench.INT32_OPS)}


def _good_line():
    """A bench line that meets phase 10's checks, with phase 3's rows."""
    rows = {"pfb_snr": {"bound_ms": 0.025}, "demod_pack": {"bound_ms": 0.017},
            "detect_words": {"bound_ms": 0.0026}}
    out = {"value": 3.8e9,
           "e2e_operating_points": {
               "band16MHz_int8": {"planted_in_band": 94, "decoded": 94},
               "band8MHz_int8": {"planted_in_band": 44, "decoded": 44}},
           "sniffer_hostile": {
               "mixed": {"decoded_scalar": 101, "decoded_batched": 101},
               "max_rate": {"decoded_scalar": 249, "decoded_batched": 250,
                            "decoded_batched_run2": 249,
                            "decoded_parallel8": 249}},
           "roofline": {"modeled_ms": 0.025 + 0.017 + 0.0026}}
    return out, rows


@pytest.mark.parametrize("fault", [
    None, "parity", "value", "point", "hostile", "mode", "roofline"])
def test_chip_smoke_check_bench(fault):
    out, rows = _good_line()
    stderr = ""
    bad = copy.deepcopy(out)
    if fault == "parity":
        stderr = "# parity FAIL: missing=[(3, 12)] laps=[]"
    elif fault == "value":
        bad["value"] = 0.0
    elif fault == "point":
        bad["e2e_operating_points"]["band8MHz_int8"]["decoded"] = 43
    elif fault == "hostile":
        bad["sniffer_hostile"]["max_rate"]["decoded_parallel8"] = 248
    elif fault == "mode":
        del bad["sniffer_hostile"]["max_rate"]["decoded_batched_run2"]
    elif fault == "roofline":
        bad["roofline"]["modeled_ms"] += 1e-9
    if fault is None:
        chip_smoke.check_bench(bad, stderr, rows)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_bench(bad, stderr, rows)
