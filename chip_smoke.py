#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gr_bluetooth_tpu_torch) on one
NVIDIA card, at the full-band configuration: 80 Msps centred on
2441 MHz, 79 BR channels + the probe row, 64-slot blocks.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit, from nvidia-smi;
2. build the three CUDA kernels from csrc/ (nvcc, one process each);
3. on one full-band block, run each kernel and its plain PyTorch version
   on the same device tensors and hold them together:
       pfb_snr       y within 2e-5, slot SNR within 1e-3 dB
       demod_pack    at most 1 mismatched symbol per 10^5
       detect_words  exact
   and time each with CUDA events beside the plain version (and, for
   pfb_snr, beside a cuDNN conv1d computing the same channel streams);
   then time the block's whole device step and profile a few steps;
4. the main path: LapSurvey(80e6, 2441e6, block_slots=64).run over a
   synthesized capture of a few blocks with ID packets of 7 LAPs planted
   on 24 channels (0 and 78 among them), several per slot, through the
   pipelined stream.  Every planted (LAP, channel) must be reported at
   its slot (+-1), no other LAP may be, and every kernel's launch count
   must equal the number of blocks.  The same capture runs once more,
   warm, for the steady-state rate and its stage breakdown;
5. a small reference: an 8 Msps survey on the card against the plain
   versions on the CPU — same observations, SNR within 1e-3 dB.

The next-to-last line is {"kernels": [...]} (times in ms on this card;
bound_ms is the larger of bytes / 3.35 TB/s and operations over the peak
rate of their type: 67 T/s for float32, 16.75 T/s for int32 and logical
operations); the last line is {"ok": true, "device": {...}}.  With no
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gr_bluetooth_tpu_torch.core.access_code import ac_bits
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.models.lap_survey import LapSurvey
from gr_bluetooth_tpu_torch.ops import (demod_kernel, detect_kernel,
                                        pfb_kernel, snr, synth)
from gr_bluetooth_tpu_torch.utils import cuda_build

FS, CENTER, BLOCK_SLOTS, N_BLOCKS = 80e6, 2441e6, 64, 3
LAPS = (0x24D952, 0x9E8B33, 0x123456, 0xABCDEF, 0x5A17EC, 0x000F0F,
        0xC0FFEE)
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
FP32_OPS = 67e12           # H100 SXM non-tensor float32, operations/s
# int32 add/shift/logical: 64 lanes per SM against float32's 128, one
# operation per lane and clock where the float32 rate counts an FMA as 2
INT32_OPS = FP32_OPS * 64 / 128 / 2
KERNELS = (pfb_kernel.pfb_snr, demod_kernel.demod_pack,
           detect_kernel.detect_words)
REPLACES = {
    "pfb_snr": "gr_bluetooth_tpu/ops/pfb_kernel.py:559",
    "demod_pack": "gr_bluetooth_tpu/ops/pfb_kernel.py:559",
    "detect_words": "gr_bluetooth_tpu/ops/detect_pallas.py:200",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def plant_capture(fe, n_blocks: int, seed: int = 1):
    """Wideband capture of exactly n_blocks steps (plus the overlap) with
    ID packets (72-symbol access code + 60 random symbols) of LAPS on up
    to 24 of the bank's channels, the first and last among them, four
    packets per slot on different channels.  Returns (complex64 samples,
    [(lap, channel, slot)])."""
    r = np.random.default_rng(seed)
    ch_all = fe.bank.channels
    pick = np.unique(np.linspace(0, len(ch_all) - 1,
                                 min(24, len(ch_all))).round().astype(int))
    chans = [ch_all[i] for i in pick]
    n_slots = n_blocks * fe.block_slots
    sps = fe.bank.sps
    plan, planted, busy = [], [], set()
    for i in range(5 * len(chans)):
        ch = chans[i % len(chans)]
        slot = 1 + ((i // 4) * 11) % (n_slots - 3)
        if {(ch, slot - 1), (ch, slot), (ch, slot + 1)} & busy:
            continue
        busy.add((ch, slot))
        lap = LAPS[i % len(LAPS)]
        bits = np.concatenate([ac_bits(lap)[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        start = (slot * 625 + int(r.integers(0, 400))) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        planted.append((lap, ch, slot))
    n = fe.overlap_samples + n_blocks * fe.step_samples
    x = synth.synthesize_capture(plan, n_samples=n, fs=fe.input_rate,
                                 center_freq=fe.bank.center_freq,
                                 noise_std=0.02, seed=seed)
    return x, planted


def check_survey(observations, planted, start_clkn: int = 0):
    """Every planted (lap, channel) reported at its slot +-1, and every
    observation is a planted packet.  Returns the matched count."""
    want = {}
    for lap, ch, slot in planted:
        want.setdefault((lap, ch), []).append(slot + start_clkn)
    seen = set()
    for o in observations:
        slots = want.get((o.lap, o.channel))
        assert slots is not None, \
            f"unplanted LAP {o.lap:06x} on channel {o.channel}"
        assert any(abs(o.clkn - s) <= 1 for s in slots), \
            f"LAP {o.lap:06x} ch {o.channel} at clkn {o.clkn}, planted {slots}"
        seen.add((o.lap, o.channel))
    missing = set(want) - seen
    assert not missing, f"planted but not reported: {sorted(missing)}"
    return len(seen)


def conv_bank_weights(h0, h1, dft_c, dft_s):
    """(2C, 2, Q*M) conv1d weights whose stride-D convolution of the
    (re, im) planes gives the channel streams before the (-1)^{cn}
    rotator: rows 0..C-1 yr, rows C..2C-1 yi.  The library yardstick for
    pfb_snr; the port never calls it."""
    Q, D = h0.shape
    M = 2 * D
    h = torch.cat([h0, h1], 1).reshape(-1)             # h[qM + m]
    m = torch.arange(Q * M, device=h.device) % M
    cos = dft_c[m].T * h                               # (C, QM)
    sin = dft_s[m].T * h
    return torch.cat([torch.stack([cos, sin], 1),
                      torch.stack([-sin, cos], 1)], 0).contiguous()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(n_bytes: float, n_ops: float, ops_rate: float = FP32_OPS):
    tb, to = n_bytes / HBM_BPS * 1e3, n_ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _csa_ops(n_planes: int) -> int:
    """Two-input operations of the carry-save popcount of n one-bit
    planes (detect_pallas._csa_reduce): 5 per full adder, 2 per half."""
    levels, ops, w = [n_planes], 0, 0
    while w < len(levels) and levels[w]:
        levels.append(0)
        while levels[w] >= 3:
            levels[w] -= 2
            levels[w + 1] += 1
            ops += 5
        if levels[w] == 2:
            levels[w] -= 1
            levels[w + 1] += 1
            ops += 2
        w += 1
    return ops


def detect_ops_per_word(max_err: int) -> int:
    """Two-input integer operations that the bit-sliced detector
    (detect_pallas._kernel) spends on one 32-offset word: 65 funnel-shift
    views (one instruction each on this card), the affine prediction's
    XORs and complements, 68 error XORs, the carry-save popcounts of the
    68 error, 5 preamble and 7 Barker planes, the gate's equality planes,
    err <= max_err over 7 counter planes, the hit AND and the tail mask."""
    a68 = detect_kernel.A68
    views = sum(1 for j in range(68) if j % 32)
    pred = sum(max(int(a68[j].sum()) - 1, 0) + (int(detect_kernel.C68V[j])
                                                & 1) for j in range(68))
    nots = bin(0x15).count("1") + bin(0x27).count("1")
    csa = _csa_ops(68) + _csa_ops(5) + _csa_ops(7)

    def eq(k):                      # equality with k over 3 counter planes
        return sum(1 for b in range(3) if not (k >> b) & 1) + 2
    gate = (sum(eq(k) for k in (0, 5, 1, 4)) + 2 + 2 +
            sum(eq(k) for k in (0, 7, 1, 6, 2, 5)) + 3 + 7)
    le = sum(4 if (max_err >> b) & 1 else 2 for b in range(7)) + 1
    return views + pred + 68 + nots + csa + gate + le + 1 + 2


def kernel_checks(fe, xb):
    """Phase 3: each kernel against its plain version on one block."""
    c, s = fe.consts, fe.statics
    Q, D = c["h0"].shape
    C, M = c["dft_c"].shape[1], 2 * D
    n, n_data, S, n_k, n_frames = frontend.step_geometry(
        xb.shape[1], Q, D, s["n_sym"], s["slot_ch"], c["probe_re"].shape[0])
    bank = (c["h0"], c["h1"], c["dft_c"], c["dft_s"], c["bin_odd"])
    rows = {}

    # ---- pfb_snr
    yr, yi, oe = pfb_kernel.pfb_snr(xb, *bank, n_frames)
    pr, pi, poe = pfb_kernel.pfb_snr_plain(xb, *bank, n_frames)
    torch.cuda.synchronize()
    err_y = max((yr - pr).abs().max().item(), (yi - pi).abs().max().item())
    print(f"pfb_snr: y {tuple(yr.shape)} max |kernel - plain| = {err_y:.3e}"
          f" (tolerance 2e-5)")
    assert err_y <= 2e-5, err_y
    G = n_frames // pfb_kernel.TF
    w = conv_bank_weights(*bank[:4])
    lib = lambda: torch.nn.functional.conv1d(xb[None], w, stride=D)  # noqa
    ly = lib()[0]
    sign = 1.0 - 2.0 * (c["bin_odd"][:, None] *
                        (torch.arange(ly.shape[1], device=xb.device) & 1))
    err_lib = max((ly[:C] * sign - yr[:, :ly.shape[1]])[:, :n].abs().max()
                  .item(), (ly[C:] * sign - yi[:, :ly.shape[1]])[:, :n]
                  .abs().max().item())
    print(f"pfb_snr: cuDNN conv1d yardstick max |conv - kernel| = "
          f"{err_lib:.3e} over {n} frames")
    flops = n_frames * (C * M * 8 + 2 * M * Q * 2 + C * 4)
    nbytes = xb.numel() * 4 + 2 * C * n_frames * 4 + C * G * 4
    b_ms, b_by = bound(nbytes, flops)
    rows["pfb_snr"] = dict(
        max_abs_err=err_y,
        ms=time_ms(lambda: pfb_kernel.pfb_snr(xb, *bank, n_frames), 50),
        plain_ms=time_ms(lambda: pfb_kernel.pfb_snr_plain(xb, *bank,
                                                          n_frames), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 20))

    # ---- demod_pack (+ the slot SNR its probe energies feed)
    args = (yr, yi, s["demod_gain"], s["n_sym"], c["probe_re"],
            c["probe_im"], n_k, n_data)
    words, pe = demod_kernel.demod_pack(*args)
    pwords, ppe = demod_kernel.demod_pack_plain(*args)
    torch.cuda.synchronize()
    diff = detect_kernel.popcount((words ^ pwords).to(torch.int64)
                                  & 0xFFFFFFFF).sum().item()
    n_bits = words.shape[0] * s["n_sym"]
    err_pe = ((pe - ppe).abs() / ppe.abs().clamp(min=1e-30)).max().item()
    print(f"demod_pack: words {tuple(words.shape)}: {diff} mismatched "
          f"symbols of {n_bits} (tolerance {n_bits * 1e-5:.1f}); probe "
          f"energies max relative difference {err_pe:.3e}")
    assert diff <= n_bits * 1e-5, diff
    snr_k = snr.assemble_slot_snr(oe, pe, S=S, slot_ch=s["slot_ch"],
                                  kappa=s["kappa"], tile=pfb_kernel.TF)
    snr_p = snr.assemble_slot_snr(poe, ppe, S=S, slot_ch=s["slot_ch"],
                                  kappa=s["kappa"], tile=pfb_kernel.TF)
    err_snr = (snr_k - snr_p).abs().max().item()
    print(f"slot SNR {tuple(snr_k.shape)}: max |kernel - plain| = "
          f"{err_snr:.3e} dB (tolerance 1e-3)")
    assert err_snr <= 1e-3, err_snr
    n_groups = demod_kernel.n_groups(s["n_sym"], n_k)
    F_read = min(n_frames, n_groups * demod_kernel.GROUP_FRAMES + 2)
    T = c["probe_re"].shape[0]
    # per row: discriminator ~32 ops per frame (products 6, atan2_poly
    # ~25, gain 1); timing 16 hypotheses x (lerp 3, abs, sum) = 80 and
    # slicer + pack ~4 per symbol; probe 8 per tap per grid point
    ops = C * (F_read * 32 + n_groups * demod_kernel.GROUP * 84 + n_k * T * 8)
    nbytes = 2 * C * F_read * 4 + words.numel() * 4 + pe.numel() * 4
    b_ms, b_by = bound(nbytes, ops)
    rows["demod_pack"] = dict(
        max_abs_err=float((pe - ppe).abs().max().item()),
        mismatched_symbols=int(diff),
        ms=time_ms(lambda: demod_kernel.demod_pack(*args), 50),
        plain_ms=time_ms(lambda: demod_kernel.demod_pack_plain(*args), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- detect_words on the block's words (probe row dropped)
    wd = words[:-1]
    n_off = s["n_sym"] - 72 + 1
    dargs = (wd, n_off, s["max_ac_errors"], c["ac_masks"])
    hit, gate = detect_kernel.detect_words(*dargs)
    phit, pgate = detect_kernel.detect_words_plain(*dargs)
    torch.cuda.synchronize()
    n_diff = int((hit != phit).sum().item() + (gate != pgate).sum().item())
    print(f"detect_words: planes {tuple(hit.shape)}: {n_diff} differing "
          f"words (exact required); {int(detect_kernel.popcount(hit.to(torch.int64) & 0xFFFFFFFF).sum().item())} "
          f"hits, {int(detect_kernel.popcount(gate.to(torch.int64) & 0xFFFFFFFF).sum().item())} gates")
    assert n_diff == 0
    # the bit-sliced form's operations, 32 offsets per word, at the int32
    # rate (this kernel's one-offset-per-thread form spends more)
    ops = hit.numel() * detect_ops_per_word(s["max_ac_errors"])
    nbytes = wd.numel() * 4 + 2 * hit.numel() * 4
    b_ms, b_by = bound(nbytes, ops, INT32_OPS)
    print(f"detect_words: {detect_ops_per_word(s['max_ac_errors'])} int32 "
          f"operations per 32-offset word, {ops:.4g} in all")
    rows["detect_words"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: detect_kernel.detect_words(*dargs), 50),
        plain_ms=time_ms(lambda: detect_kernel.detect_words_plain(*dargs),
                         10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for name, r in rows.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{r['library_ms']}")
    return rows


def step_profile(fe, xb, reps: int = 20):
    """Phase 3b: one block's whole device step (kernels and the torch
    glue between them) timed with CUDA events, and a torch.profiler
    window over a few steps: device time by kernel, and the device's
    busy share of the CUDA-event step time (the profiler's own overhead
    stretches its window's host clock, so that is not the denominator).
    Returns {kernel name: its profiled device ms per step}."""
    ms = time_ms(lambda: fe.device_step(xb), reps)
    print(f"device step: {ms:.4f} ms per block (CUDA events, {reps} steps)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fe.device_step(xb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op's device time repeats that of
    # the kernels it launched
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and
           e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / n
    assert busy > 0, "the profiler saw no device time"
    print(f"profiler: {n} steps, device busy {busy:.4f} ms per step = "
          f"{100 * busy / ms:.1f}% of the {ms:.4f} ms CUDA-event step "
          f"(profiled window {wall * 1e3 / n:.3f} ms per step, host clock)")
    for e in evs[:12]:
        print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms/step "
              f"{e.count // n:4d} calls/step  {e.key[:70]}")
    prof_ms = {}
    for k in KERNELS:
        name = k.__name__
        t = [e.self_device_time_total for e in evs
             if e.key.startswith(f"{name}_kernel")]
        assert t, f"{name}_kernel not in the profile"
        prof_ms[name] = sum(t) / n / 1e3
    return prof_ms


def main_path(survey, n_blocks: int):
    """Phase 4: the survey over a planted capture, counters read around
    exactly this run; then the same capture again, warm, for the
    steady-state host-clock rate and its stage breakdown."""
    from gr_bluetooth_tpu_torch.utils.metrics import metrics
    x, planted = plant_capture(survey.fe, n_blocks)
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    obs = list(survey.run(x, emit_console=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    n_found = check_survey(obs, planted)
    n_in = n_blocks * survey.fe.step_samples
    print(f"main path: {n_blocks} blocks of {survey.fe.block_slots} slots, "
          f"{len(planted)} packets planted, {len(obs)} observations, "
          f"{n_found} (LAP, channel) pairs found; launches {launches}")
    print(f"main path: {n_in / dt:.6g} samples/s host clock to synchronize "
          f"({dt:.4f} s for {n_in} samples), peak device memory "
          f"{peak / 2 ** 20:.1f} MiB")
    for name, n in launches.items():
        assert n == n_blocks, (name, n, n_blocks)

    metrics.reset()
    survey.observations.clear()
    t0 = time.perf_counter()
    again = list(survey.run(x, emit_console=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_survey(again, planted)
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in again] == [key(o) for o in obs]
    print(f"main path, warm: {n_in / dt:.6g} samples/s host clock "
          f"({dt:.4f} s); stages:")
    print(metrics.report())
    return launches


def small_reference():
    """Phase 5: an 8 Msps survey on the card against the plain versions
    on the CPU."""
    kw = dict(block_slots=8)
    gpu = LapSurvey(8e6, 2441e6, **kw)
    cpu = LapSurvey(8e6, 2441e6, device="cpu", **kw)
    x, planted = plant_capture(gpu.fe, 2, seed=5)
    og = gpu.run(x, emit_console=False)
    oc = cpu.run(x, emit_console=False)
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in og] == [key(o) for o in oc]
    d = max((abs(a.snr_db - b.snr_db) for a, b in zip(og, oc)), default=0.0)
    assert d <= 1e-3, d
    n = check_survey(og, planted)
    print(f"small reference: 8 Msps, {len(og)} observations equal on the "
          f"card and the CPU, SNR within {d:.2e} dB, {n} pairs found")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in cuda_build.build_logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")

    survey = LapSurvey(FS, CENTER, block_slots=BLOCK_SLOTS)
    fe = survey.fe
    x, _ = plant_capture(fe, 1, seed=9)
    xb = fe.to_planes(x[: fe.block_samples])
    rows = kernel_checks(fe, xb)
    for name, t in step_profile(fe, xb).items():
        rows[name]["profiler_ms"] = t
        print(f"{name}: {rows[name]['ms']:.4f} ms per launch (CUDA events, "
              f"back-to-back wrapper calls), {t:.4f} ms device time "
              f"(profiler, in the step)")
    launches = main_path(survey, N_BLOCKS)
    small_reference()

    out = []
    for k in KERNELS:
        name = k.__name__
        r = rows[name]
        out.append(dict(name=name, route="cuda",
                        source=f"gr_bluetooth_tpu_torch/csrc/{name}.cu",
                        replaces=REPLACES[name], launches=launches[name],
                        **r))
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
