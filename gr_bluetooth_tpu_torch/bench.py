"""Benchmark of the port: wideband IQ samples/s on one card, full
79-channel band.

The port of the JAX package's bench.py (at the repo root), section for
section and under the same names, on the port's modules.  It measures
the fused chain's compiled step (FrontEnd.compiled_step("fused"):
pfb_snr, demod_pack, slot SNR, detect_words, squelch, hit extraction and
window gather, one CUDA graph replay per block) streaming over blocks
held on the device, then checks LAP-detection parity against planted
ground truth (untimed).

    python -m gr_bluetooth_tpu_torch.bench [--device DEV]

runs on the CUDA device unless --device names another; with none and no
card it raises "no CUDA device".  --device cpu runs the plain PyTorch
versions at full size, which is for small debugging only: the tests call
run(device="cpu", ...) at small sizes.

Methodology:
  * The device loop replays the compiled step over K = N_DISTINCT blocks
    held on the device (stage_blocks); each iteration copies block i % K
    into the graph's static input (about 27.6 MB at full band: every
    iteration then depends on i, and a production ingest writes each
    block fresh anyway) and adds n_hits + tab[0, 1] + win[0, 0] into a
    device checksum on the step's stream before the next replay
    rewrites them.  The rate is the difference quotient between N1 and
    2 N1 blocks ((W2 - W1) / (t2 - t1)), host clock after a synchronize,
    which cancels the constant launch and read-back cost.
  * vs_baseline = value / 80e6: real time at full band (BASELINE.md).

Further sections of the JSON line:
  * ingest samples/s for int16, int8 and int4 wire blocks through the
    flat chain's compiled step (deinterleave, pfb_channelize,
    detect_words) with the carry and the wire -> float32 conversion on
    the device, the pageable host -> device copy of block i + 1 issued
    on a copy stream before step i is awaited; the raw pageable copy
    rate and the round trip of a one-element read that bound them;
  * the roofline at the port's kernel boundaries (pfb_snr reads x and
    writes y and its partials, demod_pack reads y and writes the words,
    detect_words reads the words and writes its planes), from the same
    byte and operation counts as chip_smoke.py's kernel table, against
    the card's published peaks; and the top five device ops of 32
    replayed blocks (torch.profiler), full names;
  * the sniffer end to end, the e2e operating points (wire bytes -> H2D
    -> step -> hit tables -> host decode, decode counts per point) and
    the hostile host-decode loads (scalar, batched twice, the
    multiprocess pool, discovery), median of reps with their spread.

Prints ONE JSON line: bench.py's keys, plus device_kind and
power_limit_w (nvidia-smi; null on the CPU).
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import testing
from .io.ingest import PipelinedIngest, wire_chunks, wire_decode, wire_encode
from .models.frontend import FrontEnd, step_geometry
from .models.parallel_host import ParallelHostDecoder
from .models.sniffer import Sniffer
from .ops import demod_kernel, detect_kernel, pfb_kernel
from .utils.device import resolve_device

__all__ = ["run", "main", "make_stream_runner", "stage_blocks",
           "make_ingest_runner", "run_ingest", "measure_raw_link",
           "make_parity_runner", "roofline", "top_ops",
           "bench_sniffer_hostile", "bench_sniffer_e2e",
           "bench_e2e_operating_points", "fused_costs", "bound"]

FS, CENTER = 80e6, 2441e6
BLOCK_SLOTS = 64
N_DISTINCT = 8
N1 = 128                      # timed blocks; second workload is 2*N1
N_INGEST = 16                 # timed ingest blocks; second is 2*N_INGEST
LAP, UAP = 0x24D952, 0x47

# Published peaks of one H100 (NVIDIA's data sheet, SXM part, dense, at
# its 700 W limit), keyed by torch.cuda.get_device_name.
# A card not listed gets null peaks: no guessed default.
HBM_BPS = 3.35e12          # device memory, bytes/s
FP32_OPS = 67e12           # float32 outside the tensor cores, operations/s
TF32_OPS = 495e12          # TF32 on the tensor cores
# int32 add/shift/logical: 64 lanes per SM against float32's 128, one
# operation per lane and clock where the float32 rate counts an FMA as 2
INT32_OPS = FP32_OPS * 64 / 128 / 2
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=HBM_BPS,
                                  fp32_ops_per_s=FP32_OPS,
                                  tf32_ops_per_s=TF32_OPS,
                                  int32_ops_per_s=INT32_OPS),
}

# the sniffer sections' piconets (bench.py:338-342, 438-442): (LAP, UAP,
# CLK1-27 at slot 0), 256 slots, seed 13; the first piconet is the e2e
# capture's
PICONETS = ((0x24D952, 0x47, 0x12780), (0x1A2B3C, 0x99, 0x00450),
            (0x654321, 0x13, 0x71111))
MODE_SLOTS, MODE_SEED = 256, 13

# bench.py:537-541: (name, rate, wire, squelch dB, slots, block slots).
# int4 runs at a 25 dB squelch (its quantization images pass 10 dB) and
# only at full band (its noise needs the decimation's averaging gain);
# narrow bands ship int8 in 128-slot blocks over longer captures
OPERATING_POINTS = (
    ("fullband_int4", FS, "i4", 25.0, 256, BLOCK_SLOTS),
    ("band32MHz_int8", 32e6, "i8", 10.0, 512, 128),
    ("band16MHz_int8", 16e6, "i8", 10.0, 1024, 128),
    ("band8MHz_int8", 8e6, "i8", 10.0, 1024, 128))

# bench.py:630-633: (name, wire, wire dtype, quantization scale, full
# scale); a block is (2, step) planes, or (step,) packed bytes for int4
INGEST_WIRES = (("int16", "i16", np.int16, 32767.0, 32768.0),
                ("int8", "i8", np.int8, 127.0, 128.0),
                ("int4", "i4", np.uint8, 8.0, 8.0))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- bounds

def bound(n_bytes: float, n_ops: float, ops_rate: float = FP32_OPS):
    """(ms, "bytes" or "operations"): the least time for n_bytes of
    device memory traffic and n_ops operations at ops_rate, the larger
    of the two."""
    tb, to = n_bytes / HBM_BPS * 1e3, n_ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def channelize_ops(C: int, M: int, Q: int) -> float:
    """Float32 operations per frame that the polyphase DFT channelizer's
    function needs: the branch FIRs (M complex outputs of Q real taps,
    4MQ) and the M-point complex DFT, as an FFT at the conventional
    5 M log2 M where that is fewer than the direct 8CM over the C
    covered bins.  The (-1)^{cn} rotator is a sign flip.  The kernels
    compute the DFT directly, as the TPU's MXU does; the bound does
    not."""
    return 4 * M * Q + min(8 * C * M, 5 * M * math.log2(M))


def _csa_instr(n_planes: int) -> int:
    """LOP3 instructions of the carry-save popcount of n one-bit planes
    as csrc/detect_words.cu:count takes it: two per full adder (XOR3 and
    majority), two per half adder (XOR and AND)."""
    n, instr = n_planes, 0
    while n > 1:
        full = (n - 1) // 2 if n >= 3 else 0
        half = int(n - 2 * full == 2)
        instr += 2 * (full + half)
        n = full + half                   # carries: the next weight
    return instr


def detect_instr_per_word(max_err: int, symbols=range(68)) -> dict:
    """This card's instructions (SHF for a funnel shift, LOP3 for any
    function of up to three inputs) that the bit-sliced detector needs
    for one 32-offset word, by part: "shf" the 65 views v_j with j % 32
    != 0; "pred" the error planes of `symbols` (all 68 by default): row
    j's plane v_j ^ pred_j is an XOR of popcount(row) + 1 terms, the
    complement C68[j] free inside a LOP3, a LAP symbol's own plane zero,
    and rows with equal masks share their LAP chain, so a group of g
    rows with p-term masks costs min(g ceil(p / 2), ceil((p - 1) / 2) +
    g); "csa" the popcount of the error planes; "gate" the preamble's and
    Barker's popcounts (6 and 8) and 6 for pre + bark <= 2; "le" err <=
    max_err over the 7 counter planes (2 per set bit of max_err, 1 per
    clear one) and the hit AND.  The tail mask (one word per row) is not
    counted.  "total" is their sum over all 68 symbols."""
    a68, c68 = detect_kernel.A68, detect_kernel.C68V
    rows = [int(sum(int(b) << k for k, b in enumerate(a68[j])))
            for j in range(68)]
    planes = [j for j in range(68)
              if not (38 <= j < 62 and not int(c68[j]) & 1 and
                      rows[j] == 1 << (j - 38))]
    groups: dict = {}
    for j in planes:
        if j in symbols:
            groups.setdefault(rows[j], []).append(j)
    pred = 0
    for row, js in groups.items():
        p, g = bin(row).count("1"), len(js)
        pred += min(g * -(-p // 2), -(-(p - 1) // 2) + g)
    k = min(max(max_err, 0), 127)
    parts = dict(shf=sum(1 for j in range(68) if j % 32), pred=pred,
                 csa=_csa_instr(len(planes)),
                 gate=_csa_instr(5) + _csa_instr(7) + 6,
                 le=sum(2 if (k >> b) & 1 else 1 for b in range(7)) + 1)
    parts["total"] = sum(parts.values())
    return parts


# Each kernel's cost on its arguments' shapes: (bytes, operations, the
# peak rate of their type).  Bytes count each input read once and each
# output written once.

def pfb_snr_cost(x_numel: int, C: int, M: int, Q: int, n_frames: int):
    """pfb_snr on x of x_numel floats: x in, y (2, C, n_frames) and the
    per-tile on-energies (C, n_frames / TF) out; the channelizer's
    operations and 4 per bin for the energies."""
    G = n_frames // pfb_kernel.TF
    return (x_numel * 4 + 2 * C * n_frames * 4 + C * G * 4,
            n_frames * (channelize_ops(C, M, Q) + C * 4), FP32_OPS)


def demod_pack_cost(C: int, n_frames: int, n_groups: int, n_k: int, T: int,
                    n_words: int, n_pe: int):
    """demod_pack over C rows: the frames its n_groups timing groups
    read of the y planes in, n_words packed words and n_pe probe
    energies out.  Per row: the discriminator ~32 operations per frame
    (products 6, atan2_poly ~25, gain 1); timing 16 hypotheses x (lerp
    3, abs, sum) = 80 and slicer + pack ~4 per symbol; the probe 8 per
    tap per grid point."""
    F_read = min(n_frames, n_groups * demod_kernel.GROUP_FRAMES + 2)
    ops = C * (F_read * 32 + n_groups * demod_kernel.GROUP * 84 +
               n_k * T * 8)
    return 2 * C * F_read * 4 + n_words * 4 + n_pe * 4, ops, FP32_OPS


def detect_words_cost(n_words: int, n_plane_words: int, max_err: int,
                      emit_err: bool = False):
    """detect_words: n_words packed words in, the hit and gate planes
    (and with emit_err the 7 error-count planes) of n_plane_words each
    out; the bit-sliced form's LOP3 and SHF instructions per 32-offset
    word (detect_instr_per_word) at the int32 rate."""
    planes = 2 + detect_kernel.N_ERR if emit_err else 2
    return (n_words * 4 + planes * n_plane_words * 4,
            n_plane_words * detect_instr_per_word(max_err)["total"],
            INT32_OPS)


def deinterleave_cost(xp_numel: int):
    """deinterleave: xp_numel floats read and written, no arithmetic."""
    return 2 * xp_numel * 4, 0, FP32_OPS


def pfb_channelize_cost(xp_numel: int, C: int, n_out: int, M: int, Q: int):
    """pfb_channelize: the branch rows in, y (2, C, n_out) out."""
    return (xp_numel * 4 + 2 * C * n_out * 4,
            n_out * channelize_ops(C, M, Q), FP32_OPS)


# le_detect's integer operations per offset (csrc/le_dist.cuh): on every
# row the two funnel-shift views, the header's shift, XOR and mask, its
# two byte indices and the preamble's mask, three table lookups, two adds
# and the compare with max_dist; on the advertising rows also the four AA
# byte indices (six shifts and masks), four lookups and four adds
LE_OPS_DATA, LE_OPS_ADV = 13, 27


def le_detect_cost(R: int, W: int, n_le: int, n_adv: int,
                   with_dist: bool = True):
    """le_detect over R LE rows of W words, n_adv of them advertising:
    the rows' words, the row constants (index, whitening word, aa_on,
    max_dist) and the four uint8 tables (2,560 bytes) in, the hit plane
    (R, ceil(n_le / 32)) out and, with_dist, the distances (R, n_le);
    LE_OPS_DATA or LE_OPS_ADV per offset of the 32 of every output word,
    at the int32 rate."""
    w_le = -(-n_le // 32)
    return (R * W * 4 + R * 20 + 2560 + R * w_le * 4 +
            (R * n_le * 4 if with_dist else 0),
            32 * w_le * ((R - n_adv) * LE_OPS_DATA + n_adv * LE_OPS_ADV),
            INT32_OPS)


# hit_table's integer operations (csrc/hit_table.cu): per plane word the
# squelch word (two selects, an OR) and its AND, the popcount and its add;
# per window word one funnel shift; per table row the epilogue (classic:
# the LAP's shift and mask, 24 masked XORs of three words, three XORs of
# C68, three popcounts and two adds; LE: le_dist's 27 at most)
HT_OPS_WORD, HT_OPS_ROW = 6, 90


def hit_table_cost(R: int, w: int, S: int, max_hits: int, ww: int, K: int,
                   le: bool, gate: bool = True):
    """hit_table over an (R, w) hit plane with K = min(count, max_hits)
    hits: the plane, the squelch word constants (int64 slot, int32 mask
    per column) and the (S, R) SNR columns it gates with, the row map,
    the epilogue's constants (75 int32 masks, or the 2,560-byte LE tables
    and 8 bytes of row constants per row) and the K hits' ww window words
    in; the count, the (max_hits, 4 or 3) table and the (max_hits, ww)
    windows out.  Operations as HT_OPS_WORD and HT_OPS_ROW, at the int32
    rate."""
    consts = (2560 + 8 * R + 8 * R) if le else 75 * 4
    n_in = R * w * 4 + ((12 * w + 4 * S * R) if gate else 0) + consts + \
        K * ww * 4
    n_out = 4 + max_hits * (3 if le else 4) * 4 + max_hits * ww * 4
    return (n_in + n_out, R * w * HT_OPS_WORD + K * (ww + HT_OPS_ROW),
            INT32_OPS)


def fused_costs(fe) -> dict:
    """{kernel: (bytes, operations, rate)} of the fused chain's three
    kernels on one block of fe (a polyphase bank), from its geometry:
    the arguments chip_smoke.py's kernel table passes from the tensors
    of a block."""
    c, s = fe.consts, fe.statics
    Q, D = c["h0"].shape
    C, T = c["dft_c"].shape[1], c["probe_re"].shape[0]
    _, _, _, n_k, n_frames = step_geometry(fe.block_samples, Q, D,
                                           s["n_sym"], s["slot_ch"], T)
    nw = -(-s["n_sym"] // 32)
    n_hw = -(-(s["n_sym"] - 72 + 1) // 32)
    return {
        "pfb_snr": pfb_snr_cost(2 * fe.block_samples, C, 2 * D, Q,
                                n_frames),
        "demod_pack": demod_pack_cost(
            C, n_frames, demod_kernel.n_groups(s["n_sym"], n_k), n_k, T,
            C * nw, C * n_k),
        "detect_words": detect_words_cost((C - 1) * nw, (C - 1) * n_hw,
                                          s["max_ac_errors"]),
    }


# --------------------------------------------------------- device loop

def stage_blocks(fe, x: np.ndarray, n_distinct: int) -> torch.Tensor:
    """Cut a long (2, N) capture into n_distinct blocks (K, 2,
    block_samples) float32 on fe's device, for make_stream_runner and
    make_parity_runner (the compiled steps take flat planes)."""
    st, bs = fe.step_samples, fe.block_samples
    blocks = np.stack([x[:, i * st: i * st + bs] for i in range(n_distinct)])
    return torch.from_numpy(np.ascontiguousarray(blocks, np.float32)).to(
        fe.device)


def make_stream_runner(fe, n_distinct: int):
    """run(x, n_blocks) -> checksum: n_blocks replays of the fused
    chain's compiled step over the blocks of x (stage_blocks), block
    i % n_distinct copied into the step's static input each time, and
    n_hits + tab[0, 1] + win[0, 0] of each replay added into a float32
    device checksum on the step's stream (before the next replay
    rewrites them), read back once at the end."""
    step = fe.compiled_step("fused")

    def run(x, n_blocks: int) -> float:
        acc = torch.zeros((), dtype=torch.float32, device=fe.device)
        with step.on_stream():
            for i in range(n_blocks):
                _, n_hits, tab, win, _, _, _ = step(x[i % n_distinct])
                acc.add_(n_hits).add_(tab[0, 1]).add_(win[0, 0])
        return float(acc)

    return run


def make_parity_runner(fe, n_distinct: int):
    """run(x) -> (n_hits (K,), hit tables (K, max_hits, 4)) of the fused
    chain's compiled step on each block of x, copied out on the step's
    stream after each replay."""
    step = fe.compiled_step("fused")

    def run(x):
        n_hits = torch.empty(n_distinct, dtype=torch.int32, device=fe.device)
        tabs = torch.empty((n_distinct, fe.max_hits, 4), dtype=torch.int32,
                           device=fe.device)
        with step.on_stream():
            for i in range(n_distinct):
                _, n, tab, _, _, _, _ = step(x[i])
                n_hits[i].copy_(n)
                tabs[i].copy_(tab)
        return n_hits, tabs

    return run


# ------------------------------------------------------------- ingest

class _OnDevice:
    """A wire block on the device and the event after its copy (None on
    the CPU, where the copy is done when put returns)."""

    def __init__(self, data, ready):
        self.data, self.ready = data, ready


class IngestRunner:
    """The ingest's compiled step: (carry, new wire block) -> (next
    carry, checksum), as bench.py's make_ingest_runner.  Its body
    converts the block to float32 on the device (int4 through
    wire_decode's nibble unpack), appends it to the carry, runs the flat
    chain (FrontEnd.device_step: deinterleave, pfb_channelize,
    detect_words and the torch glue), writes the next carry into its
    static carry and returns n_hits + tab[0, 1] + win[0, 0]; it is one
    CUDA graph on the front end's StepCache (a second compiled flat step
    beside fe.compiled_step("flat"), with its own static carry).

    put(block) copies a host block (pageable memory, as device_put) to
    the device on the runner's copy stream and records an event after
    it; the step's stream waits on that event before it reads the block.
    The carry is the step's static input: one run at a time."""

    def __init__(self, fe, np_dtype, scale: float, wire: str):
        self.fe, self.scale, self.wire = fe, scale, wire
        self.overlap = fe.block_samples - fe.step_samples
        shape = (fe.step_samples,) if wire == "i4" else (2, fe.step_samples)
        dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
        self.step = fe.graphs.build(self._body, [
            torch.zeros((2, self.overlap), dtype=torch.float32,
                        device=fe.device),
            torch.zeros(shape, dtype=dtype, device=fe.device)])
        self.copy_stream = (torch.cuda.Stream(device=fe.device)
                            if fe.device.type == "cuda" else None)

    def _body(self, carry, new):
        if self.wire == "i4":
            x_new = wire_decode(new, "i4")
        else:
            x_new = new.to(torch.float32) * self.scale
        xb = torch.cat([carry, x_new], 1)
        _, n_hits, tab, win, _, _, _ = self.fe.device_step(xb)
        acc = (n_hits.to(torch.float32) + tab[0, 1].to(torch.float32)
               + win[0, 0].to(torch.float32))
        carry.copy_(xb[:, -self.overlap:])
        return acc

    @property
    def carry(self) -> torch.Tensor:
        """The static carry: the carry after the last step."""
        return self.step.inputs[0]

    def put(self, block: np.ndarray) -> _OnDevice:
        host = torch.from_numpy(np.ascontiguousarray(block))
        if self.copy_stream is None:
            return _OnDevice(host.to(self.fe.device, copy=True), None)
        with torch.cuda.stream(self.copy_stream):
            data = host.to(self.fe.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return _OnDevice(data, ready)

    def __call__(self, carry, new: _OnDevice):
        st = self.step
        with st.on_stream():
            if new.ready is not None:
                torch.cuda.current_stream(self.fe.device).wait_event(
                    new.ready)
                new.data.record_stream(st.stream)
            if carry is not self.carry:
                self.carry.copy_(carry)
            acc = st(self.carry, new.data)[0].clone()
        return self.carry, acc


def make_ingest_runner(fe, np_dtype, scale: float, wire: str = "i16"):
    """The ingest step of wire blocks of np_dtype (bench.py:108): the
    device keeps the overlap-save tail and converts wire -> float32 (x
    scale; int4 packed bytes through the nibble decode), so the host ->
    device copy is exactly step_samples of wire IQ per block."""
    return IngestRunner(fe, np_dtype, scale, wire)


def run_ingest(step, carry0, blocks, k: int):
    """Double-buffered host -> device streaming: the copy of block i + 1
    is issued before step i is awaited (two blocks in flight).  Returns
    (wall seconds for k blocks, each block's checksum on the device,
    the final carry)."""
    n = len(blocks)
    accs = []
    carry = carry0
    d = step.put(blocks[0])
    _sync(step.fe.device)
    t0 = time.perf_counter()
    for i in range(k):
        d_next = step.put(blocks[(i + 1) % n])
        carry, acc = step(carry, d)
        accs.append(acc)
        d = d_next
    _sync(step.fe.device)
    return time.perf_counter() - t0, accs, carry


def measure_raw_link(n_bytes: int = 12_800_000, repeats: int = 8,
                     device=None):
    """Raw host -> device link: (GB/s of a pageable NumPy copy, the
    median round trip in ms of five one-element reads of a sum)."""
    device = resolve_device(device)
    host = torch.from_numpy(np.ones(n_bytes // 2, np.int16))
    host.to(device, copy=True)                        # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        host.to(device, copy=True)
        _sync(device)
    dt = time.perf_counter() - t0
    gbps = n_bytes * repeats / dt / 1e9
    tiny = torch.ones(8, dtype=torch.float32, device=device)
    float(tiny.sum())                                 # warm
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(tiny.sum())
        rtts.append(time.perf_counter() - t0)
    return gbps, float(np.median(rtts)) * 1e3


# ------------------------------------------------------------ roofline

def card_info(device):
    """(name, power limit in W) of `device`'s card from nvidia-smi, or
    (None, None) off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    name, limit = lines[device.index or 0].rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


def roofline(fe, dt_block: float, device_kind, power_limit_w=None) -> dict:
    """The fused chain's bytes and operations per block at the port's
    kernel boundaries, and the achieved fraction of the least time.

    pfb_snr reads the block x and writes y (the C + 1 channel streams
    incl. the probe row) and its energy partials; demod_pack reads y and
    writes the packed words and probe energies; detect_words reads the
    words and writes its hit and gate planes (fused_costs, the counts of
    chip_smoke.py's kernel table).  modeled_ms is the sum of the three
    kernels' bounds, each the larger of bytes over the card's memory
    rate and operations over the peak of their type; the torch glue
    (slot SNR assembly, squelch, extraction, windows) is not modelled.
    On a card without published peaks here (CARD_PEAKS) the peaks,
    the bounds and the fraction are null."""
    costs = fused_costs(fe)
    peaks = CARD_PEAKS.get(device_kind)
    kernels = {}
    for name, (n_bytes, n_ops, rate) in costs.items():
        row = dict(bytes=n_bytes, ops=n_ops,
                   ops_type="int32" if rate == INT32_OPS else "float32",
                   bound_ms=None, bound_by=None)
        if peaks is not None:
            row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, rate)
        kernels[name] = row
    modeled = (None if peaks is None else
               sum(r["bound_ms"] for r in kernels.values()))
    return {
        "device_kind": device_kind,
        "power_limit_w": power_limit_w,
        "peaks": peaks,
        "kernels": kernels,
        "hbm_bytes_per_block": sum(r["bytes"] for r in kernels.values()),
        "flops_per_block": sum(r["ops"] for r in kernels.values()),
        "flops_parts": {k: r["ops"] for k, r in kernels.items()},
        "bound": {k: r["bound_by"] for k, r in kernels.items()},
        "modeled_ms": modeled,
        "actual_ms": dt_block * 1e3,
        "achieved_fraction": (None if modeled is None
                              else modeled / (dt_block * 1e3)),
        "note": "least time at the port's kernel boundaries (pfb_snr: x "
                "in, y and partials out; demod_pack: y in, words out; "
                "detect_words: words in, planes out), summed over the "
                "three kernels; actual_ms is the device loop's replayed "
                "step, torch glue and the block copy included",
    }


def top_ops(fe, xd, run, n_blocks: int = 32) -> list:
    """The top five device ops (kernels, copies, memsets) by device time
    over n_blocks of the stream runner, from torch.profiler, with their
    full names: ms and calls per block.  On the CPU, the top five CPU
    ops by self time.  Raises if the profiler saw nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = fe.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(fe.device)
    with profile(activities=acts) as prof:
        run(xd, n_blocks)
        _sync(fe.device)
    if cuda:
        evs = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    else:
        evs = [(e.key, e.self_cpu_time_total, e.count)
               for e in prof.key_averages()]
    evs = sorted((e for e in evs if e[1] > 0), key=lambda e: -e[1])
    if not evs:
        raise RuntimeError("the profiler saw no op time")
    return [{"op": name, "ms_per_block": us / n_blocks / 1e3,
             "calls_per_block": count / n_blocks}
            for name, us, count in evs[:5]]


# ------------------------------------------------------- host decode

def _timed_reps(fn, reps: int):
    """Median + spread of `fn`'s wall time over reps (seconds)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def piconet_sims():
    return [testing.PiconetSim(lap=lap, uap=uap, clk0=clk0)
            for lap, uap, clk0 in PICONETS]


def mode_captures(fs: float, center: float, n_slots: int = MODE_SLOTS,
                  seed: int = MODE_SEED):
    """bench.py's three sniffer captures: {"max_rate": every slot a DM1
    of the three piconets in turn, "mixed": every slot busy with mixed
    1/3/5-slot DM/DH packets, "e2e": the first piconet alone, a DM1 in
    every other slot}, each (complex64 samples, sent)."""
    sims = piconet_sims()
    return {
        "max_rate": testing.make_multi_piconet_capture(sims, n_slots, fs,
                                                       center, seed=seed),
        "mixed": testing.make_hostile_capture(sims, n_slots, fs, center,
                                              seed=seed),
        "e2e": testing.make_piconet_capture(
            sims[0], n_slots, fs, center, seed=seed, noise_std=0.02,
            tx_slots=range(0, n_slots - 8, 2))}


def _planes(samples) -> np.ndarray:
    return np.stack([samples.real, samples.imag]).astype(np.float32)


def hostile_load(name: str, samples, sent, fs=FS,
                 n_slots: int = MODE_SLOTS, block_slots=BLOCK_SLOTS,
                 reps: int = 7, n_workers=None, device=None):
    """One capture of bench_sniffer_hostile: (its section, {mode: the
    packets that mode decoded}), modes scalar and batched (after the
    discovery warm-up), and for max_rate batched_run2 (its first run)
    and the pool."""
    air_s = n_slots * 625e-6

    def fmt(sec, tag, med, lo, hi, n_hits):
        sec[f"host_us_per_pkt_{tag}"] = med / max(n_hits, 1) * 1e6
        sec[f"host_us_per_pkt_{tag}_spread"] = [
            lo / max(n_hits, 1) * 1e6, hi / max(n_hits, 1) * 1e6]
        sec[f"host_x_realtime_{tag}"] = air_s / med

    x = _planes(samples)
    kw = dict(block_slots=block_slots, device=device)
    sn = Sniffer(fs, CENTER, **kw)
    blocks = list(sn.fe.stream(x))
    n_hits = sum(len(r.hits) for r in blocks)
    sec = {"planted_pkts": len(sent), "hits": n_hits,
           "air_pkt_per_s": len(sent) / air_s}
    decoded = {}
    for mode, batch in (("scalar", False), ("batched", True)):
        s2 = Sniffer(fs, CENTER, batch_decode=batch, **kw)
        s2.run_blocks(iter(blocks))    # discovery warm-up
        sec[f"decoded_{mode}"] = len(s2.decoded)
        decoded[mode] = list(s2.decoded)
        if not (name == "max_rate" and batch):
            med, lo, hi = _timed_reps(
                lambda: s2.run_blocks(iter(blocks)), reps)
            fmt(sec, mode, med, lo, hi, n_hits)
    if name == "max_rate":
        # two independent batched runs (fresh Sniffer, fresh discovery
        # each) with their reps interleaved, so that both medians sample
        # the same minutes of the host's load
        s2b = Sniffer(fs, CENTER, **kw)
        s2b.run_blocks(iter(blocks))
        decoded["batched_run2"] = list(s2b.decoded)
        t1s, t2s = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            s2.run_blocks(iter(blocks))
            t1s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            s2b.run_blocks(iter(blocks))
            t2s.append(time.perf_counter() - t0)
        t1s.sort()
        t2s.sort()
        fmt(sec, "batched", t1s[len(t1s) // 2], t1s[0], t1s[-1], n_hits)
        fmt(sec, "batched_run2", t2s[len(t2s) // 2], t2s[0], t2s[-1],
            n_hits)
        sec["decoded_batched_run2"] = len(s2b.decoded) // (reps + 1)

        n = n_workers or max(2, os.cpu_count() or 2)
        with ParallelHostDecoder(n_workers=n) as pool:
            got = pool.drive(sn.fe, iter(blocks))
            med, lo, hi = _timed_reps(
                lambda: pool.drive(sn.fe, iter(blocks)), reps)
        sec[f"decoded_parallel{n}"] = len(got)
        decoded["pool"] = got
        fmt(sec, f"parallel{n}", med, lo, hi, n_hits)
        # discovery mode: fresh piconet state every pass
        s3 = Sniffer(fs, CENTER, **kw)
        s3.run_blocks(iter(blocks))    # warm caches only

        def disc():
            s3.basic_rate_piconets.clear()
            s3.low_energy_piconets.clear()
            s3.run_blocks(iter(blocks))
        med, lo, hi = _timed_reps(disc, reps)
        fmt(sec, "discovery", med, lo, hi, n_hits)
    return sec, decoded


def bench_sniffer_hostile(fs=FS, n_slots: int = MODE_SLOTS,
                          block_slots=BLOCK_SLOTS, reps: int = 7,
                          n_workers=None, device=None):
    """Worst-case host-decode loads (bench.py:317), three piconets, LE
    on: `mixed` (every slot busy with 1/3/5-slot DM/DH types) and
    `max_rate` (every slot a 1-slot packet, the fully-busy 1600 pkt/s
    load).  For each: scalar and batched us/packet and the real-time
    factor against the capture's own air time; max_rate adds a second
    batched run (reps interleaved), the per-LAP multiprocess pool
    (n_workers, by default max(2, host CPUs)) and discovery mode.  All
    timings median of reps with (min, max) spread."""
    sims = piconet_sims()
    logging.disable(logging.INFO)
    try:
        out = {"host_cpus": os.cpu_count(), "reps": reps}
        for name, maker in (
                ("mixed", lambda: testing.make_hostile_capture(
                    sims, n_slots, fs, CENTER, seed=MODE_SEED)),
                ("max_rate", lambda: testing.make_multi_piconet_capture(
                    sims, n_slots, fs, CENTER, seed=MODE_SEED))):
            samples, sent = maker()
            out[name], _ = hostile_load(name, samples, sent, fs, n_slots,
                                        block_slots, reps, n_workers, device)
        out["note"] = ("3 piconets, LE on; x_realtime compares host time "
                       "to the capture's own air; max_rate IS the "
                       "fully-busy 1600 pkt/s load; parallelN = per-LAP "
                       "multiprocess decode pool; all timings "
                       "median-of-reps with [min,max] us/pkt spread")
        return out
    finally:
        logging.disable(logging.NOTSET)


def sniffer_e2e(fs=FS, n_slots: int = MODE_SLOTS,
                block_slots=BLOCK_SLOTS, reps: int = 5, device=None):
    """bench_sniffer_e2e's section and the warm Sniffer's decoded
    packets."""
    sim = testing.PiconetSim(lap=LAP, uap=UAP, clk0=0x12780)
    samples, sent = testing.make_piconet_capture(
        sim, n_slots=n_slots, fs=fs, center_freq=CENTER, seed=MODE_SEED,
        tx_slots=range(0, n_slots - 8, 2), noise_std=0.02)
    x = _planes(samples)
    kw = dict(block_slots=block_slots, device=device)
    logging.disable(logging.INFO)
    try:
        sn = Sniffer(fs, CENTER, **kw)
        # warm: graph capture + piconet discovery state
        blocks = list(sn.fe.stream(x))
        sn.run_blocks(iter(blocks))
        n_pkts = len(sn.decoded)

        # e2e: stream + decode on the int16 wire, fresh sniffer
        sn2 = Sniffer(fs, CENTER, **kw)
        list(sn2.fe.stream(x[:, :sn2.fe.step_samples +
                             sn2.fe.overlap_samples], wire="i16"))
        _sync(sn2.fe.device)
        t0 = time.perf_counter()
        sn2.run_blocks(sn2.fe.stream(x, wire="i16"))
        t_e2e = time.perf_counter() - t0

        # host half alone over the fetched blocks, steady state
        sn3 = Sniffer(fs, CENTER, **kw)
        sn3.run_blocks(iter(blocks))       # discovery warm-up
        t_host, lo, hi = _timed_reps(lambda: sn3.run_blocks(iter(blocks)),
                                     reps)
        n_host = sum(len(r.hits) for r in blocks)
    finally:
        logging.disable(logging.NOTSET)

    air_s = n_slots * 625e-6
    us_per_pkt = t_host / max(n_host, 1) * 1e6
    return {
        "planted_pkts": len(sent),
        "decoded_pkts": n_pkts,
        "e2e_samples_per_s": x.shape[1] / t_e2e,
        "e2e_x_realtime": air_s / t_e2e,
        "host_decode_us_per_pkt": us_per_pkt,
        "host_decode_us_per_pkt_spread": [lo / max(n_host, 1) * 1e6,
                                          hi / max(n_host, 1) * 1e6],
        "host_decode_x_realtime_at_1600pps": 1.0 / (1600 * us_per_pkt *
                                                    1e-6),
        "note": "e2e is the int16 wire through stream(), host decode "
                "included; host half is the decode alone over fetched "
                "blocks",
    }, list(sn.decoded)


def bench_sniffer_e2e(**sizes) -> dict:
    """A busy capture (a DM1 in every other slot) through the full
    Sniffer: device front end + host decode (bench.py:430); the host
    decode alone over the fetched blocks, median of reps."""
    return sniffer_e2e(**sizes)[0]


def e2e_point(fs: float, wire: str, squelch: float, n_slots: int,
              block_slots: int, reps: int = 5, device=None):
    """One operating point of bench_e2e_operating_points: (its entry,
    the packets its warm run decoded)."""
    sim = testing.PiconetSim(lap=LAP, uap=UAP, clk0=0x12780)
    air_s = n_slots * 625e-6
    samples, sent = testing.make_piconet_capture(
        sim, n_slots=n_slots, fs=fs, center_freq=CENTER, seed=MODE_SEED,
        tx_slots=range(0, n_slots - 8, 2), noise_std=0.02)
    x = _planes(samples)
    sn = Sniffer(fs, CENTER, block_slots=block_slots,
                 squelch_threshold=squelch, device=device)
    bank = set(sn.fe.bank.channels)
    planted = sum(1 for s, c, _ in sent if c in bank and s >= 1)
    ingest = PipelinedIngest(sn.fe, wire)
    carry, chunks = wire_chunks(x, sn.fe, wire, pad_tail=True)
    chunk_list = [np.ascontiguousarray(c) for c in chunks]
    # warm: graph capture + discovery
    sn.run_blocks(ingest.run(iter(chunk_list), 0, initial_carry=carry))
    decoded = list(sn.decoded)

    med, lo, hi = _timed_reps(
        lambda: sn.run_blocks(ingest.run(iter(chunk_list), 0,
                                         initial_carry=carry)), reps)
    wire_bytes = sum(c.nbytes for c in chunk_list)
    return {
        "fs_msps": fs / 1e6,
        "wire": wire,
        "squelch_db": squelch,
        "n_slots": n_slots,
        "wire_gbps_needed_realtime": wire_bytes / air_s / 1e9,
        "planted_in_band": planted,
        "decoded": len(decoded),
        "e2e_x_realtime": air_s / med,
        "e2e_x_realtime_spread": [air_s / hi, air_s / lo],
    }, decoded


def bench_e2e_operating_points(points=OPERATING_POINTS, reps: int = 5,
                               device=None):
    """The whole loop (pre-packed wire bytes -> H2D -> device step ->
    hit tables -> host decode, bench.py:498) at each point of `points`
    ((name, rate, wire, squelch, slots, block slots)), with its decode
    counts (planted in-band packets, decoded with a CRC-checked UAP);
    median of reps with spread."""
    out = {}
    logging.disable(logging.INFO)
    try:
        for name, fs, wire, squelch, n_slots, bs in points:
            out[name], _ = e2e_point(fs, wire, squelch, n_slots, bs, reps,
                                     device)
    finally:
        logging.disable(logging.NOTSET)
    out["note"] = ("whole loop timed: pre-packed wire bytes -> H2D -> "
                   "device step -> hit tables -> host decode")
    return out


# ------------------------------------------------------------------ main

def _note(msg: str):
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


def parity_check(fe, tabs, sent, n_distinct: int):
    """bench.py:660-677: every planted (slot, channel) of slots 1 to
    span - 2 on the bank's channels (all of them at full band) is in the
    hit tables (rows past a block's count are -1), and the LAP set is
    {LAP}.  Returns (parity, missing, LAPs)."""
    got, laps = set(), set()
    B = fe.block_slots
    for b in range(n_distinct):
        for c, t, lap, _ in tabs[b]:
            if c < 0 or t >= B * 625:
                continue
            slot = (int(t) + fe.delay_sym) // 625
            got.add((b * B + slot, fe.bank.channels[int(c)]))
            laps.add(int(lap))
    span = n_distinct * B
    bank = set(fe.bank.channels)
    want = {(s, c) for s, c, _ in sent if 1 <= s < span - 1 and c in bank}
    missing = want - got
    return (not missing) and laps == {LAP}, missing, laps


def run(device=None, fs=FS, n_slots: int = MODE_SLOTS,
        block_slots: int = BLOCK_SLOTS, n_distinct: int = N_DISTINCT,
        n1: int = N1, n_ingest: int = N_INGEST, reps=None,
        points=OPERATING_POINTS, n_workers=None) -> dict:
    """Every section on `device` (the CUDA device by default; with none
    and no card it raises), at bench.py's sizes unless given: the device
    loop and the ingest at fs in blocks of block_slots over n_distinct
    blocks (n1 and n_ingest timed), the sniffer sections over n_slots,
    the operating points `points`; `reps` replaces every section's own
    count of repetitions.  Returns the JSON line's dict."""
    device = resolve_device(device)
    fe = FrontEnd(fs, CENTER, block_slots=block_slots, max_ac_errors=1,
                  device=device)
    kind, power = card_info(device)

    # golden capture: hop-consistent packets across the band
    sim = testing.PiconetSim(lap=LAP, uap=UAP, clk0=0x12780)
    n_cap = block_slots * n_distinct + 8
    samples, sent = testing.make_piconet_capture(
        sim, n_slots=n_cap, fs=fs, center_freq=CENTER, seed=11,
        tx_slots=range(0, n_cap - 8, 2), noise_std=0.02)
    x = _planes(samples)
    need = n_distinct * fe.step_samples + fe.overlap_samples
    if x.shape[1] < need:
        x = np.pad(x, ((0, 0), (0, need - x.shape[1])))
    xd = stage_blocks(fe, x[:, :need], n_distinct)

    _note("device stream runner (graph capture)")
    stream = make_stream_runner(fe, n_distinct)
    stream(xd, 2)                     # capture + settle
    _sync(device)
    t0 = time.perf_counter()
    stream(xd, n1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream(xd, 2 * n1)
    t2 = time.perf_counter() - t0
    dt_block = (t2 - t1) / n1
    samples_per_s = fe.step_samples / dt_block

    _note(f"device loop {samples_per_s / 1e6:.0f} Msps; raw link")
    raw_gbps, link_rtt_ms = measure_raw_link(device=device)

    _note(f"raw link {raw_gbps:.3f} GB/s; ingest runs")
    ingest = {}
    ov, st = fe.overlap_samples, fe.step_samples
    for name, wire, np_dtype, scale, full in INGEST_WIRES:
        if wire == "i4":
            xi = wire_encode(x, wire)
            blocks = [np.ascontiguousarray(xi[ov + i * st: ov + (i + 1) * st])
                      for i in range(n_distinct - 1)]
        else:
            xc = np.clip(x * scale, -full, full - 1).astype(np_dtype)
            blocks = [np.ascontiguousarray(
                xc[:, ov + i * st: ov + (i + 1) * st])
                for i in range(n_distinct - 1)]
        step = make_ingest_runner(fe, np_dtype, 1.0 / full, wire=wire)
        carry0 = torch.from_numpy(np.ascontiguousarray(x[:, :ov])).to(device)
        run_ingest(step, carry0, blocks, 2)           # capture + settle
        ti1 = run_ingest(step, carry0, blocks, n_ingest)[0]
        ti2 = run_ingest(step, carry0, blocks, 2 * n_ingest)[0]
        ingest[name] = fe.step_samples / ((ti2 - ti1) / n_ingest)

    # parity (untimed): every planted packet detected; slot 0 excluded
    # (the bit stream leads the input by the filter group delay)
    _note("parity run")
    _, tabs = make_parity_runner(fe, n_distinct)(xd)
    parity, missing, laps = parity_check(fe, tabs.cpu().numpy(), sent,
                                         n_distinct)
    if not parity:
        print(f"# parity FAIL: missing={sorted(missing)[:5]} "
              f"laps={[hex(v) for v in laps]}", file=sys.stderr)

    device_kind = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else None)
    roof = roofline(fe, dt_block, device_kind, power)
    _note("profiling top ops")
    roof["top_ops"] = top_ops(fe, xd, stream)
    _note("sniffer e2e")
    e2e = bench_sniffer_e2e(fs=fs, n_slots=n_slots, block_slots=block_slots,
                            reps=reps or 5, device=device)
    _note("e2e operating points")
    ops = bench_e2e_operating_points(points, reps=reps or 5, device=device)
    _note("hostile sniffer load")
    hostile = bench_sniffer_hostile(fs=fs, n_slots=n_slots,
                                    block_slots=block_slots, reps=reps or 7,
                                    n_workers=n_workers, device=device)

    value = samples_per_s if parity else 0.0
    return {
        "metric": "wideband IQ samples/s on one card (79-ch channelize + "
                  "demod + AC detect, the fused chain's replayed step); "
                  "LAP detection parity",
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / 80e6,
        "raw_link_gbps": raw_gbps,
        "link_rtt_ms": link_rtt_ms,
        "ingest_samples_per_s_int16": ingest["int16"],
        "ingest_samples_per_s_int8": ingest["int8"],
        "ingest_samples_per_s_int4": ingest["int4"],
        "ingest_vs_baseline_int16": ingest["int16"] / 80e6,
        "ingest_vs_baseline_int8": ingest["int8"] / 80e6,
        "ingest_vs_baseline_int4": ingest["int4"] / 80e6,
        "ingest_note": "wire blocks (pageable) copied on a copy stream "
                       "while the previous block's flat-chain step runs; "
                       "real time needs 0.32 GB/s (int16) / 0.16 GB/s "
                       "(int8) / 0.08 GB/s (int4) at full band",
        "roofline": roof,
        "sniffer": e2e,
        "e2e_operating_points": ops,
        "sniffer_hostile": hostile,
        "device_kind": kind,
        "power_limit_w": power,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gr_bluetooth_tpu_torch.bench",
        description="the port's benchmark; prints one JSON line")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; cpu runs "
                         "the plain versions at full size, for debugging)")
    opts = ap.parse_args(argv)
    print(json.dumps(run(opts.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
