#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gr_bluetooth_tpu_torch) on one
NVIDIA card, at the full-band configuration: 80 Msps centred on
2441 MHz, 79 BR channels + the probe row, 64-slot blocks.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit, from nvidia-smi;
2. build the seven CUDA libraries from csrc/ (nvcc, one process each,
   all started together);
3. on one full-band block, run each kernel and its plain PyTorch version
   on the same device tensors and hold them together:
       pfb_snr         y within 2e-5, slot SNR within 1e-3 dB
       demod_pack      at most 1 mismatched symbol per 10^5
       detect_words    exact
       deinterleave    exact
       pfb_channelize  y within 2e-5
       le_detect       exact, both forms (the step's, hits only, and the
                       one with the dense distances; on the block's LE
                       rows and on phase 5's first block, which has LE
                       packets)
       hit_table       exact (count, table, windows): the classic form
                       over detect_words' planes of the block and of
                       phase 5's first block, the LE form over
                       le_detect's plane of phase 5's first block, both
                       in one launch (hit_tables, the step's form); on
                       planes of the full band at 64- and 128-slot
                       blocks (the latter over one pass of a block) and
                       of 8 Msps with 8-slot blocks, with no hit, one,
                       exactly max_hits, more, and all in one block's
                       range: each form, both in one launch, and the
                       two forms at once on two streams
   and time each (device time per launch from a CUDA graph of 20
   launches, replayed; and per back-to-back wrapper call, host time
   included) beside the plain version and, where one PyTorch call
   computes the same function, beside that call (a
   cuDNN conv1d for the two channelizers, one reshape-transpose copy for
   deinterleave); then time the block's whole device step on each of the
   two chains and profile a few steps of each: the fused chain
   (FrontEnd.fused_step, which stream() runs) and the flat chain
   (FrontEnd.device_step, which stream_sync() runs);
   3d. the compiled steps (FrontEnd.compiled_step: a CUDA graph captured
   once, one replay per block) of the fused chain with LE off and on,
   the flat chain with LE on and the 81 Msps conv bank, each on its
   block against its eager step, bit for bit (SNR, counts, tables and
   windows); event ms per block and device-busy share of both forms,
   and each fused replay's device ops: their number per replay and
   every op (ms and calls); it fails if a fused replay holds a memset
   besides pfb_snr's one or an int64 fill (hit_table keeps no state)
   or launches hit_table other than once (both tails in one launch
   with LE on);
   then stream() over phase 4's capture with the eager ingest and the
   compiled one, in turns: the same hits, samples/s and the stage split
   (wire_encode, h2d, device_step, assemble).  From here on every path
   (phases 4 to 9) runs its step as graph replays, and the launch counts
   it checks count each replay's launches (utils/graph.py);
4. the main path: LapSurvey(80e6, 2441e6, block_slots=64).run over a
   synthesized capture of a few blocks with ID packets of 7 LAPs planted
   on 24 channels (0 and 78 among them), several per slot, through the
   pipelined stream (the fused chain).  Every planted (LAP, channel) must
   be reported at its slot (+-1), no other LAP may be, and the launch
   count of each fused-chain kernel and of hit_table must equal the
   number of blocks.
   The same capture runs once more, warm, for the steady-state rate and
   its stage breakdown;
5. the flat path: FrontEnd(80e6, 2441e6, block_slots=64,
   max_ac_errors=1, enable_le=True).stream_sync over a capture of 3
   blocks with the ID packets of phase 4 and LE advertising packets on
   LE channels 37, 38 and 39 (BR channels 0, 24 and 78).  Every planted
   (LAP, channel) and every planted LE packet must be reported at its
   slot (+-1), no other LAP and no other advertising-channel packet may
   be, and deinterleave, pfb_channelize, detect_words, le_detect (its
   step form) and hit_table in both forms must each launch once per
   block (pfb_snr and demod_pack not at all).  The same capture through stream() (the fused chain, LE on)
   must give the same classic and LE hit keys, slot SNR within 1e-3
   dB, and hit windows within 1 mismatched symbol per 10^5 inside the
   capture (the discriminators differ: torch.atan2 on the flat chain,
   atan2_poly in demod_pack; past the capture's end, in the zero
   padding of the last block, they differ on signed zeros, and those
   symbols are counted and printed apart);
6. a small reference: an 8 Msps survey on the card against the plain
   versions on the CPU — same observations, SNR within 1e-3 dB;
7. the modes, at full band over bench.py's sniffer captures (three
   piconets, 256 slots, seed 13; counters zeroed before each run and read
   after it: the fused chain's three kernels and hit_table once per
   block, le_detect and hit_table's LE form once per block where LE is
   on, no other):
   a. Sniffer (LE on).run over `max_rate` (a DM1 in every slot, 250
      planted) and `mixed` (every slot busy with 1/3/5-slot DM/DH, 101
      planted): every decoded packet is a planted one (slot, channel,
      LAP, UAP, type), none twice, at least 249 and 101 decoded, one
      uap_found per piconet with its UAP; then the host decode alone over
      the fetched blocks, which must decode the same packets;
   b. UapDiscovery and Hopper (int16 wire) over `e2e`: UAP 0x47 with a
      consistent CLK1-6, CLK1-27 offset 0x12780 from a candidate scan on
      the card, every followed packet at the master's clock; the
      Hopper's pattern replayed through DeviceWinnower on the card and
      on the CPU, which must agree;
   c. Sniffer over an LE connection capture: the CONNECT_REQ's access
      address, CRCInit and hop increment, every data packet followed with
      a good CRC on the channel the follower predicts.
   Each prints host seconds, samples/s to the last result, host decode
   microseconds per hit and peak device memory;
8. the slice of the CLI, the other rates and the host decode pool:
   a. `python -m gr_bluetooth_tpu_torch.apps.btrx -r 80e6 -f 2441e6 -S
      -i - -s --stats -W <tmp>.pcap` as a subprocess fed `max_rate` as
      int16 wire bytes on stdin, after the native runtime (the port's
      btio.cc, g++) is built and loaded: at least 249 decoded frames,
      each a planted (LAP, UAP, type, channel), each logged packet at
      its air slot (clkn - LOOKAHEAD_SLOTS: the stdin path starts from
      a zero carry), and the frames, timestamps aside, equal in order
      to an in-process Sniffer's over the same wire chunks through
      PipelinedIngest.run; then the same bytes with --live: its
      overruns and dropped bytes, and with none the same frames, with
      some every logged packet planted at its air slot or one slot
      later (a slip rounds dropped air to whole slots);
   b. LapSurvey(81e6, 2441e6, block_slots=64) over 3 planted blocks:
      the strided conv bank (cuDNN conv1d, FP32 whatever the TF32
      flags: checked within 2e-5 of the CPU with cuDNN TF32 on), every
      planted pair found, detect_words and hit_table once per block and
      no other kernel; its step profiled and the conv bank timed against its
      FP32 operation bound; then 5 Msps on the card against the CPU;
   c. Sniffer(7.68e6, 2441e6) over a capture resampled to 7.68 Msps
      (the polyphase bank at 8 Msps on the true band's channels): UAP
      0x47 decoded, hits equal to the same run on the CPU;
   d. ParallelHostDecoder(n_workers=4) over phase 7a's fetched blocks
      against the single-process decode of the same blocks: equal
      packets per LAP and in order, microseconds per hit of both.
   Each phase prints its wall time;
9. the Kismet survey and the sharded front ends (LE on, the survey's
   max_ac_errors=1 where planted LAPs are checked):
   a. KismetSource(80e6, 2441e6, block_slots=64) over phase 4's planted
      capture: its frames equal, in order, the one-per-(channel, clkn)
      reduction of the front end's hits, its tracked networks are the
      planted LAPs framed twice or more, the fused kernels launch once
      per block; a BtbbDevServer client receives the snapshot and then
      one tick's updates, none lost; then `python -m
      gr_bluetooth_tpu_torch.kismet -r 80e6 -f 2441e6 --synthetic 256
      --table` (no --device) exits 0 with the row 00:00:00:24:d9:52;
   b. ShardedFrontEnd over [cuda:0] * 4, two superblocks (8 blocks,
      25.6 M samples) with ID and LE advertising packets, some starting
      560 symbols into the last slot of a shard's chunk and of the first
      superblock: classic and LE hit keys equal to FrontEnd.stream's,
      slot SNR within 1e-3 dB, each fused-chain kernel launched 4 x 2
      times; then measure_scaling_efficiency (efficiency, halo cost,
      speedup against a one-device loop, peak device memory);
   c. Sharded2DFrontEnd on a 2 x 2 grid of cuda:0 over 4 blocks: hits
      equal to FrontEnd.stream's; pfb_snr, demod_pack and detect_words
      at each group's width (41 DFT columns) against their plain
      versions with phase 3's bounds;
   d. two processes under a gloo process group (2 shards each on
      cuda:0, device_put_local, the halo through host memory), each
      with a time limit: process 0's hits equal 9b's.  NCCL refuses two
      ranks on one card, so its path is not run here.
   Each prints its wall time;
10. the bench: `python -m gr_bluetooth_tpu_torch.bench` (no --device) as
   a subprocess, its whole output read in this process and its last
   line parsed (check_bench): LAP parity held with value > 0, the 16
   and 8 MHz int8 operating points decode 94 of 94 and 44 of 44 planted
   in-band packets, the hostile max_rate and mixed loads at least 249
   and 101 in every decode mode they run (scalar, batched, the second
   batched run and the pool), and roofline.modeled_ms equals the sum of
   phase 3's bounds of pfb_snr, demod_pack and detect_words (the same
   byte and operation counts, gr_bluetooth_tpu_torch/bench.py); prints
   the other points' counts, the top ops and the bench's line, and its
   wall time.

Phase 3 also checks detect_words with emit_err (its 7 error-count planes
exact against the plain version) and times it, and phase 3c runs the
dense detector entry points (gated_error, classic_detect_words) on the
block's unpacked words against the plain versions on the CPU, every
offset equal, and classic_detect_words' hits against detect_words'.

After the build it prints each kernel's registers, shared memory and
spills (nvcc -Xptxas -v).

The next-to-last line is {"kernels": [...]}, one row per kernel, one
for detect_words with emit_err and one for hit_table's LE form;
le_detect's row is its step form, with the form with the distances
under "dist_form"; le_detect and hit_table have no TPU counterpart,
their "replaces" names the JAX code they compute (times in ms on this
card: ms from graph replay, call_ms per wrapper call; bound_ms is the
larger of bytes / 3.35 TB/s and operations over the peak rate of their
type: 67 T/s for float32, 16.75 T/s for int32 and logical instructions;
the channelizers' DFT counts as an M-point FFT at 5 M log2 M, the
detector as this card's LOP3 and SHF instructions
(detect_instr_per_word), le_detect as its integer operations per offset
(bench.le_detect_cost), hit_table as the bytes of its plane, constants
and windows (bench.hit_table_cost); bound_frac = bound_ms / ms;
hit_table's row also holds the joint launch's row ("joint", its bound
the two tails' sum) and the launch floor, an empty kernel replayed the
same way ("launch_floor_ms")); the last line is
{"ok": true, "device": {...}}.
With no CUDA device the script exits non-zero before printing any
result.

    python3 chip_smoke.py --cards 4      # on a machine with four cards

builds the kernels and runs only phase 9 across the cards
(multicard_phase): the three fused kernels and a compiled fused step
(a graph of that card's own) on every card with card 0 current, 9b
with one shard (one graph) per card, 9c on the grid [[0, 1], [2, 3]],
9d under NCCL with a process per card, then dryrun_multichip(N); its
last line is the same {"ok": true, ...} with the cards' count.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.bench import (INT32_OPS, bound, channelize_ops,
                                          deinterleave_cost, demod_pack_cost,
                                          detect_instr_per_word,
                                          detect_words_cost, hit_table_cost,
                                          le_detect_cost, mode_captures,
                                          pfb_channelize_cost, pfb_snr_cost,
                                          piconet_sims)
from gr_bluetooth_tpu_torch.constants import (LE_ADV_AA, SYMBOLS_PER_SLOT,
                                              TYPE_NAMES)
from gr_bluetooth_tpu_torch.core import whitening
from gr_bluetooth_tpu_torch.core.access_code import ac_bits
from gr_bluetooth_tpu_torch.io import ingest
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.models.hopper import Hopper
from gr_bluetooth_tpu_torch.models.lap_survey import LapSurvey
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.models.uap_discovery import UapDiscovery
from gr_bluetooth_tpu_torch.ops import (demod_kernel, detect, detect_kernel,
                                        hit_table, hop_ops, pfb, pfb_kernel,
                                        snr, synth)
from gr_bluetooth_tpu_torch.utils import cuda_build
from gr_bluetooth_tpu_torch.utils.bits import host_to_air
from gr_bluetooth_tpu_torch.utils.log import EventBus

FS, CENTER, BLOCK_SLOTS, N_BLOCKS = 80e6, 2441e6, 64, 3
LAPS = (0x24D952, 0x9E8B33, 0x123456, 0xABCDEF, 0x5A17EC, 0x000F0F,
        0xC0FFEE)
# LE advertising channels 37, 38, 39 on the BR channel grid
LE_ADV_CHANNELS = {0: 37, 24: 38, 78: 39}
# the fused chain's kernels (stream()) and the flat chain's (stream_sync())
FUSED = (pfb_kernel.pfb_snr, demod_kernel.demod_pack,
         detect_kernel.detect_words)
FLAT = (pfb.deinterleave, pfb_kernel.pfb_channelize,
        detect_kernel.detect_words)
# the LE detector on the words, on either chain's tail with LE on (its
# step form, hits only; with the dense distances, for the checks, it is
# counted apart in le_detect.dist_launches)
LE = detect.le_detect
LE_DIST = "le_detect_dist"
# the hit table after detect_words on every chain (hit_table.launches),
# and its LE form after le_detect (hit_table.le_launches)
HT = hit_table.hit_table
HT_LE = "hit_table_le"
KERNELS = FUSED + FLAT[:2] + (LE, HT)
# detect_words with emit_err (its error-count planes) is a kernel of its
# own, counted apart in detect_words.err_launches
DETECT_ERR = "detect_words_err"
# each kernel's symbol in a profile, where it is not "<name>_kernel"
# (both hit-table forms, alone or together, are one kernel)
SYMBOL = {HT_LE: "hit_table_kernel"}
# hit_table's density cases: hits that all pass the squelch, none, one,
# exactly max_hits, 57 more, or 150 inside one block's range
HT_DENSITIES = ("zero", "one", "exactly max_hits", "above max_hits",
                "one block")
REPLACES = {
    "pfb_snr": "gr_bluetooth_tpu/ops/pfb_kernel.py:559",
    "demod_pack": "gr_bluetooth_tpu/ops/pfb_kernel.py:559",
    "detect_words": "gr_bluetooth_tpu/ops/detect_pallas.py:200",
    DETECT_ERR: "gr_bluetooth_tpu/ops/detect_pallas.py:200",
    "pfb_channelize": "gr_bluetooth_tpu/ops/pfb_kernel.py:193",
    "deinterleave": "gr_bluetooth_tpu/ops/pfb.py:126",
    # no Pallas kernel: the JAX function it computes, as plain jnp
    "le_detect": "gr_bluetooth_tpu/ops/detect.py:205",
    # no Pallas kernel: the JAX step's tail after detection, plain jnp
    "hit_table": "gr_bluetooth_tpu/models/frontend.py:753",
    HT_LE: "gr_bluetooth_tpu/models/frontend.py:800",
}
# decoded packets each capture must give at 80 Msps, of 250 and 101
# planted (the JAX package's counts on the same captures, BENCH_r05.json)
MIN_DECODED = {"max_rate": 249, "mixed": 101}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _classic_plan(fe, n_slots: int, r, busy: set):
    """ID packets (72-symbol access code + 60 random symbols) of LAPS on
    up to 24 of the bank's channels, the first and last among them, four
    packets per slot on different channels."""
    ch_all = fe.bank.channels
    pick = np.unique(np.linspace(0, len(ch_all) - 1,
                                 min(24, len(ch_all))).round().astype(int))
    chans = [ch_all[i] for i in pick]
    sps = fe.bank.sps
    plan, planted = [], []
    for i in range(5 * len(chans)):
        ch = chans[i % len(chans)]
        slot = 1 + ((i // 4) * 11) % (n_slots - 3)
        if {(ch, slot - 1), (ch, slot), (ch, slot + 1)} & busy:
            continue
        busy.add((ch, slot))
        lap = LAPS[i % len(LAPS)]
        bits = np.concatenate([ac_bits(lap)[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        start = (slot * SYMBOLS_PER_SLOT + int(r.integers(0, 400))) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        planted.append((lap, ch, slot))
    return plan, planted


def _synth(fe, plan, n_samples: int, seed: int):
    return synth.synthesize_capture(plan, n_samples=n_samples,
                                    fs=fe.input_rate,
                                    center_freq=fe.bank.center_freq,
                                    noise_std=0.02, seed=seed)


def plant_capture(fe, n_blocks: int, seed: int = 1):
    """Wideband capture of exactly n_blocks steps (plus the overlap) with
    the ID packets of _classic_plan.  Returns (complex64 samples,
    [(lap, channel, slot)])."""
    r = np.random.default_rng(seed)
    plan, planted = _classic_plan(fe, n_blocks * fe.block_slots, r, set())
    n = fe.overlap_samples + n_blocks * fe.step_samples
    return _synth(fe, plan, n, seed), planted


def le_adv_frame(index: int, pdu_type: int, payload: bytes) -> np.ndarray:
    """LE advertising packet symbols without CRC: preamble, access
    address 0x8E89BED6, then the header and payload whitened for LE
    channel `index` (the JAX package's packets.encode_le_adv with
    crc=False)."""
    aa_bits = host_to_air(LE_ADV_AA, 32)
    preamble = host_to_air(0x155 if aa_bits[0] else 0x0AA, 9)[:8]
    header = np.zeros(16, np.uint8)
    header[0:4] = host_to_air(pdu_type, 4)
    header[8:14] = host_to_air(len(payload), 6)
    body = host_to_air(np.frombuffer(payload, np.uint8), 8).reshape(-1)
    pdu = np.concatenate([header, body])
    pdu = pdu ^ whitening.le_whitening_word(index, len(pdu))
    return np.concatenate([preamble, aa_bits, pdu]).astype(np.uint8)


def plant_le_capture(fe, n_blocks: int, seed: int = 2, le_per_block=3,
                     boundary_slots=()):
    """Capture of exactly n_blocks * block_slots slots (stream_sync and
    stream both cut it into n_blocks blocks, the last zero-padded past
    the capture) with the ID packets of _classic_plan and, on each LE
    advertising channel the bank covers, le_per_block advertising
    packets per block (9-byte payloads, in slots free on that channel).
    In each of `boundary_slots` (the last slot of a block, a shard's
    chunk or a superblock) an ID packet and, where the bank has an
    advertising channel, an LE advertising packet start 560 symbols in,
    so that they end in the next chunk.
    Returns (complex64 samples, [(lap, channel, slot)],
    [(LE index, BR channel, slot)])."""
    r = np.random.default_rng(seed)
    n_slots = n_blocks * fe.block_slots
    busy: set = set()
    sps = fe.bank.sps
    plan, planted, le_planted = [], [], []
    adv = [(ch, i) for ch, i in LE_ADV_CHANNELS.items()
           if ch in fe.bank.channels]
    plain = [ch for ch in fe.bank.channels if ch not in LE_ADV_CHANNELS]
    for k, slot in enumerate(boundary_slots):
        start = (slot * SYMBOLS_PER_SLOT + 560) * sps
        ch, lap = plain[(11 * k + 5) % len(plain)], LAPS[k % len(LAPS)]
        bits = np.concatenate([ac_bits(lap)[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        planted.append((lap, ch, slot))
        busy.add((ch, slot))
        if adv:
            ch, index = adv[k % len(adv)]
            bits = le_adv_frame(index, k % 7,
                                bytes(r.integers(0, 256, 9).tolist()))
            plan.append(synth.PlannedPacket(
                channel=ch, start_sample=start,
                bits=np.concatenate([bits, np.zeros(8, np.uint8)])))
            le_planted.append((index, ch, slot))
            busy.add((ch, slot))
    cplan, cplanted = _classic_plan(fe, n_slots, r, busy)
    plan += cplan
    planted += cplanted
    B = fe.block_slots
    stride = max(2, (B - 6) // le_per_block)
    for k, (ch, index) in enumerate(LE_ADV_CHANNELS.items()):
        if ch not in fe.bank.channels:
            continue
        for i in range(n_blocks * le_per_block):
            want = min((i // le_per_block) * B + 2 + k +
                       (i % le_per_block) * stride, n_slots - 3)
            # the wanted slot, else the first free one
            for slot in [want, *range(2, n_slots - 2)]:
                if not {(ch, slot - 1), (ch, slot), (ch, slot + 1)} & busy:
                    break
            else:
                continue
            busy.add((ch, slot))
            bits = le_adv_frame(index, i % 7,
                                bytes(r.integers(0, 256, 9).tolist()))
            start = (slot * SYMBOLS_PER_SLOT + int(r.integers(0, 400))) * sps
            plan.append(synth.PlannedPacket(
                channel=ch, start_sample=start,
                bits=np.concatenate([bits, np.zeros(8, np.uint8)])))
            le_planted.append((index, ch, slot))
    x = _synth(fe, plan, n_blocks * fe.step_samples, seed)
    return x, planted, le_planted


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


def check_le(le_hits, le_planted, start_clkn: int = 0):
    """Every planted LE packet reported as a LeHit with its LE index and
    BR channel at its slot +-1, and every hit on an advertising channel
    (index >= 37) is a planted packet.  Returns the matched count."""
    want = {(i, ch, slot + start_clkn) for i, ch, slot in le_planted}
    found = set()
    for h in le_hits:
        near = {(h.index, h.channel, h.clkn + d) for d in (-1, 0, 1)} & want
        if h.index >= 37:
            assert near, (f"unplanted LE advertising hit: index {h.index} "
                          f"channel {h.channel} at clkn {h.clkn}")
        found |= near
    missing = want - found
    assert not missing, f"planted LE packets not reported: {sorted(missing)}"
    return len(found)


def capture_symbols(fe, n_samples, block: int) -> int:
    """Symbols of block `block` of an n_samples capture that both chains
    must agree on: those in timing groups that end before the symbols
    whose input reaches past the capture.  Past the capture's end the
    block is zero-padded and y is exactly zero, often with a sign bit
    set by the (-1)^{cn} rotator; there torch.atan2 (the flat chain, as
    jnp.arctan2 in the JAX package's) returns +-pi for the signed zeros
    and atan2_poly (demod_pack, as the TPU kernel) returns 0, which can
    move the timing phase of the whole group that reaches past the
    end."""
    if n_samples is None:
        return fe.n_sym
    end = ((n_samples - block * fe.step_samples - fe.bank.ntaps)
           // fe.bank.sps - 2)
    G = demod_kernel.GROUP
    return min(fe.n_sym, max(0, end) // G * G)


def compare_chains(fe, flat, fused, n_samples=None):
    """The same capture's BlockResults from the flat chain (stream_sync)
    and the fused chain (stream()): identical classic and LE hit keys,
    slot SNR within 1e-3 dB, and the hits' symbol windows, where they
    lie inside the capture (capture_symbols, for a capture of n_samples;
    all of them without it), within one mismatched symbol per 10^5.
    Window symbols past that are counted apart and printed.  Returns
    (max SNR difference in dB, differing window symbols, window symbols
    compared)."""
    assert len(flat) == len(fused), (len(flat), len(fused))
    d_snr, d_sym, n_sym, d_past, n_past = 0.0, 0, 0, 0, 0
    for i, (a, b) in enumerate(zip(flat, fused)):
        ka = [(h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
              for h in a.hits]
        kb = [(h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
              for h in b.hits]
        assert ka == kb, f"classic hits differ: {set(ka) ^ set(kb)}"
        la = [(h.channel, h.index, h.clkn, h.sym_offset, h.distance)
              for h in a.le_hits]
        lb = [(h.channel, h.index, h.clkn, h.sym_offset, h.distance)
              for h in b.le_hits]
        assert la == lb, f"LE hits differ: {set(la) ^ set(lb)}"
        d_snr = max(d_snr, float(np.abs(a.snr_db - b.snr_db).max()))
        limit = capture_symbols(fe, n_samples, i)
        pairs = ([(fe.packet_symbols(a, ha), fe.packet_symbols(b, hb),
                   ha.sym_offset) for ha, hb in zip(a.hits, b.hits)] +
                 [(fe.le_packet_symbols(a, ha), fe.le_packet_symbols(b, hb),
                   ha.sym_offset) for ha, hb in zip(a.le_hits, b.le_hits)])
        for wa, wb, off in pairs:
            k = max(0, min(wa.size, limit - off))
            d_sym += int((wa[:k] != wb[:k]).sum())
            n_sym += k
            d_past += int((wa[k:] != wb[k:]).sum())
            n_past += wa.size - k
    print(f"chains: {d_sym} of {n_sym} window symbols inside the capture "
          f"differ; past its end (zero padding, signed zeros: torch.atan2 "
          f"+-pi, atan2_poly 0) {d_past} of {n_past}")
    assert d_snr <= 1e-3, f"slot SNR differs by {d_snr} dB"
    assert d_sym <= n_sym * 1e-5, (d_sym, n_sym)
    return d_snr, d_sym, n_sym


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of fn: reps calls captured in one CUDA graph,
    replayed, timed with CUDA events; unlike time_ms, no host time
    between launches (a wrapper call costs the host tens of
    microseconds, more than the shortest kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / (replays * reps)
    del g
    return ms


# demod_pack's arithmetic, in instructions per lane, as
# csrc/demod_pack.cu issues it: a discriminator frame (4 shared loads, 6
# products, atan2_poly with its two IEEE divisions (fast path, range test),
# the gain and a store: 60); a symbol's 16 metric terms (21 products, 14
# adds and 16 accumulating adds) and its slice and pack (6); a probe tap
# of one grid point (2 shared loads, 4 FMAs); a warp's transposing
# butterfly of 16 sums (15 x 2 selects, a shuffle and an add)
DEMOD_FRAME, DEMOD_SYMBOL, DEMOD_TAP, DEMOD_BUTTERFLY = 60, 51 + 6, 6, 60
# one instruction per scheduler and clock, four schedulers per SM, at the
# clock the float32 peak assumes (67 TFLOP/s = 132 SMs x 128 lanes x 2 x
# 1.98 GHz)
WARP_INSTR_RATE = 132 * 4 * 1.98e9


def demod_instr(C: int, n_groups: int, n_k: int, T: int) -> float:
    """Warp instructions demod_pack issues for C rows of n_groups groups
    and n_k probe points of T taps (padded to whole lanes): the
    arithmetic alone, no copies, barriers or address arithmetic."""
    # each of the 4 warps runs one butterfly for the metrics and one for
    # its probe points
    per_group = (demod_kernel.GROUP_FRAMES * DEMOD_FRAME / 32 +
                 demod_kernel.GROUP * DEMOD_SYMBOL / 32 +
                 2 * 4 * DEMOD_BUTTERFLY)
    taps = -(-T // 32) * 32
    return C * (n_groups * per_group + n_k * taps * DEMOD_TAP / 32)


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
    """Phase 3: each kernel against its plain version on one block.
    Returns the kernels' rows, the block's (79, W) packed words and its
    (S, 79) slot SNR."""
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
    print(f"channelizers: {channelize_ops(C, M, Q):.6g} float32 operations "
          f"per frame (FIR 4MQ = {4 * M * Q}, {M}-point FFT 5 M log2 M = "
          f"{5 * M * math.log2(M):.6g}; the direct DFT's 8CM = {8 * C * M})")
    b_ms, b_by = bound(*pfb_snr_cost(xb.numel(), C, M, Q, n_frames))
    rows["pfb_snr"] = dict(
        max_abs_err=err_y,
        ms=graph_ms(lambda: pfb_kernel.pfb_snr(xb, *bank, n_frames)),
        call_ms=time_ms(lambda: pfb_kernel.pfb_snr(xb, *bank, n_frames), 50),
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
    T = c["probe_re"].shape[0]
    b_ms, b_by = bound(*demod_pack_cost(C, n_frames, n_groups, n_k, T,
                                        words.numel(), pe.numel()))
    instr = demod_instr(C, n_groups, n_k, T)
    print(f"demod_pack: instruction estimate {instr:.4g} warp instructions "
          f"= {instr / WARP_INSTR_RATE * 1e3:.4f} ms at 4 per SM and clock, "
          f"beside its byte bound {b_ms:.4f} ms")
    rows["demod_pack"] = dict(
        max_abs_err=float((pe - ppe).abs().max().item()),
        mismatched_symbols=int(diff),
        ms=graph_ms(lambda: demod_kernel.demod_pack(*args)),
        call_ms=time_ms(lambda: demod_kernel.demod_pack(*args), 50),
        plain_ms=time_ms(lambda: demod_kernel.demod_pack_plain(*args), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- detect_words on the block's words (probe row dropped)
    wd = words[:-1]
    n_off = s["n_sym"] - 72 + 1
    dargs = (wd, n_off, s["max_ac_errors"], c["ac_masks"])
    hit, gate, _ = detect_kernel.detect_words(*dargs)
    phit, pgate, _ = detect_kernel.detect_words_plain(*dargs)
    torch.cuda.synchronize()
    n_diff = int((hit != phit).sum().item() + (gate != pgate).sum().item())
    print(f"detect_words: planes {tuple(hit.shape)}: {n_diff} differing "
          f"words (exact required); {int(detect_kernel.popcount(hit.to(torch.int64) & 0xFFFFFFFF).sum().item())} "
          f"hits, {int(detect_kernel.popcount(gate.to(torch.int64) & 0xFFFFFFFF).sum().item())} gates")
    assert n_diff == 0
    # the bit-sliced form's instructions on this card (LOP3, SHF), 32
    # offsets per word, at the int32 rate
    parts = detect_instr_per_word(s["max_ac_errors"])
    cost = detect_words_cost(wd.numel(), hit.numel(), s["max_ac_errors"])
    ops = cost[1]
    b_ms, b_by = bound(*cost)
    two = detect_ops_per_word(s["max_ac_errors"])
    print(f"detect_words: {parts['total']} LOP3/SHF instructions per "
          f"32-offset word ({parts}), {ops:.4g} in all, bound "
          f"{b_ms:.4f} ms; as two-input operations {two} per word, "
          f"{two * hit.numel() / INT32_OPS * 1e3:.4f} ms")
    rows["detect_words"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(lambda: detect_kernel.detect_words(*dargs)),
        call_ms=time_ms(lambda: detect_kernel.detect_words(*dargs), 50),
        plain_ms=time_ms(lambda: detect_kernel.detect_words_plain(*dargs),
                         10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- detect_words with emit_err: the 7 error-count planes as well
    eh, eg, ee = detect_kernel.detect_words(*dargs, emit_err=True)
    ph, pg, perr = detect_kernel.detect_words_plain(*dargs, emit_err=True)
    torch.cuda.synchronize()
    assert torch.equal(eh, hit) and torch.equal(eg, gate)
    n_diff = int((ee != perr).sum().item() + (eh != ph).sum().item() +
                 (eg != pg).sum().item())
    print(f"{DETECT_ERR}: planes {tuple(ee.shape)} + hit and gate: "
          f"{n_diff} words differ from the plain version (exact required)")
    assert n_diff == 0
    # the same operations, and 7 more planes written
    b_ms, b_by = bound(*detect_words_cost(wd.numel(), hit.numel(),
                                          s["max_ac_errors"], emit_err=True))
    rows[DETECT_ERR] = dict(
        max_abs_err=0.0,
        ms=graph_ms(lambda: detect_kernel.detect_words(*dargs,
                                                        emit_err=True)),
        call_ms=time_ms(lambda: detect_kernel.detect_words(
            *dargs, emit_err=True), 50),
        plain_ms=time_ms(lambda: detect_kernel.detect_words_plain(
            *dargs, emit_err=True), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- deinterleave: the flat chain's (2, N) -> (2, D, n_x) copy
    xp = pfb.deinterleave(xb, D)
    pxp = pfb.deinterleave_plain(xb, D)
    n_x = xp.shape[2]
    lib6 = lambda: xb[:, : n_x * D].reshape(  # noqa: E731
        2, n_x, D).transpose(1, 2).contiguous()
    torch.cuda.synchronize()
    assert torch.equal(xp, pxp) and torch.equal(xp, lib6())
    print(f"deinterleave: xp {tuple(xp.shape)} equal to the plain version "
          f"and to the reshape-transpose copy (exact required)")
    b_ms, b_by = bound(*deinterleave_cost(xp.numel()))
    rows["deinterleave"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(lambda: pfb.deinterleave(xb, D)),
        call_ms=time_ms(lambda: pfb.deinterleave(xb, D), 50),
        plain_ms=time_ms(lambda: pfb.deinterleave_plain(xb, D), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib6, 50))

    # ---- pfb_channelize over the branch rows
    cr, ci = pfb_kernel.pfb_channelize(xp, *bank)
    qr, qi = pfb_kernel.pfb_channelize_plain(xp, *bank)
    torch.cuda.synchronize()
    n5 = cr.shape[1]
    err_c = max((cr - qr).abs().max().item(), (ci - qi).abs().max().item())
    err_lib = max((ly[:C, :n5] * sign[:, :n5] - cr).abs().max().item(),
                  (ly[C:, :n5] * sign[:, :n5] - ci).abs().max().item())
    print(f"pfb_channelize: y {tuple(cr.shape)} max |kernel - plain| = "
          f"{err_c:.3e} (tolerance 2e-5); cuDNN conv1d yardstick max "
          f"|conv - kernel| = {err_lib:.3e}")
    assert err_c <= 2e-5, err_c
    b_ms, b_by = bound(*pfb_channelize_cost(xp.numel(), C, n5, M, Q))
    rows["pfb_channelize"] = dict(
        max_abs_err=err_c,
        ms=graph_ms(lambda: pfb_kernel.pfb_channelize(xp, *bank)),
        call_ms=time_ms(lambda: pfb_kernel.pfb_channelize(xp, *bank), 50),
        plain_ms=time_ms(lambda: pfb_kernel.pfb_channelize_plain(xp, *bank),
                         10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 20))
    for r in rows.values():
        r["bound_frac"] = r["bound_ms"] / r["ms"]
    for name, r in rows.items():
        print(f"{name}: kernel {r['ms']:.4f} ms (graph replay; "
              f"{r['call_ms']:.4f} ms per wrapper call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_frac']:.1f} % of it), "
              f"library {r['library_ms']}")
    return rows, wd, snr_k


def block_step_inputs(fe, xb):
    """One block's tail inputs from the fused chain's kernels: the
    (79, W) packed words (probe row dropped) and the (S, 79) slot SNR."""
    c, s = fe.consts, fe.statics
    Q, D = c["h0"].shape
    _, n_data, S, n_k, n_frames = frontend.step_geometry(
        xb.shape[1], Q, D, s["n_sym"], s["slot_ch"], c["probe_re"].shape[0])
    yr, yi, oe = pfb_kernel.pfb_snr(xb, c["h0"], c["h1"], c["dft_c"],
                                    c["dft_s"], c["bin_odd"], n_frames)
    words, pe = demod_kernel.demod_pack(yr, yi, s["demod_gain"], s["n_sym"],
                                        c["probe_re"], c["probe_im"], n_k,
                                        n_data)
    snr_db = snr.assemble_slot_snr(oe, pe, S=S, slot_ch=s["slot_ch"],
                                   kappa=s["kappa"], tile=pfb_kernel.TF)
    return words[:-1], snr_db


def _timed_row(kernel, plain, b_ms, b_by, **extra):
    """A kernel table row: device ms per launch by graph replay, ms per
    wrapper call, the plain version's ms and the bound."""
    row = dict(max_abs_err=0.0, ms=graph_ms(kernel),
               call_ms=time_ms(kernel, 50), plain_ms=time_ms(plain, 10),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra)
    row["bound_frac"] = row["bound_ms"] / row["ms"]
    return row


def _print_row(name, row, note=""):
    print(f"{name}: kernel {row['ms']:.4f} ms (graph replay; "
          f"{row['call_ms']:.4f} ms per wrapper call), plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {100 * row['bound_frac']:.1f} % of it), "
          f"library none{note}")


def le_kernel_check(fe_le, blocks):
    """Phase 3: le_detect in both forms (the step's, hits only, and with
    the dense distances) against its plain version on the LE rows of
    each (label, words) block, hit plane and distances exact; timed on
    the last block.  Returns its row (the step form; the form with the
    distances under "dist_form") and the last block's hit plane."""
    c, s = fe_le.consts, fe_le.statics
    tables = {k: c[k] for k in hit_table.LE_TABLES}
    for label, w in blocks:
        args = (w, c["le_rows"], s["n_sym"], c["le_white_word"],
                c["le_aa_on"], c["le_max_dist"])
        hitw, dist = LE(*args, **tables)
        step_hitw, none = LE(*args, with_dist=False, **tables)
        phitw, pdist = detect.le_detect_plain(*args, **tables)
        torch.cuda.synchronize()
        assert none is None
        n_diff = int((hitw != phitw).sum().item() +
                     (step_hitw != phitw).sum().item() +
                     (dist != pdist).sum().item())
        n_hits = int(detect_kernel.popcount(hitw.to(torch.int64) &
                                            0xFFFFFFFF).sum().item())
        print(f"le_detect ({label}): hit plane {tuple(hitw.shape)} of both "
              f"forms, dist {tuple(dist.shape)}: {n_diff} words and "
              f"distances differ from the plain version (exact required); "
              f"{n_hits} hits before the squelch")
        assert n_diff == 0
    assert n_hits > 0, "no LE hit on the block with LE packets"
    R, W = c["le_rows"].shape[0], w.shape[1]
    n_le = dist.shape[1]
    n_adv = int((c["le_aa_on"] > 0.5).sum().item())
    dist_form = _timed_row(
        lambda: LE(*args, **tables),
        lambda: detect.le_detect_plain(*args, **tables),
        *bound(*le_detect_cost(R, W, n_le, n_adv)))
    row = _timed_row(
        lambda: LE(*args, with_dist=False, **tables),
        lambda: detect.le_detect_plain(*args, with_dist=False, **tables),
        *bound(*le_detect_cost(R, W, n_le, n_adv, with_dist=False)),
        dist_form=dist_form)
    note = f" ({R} rows, {n_adv} advertising, {n_le} offsets)"
    _print_row("le_detect (step form, hits only)", row, note)
    _print_row("le_detect (with the distances)", dist_form, note)
    return row, step_hitw


def hit_table_args(fe, hitw, words, snr_db, le: bool):
    """hit_table's arguments for one tail of fe's step: the classic one
    over detect_words' plane, or the LE one over le_detect's."""
    c, s = fe.consts, fe.statics
    if le:
        return (hitw, words, c["le_rows"], snr_db), dict(
            word_s0=c["le_word_s0"], word_mask_a=c["le_word_mask_a"],
            squelch=s["squelch"], max_hits=s["max_le_hits"],
            le=dict(le_white_word=c["le_white_word"],
                    le_aa_on=c["le_aa_on"],
                    **{k: c[k] for k in hit_table.LE_TABLES}))
    return (hitw, words, None, snr_db), dict(
        word_s0=c["word_s0"], word_mask_a=c["word_mask_a"],
        squelch=s["squelch"], max_hits=s["max_hits"],
        ac={k: c[k] for k in ("ac_a68t", "ac_c68", "ac_masks")})


def hit_table_check(name, fe, cases):
    """Phase 3: hit_table (one epilogue) against its plain version on
    each (label, hit plane, words, slot SNR) case, count, table and
    windows exact; timed on the last case.  Returns its row."""
    le = name == HT_LE
    for label, hitw, words, snr_db in cases:
        args, kw = hit_table_args(fe, hitw, words, snr_db, le)
        got = HT(*args, **kw)
        want = hit_table.hit_table_plain(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), label
        n = int(got[0])
        print(f"{name} ({label}): count {n}, table {tuple(got[1].shape)}, "
              f"windows {tuple(got[2].shape)} equal to the plain version "
              f"(exact required)")
    assert n > 0, f"{name}: no hit on {label}"
    R, w = hitw.shape
    K = min(n, kw["max_hits"])
    row = _timed_row(
        lambda: HT(*args, **kw),
        lambda: hit_table.hit_table_plain(*args, **kw),
        *bound(*hit_table_cost(R, w, snr_db.shape[0], kw["max_hits"],
                               got[2].shape[1], K, le,
                               kw["squelch"] is not None)))
    _print_row(name, row, f" ({R} x {w} plane, {n} hits, max_hits "
                          f"{kw['max_hits']})")
    return row


def tail_dict(fe, hitw, words, snr_db, le: bool) -> dict:
    """hit_table_args as one dict of hit_table's arguments (a tail of
    hit_tables)."""
    args, kw = hit_table_args(fe, hitw, words, snr_db, le)
    return dict(zip(("hitw", "words", "rows", "snr_db"), args), **kw)


def tails_exact(label, tails, got=None):
    """hit_table over one or two tails (dicts) in one launch (or its
    results `got`), each tail's count, table and windows equal to the
    plain version's.  Returns the counts."""
    if got is None:
        got = hit_table._run(tails)
    counts = []
    for t, g in zip(tails, got):
        want = hit_table.hit_table_plain(**t)
        torch.cuda.synchronize()
        assert all(a.dtype == b.dtype and a.shape == b.shape and
                   torch.equal(a, b) for a, b in zip(g, want)), label
        counts.append(int(g[0]))
    return counts


def tail_inputs(fe, seed: int):
    """Random (C, W) symbol words of fe's geometry and an (S, C) slot
    SNR of 4 or 16 dB per slot (the 10 dB squelch then cuts words at
    slot boundaries and mirrors slot S), on fe's device."""
    r = np.random.default_rng(seed)
    C, W = len(fe.bank.channels), -(-fe.n_sym // 32)
    S = fe.n_sym // SYMBOLS_PER_SLOT
    words = r.integers(-2 ** 31, 2 ** 31, (C, W)).astype(np.int32)
    snr_db = np.where(r.random((S, C)) < 0.5, 4.0, 16.0).astype(np.float32)
    return (torch.from_numpy(words).to(fe.device),
            torch.from_numpy(snr_db).to(fe.device))


def density_plane(fe, le: bool, density: str, snr_db, seed: int):
    """A hit plane of fe's classic (le False) or LE tail whose hits all
    pass the squelch of snr_db, as many as HT_DENSITIES' case says (150
    inside the range of the cluster's block (hit_table.cluster_split)
    where the squelch passes the most), and their number."""
    c = fe.consts
    s0 = c["le_word_s0"] if le else c["word_s0"]
    ma = c["le_word_mask_a"] if le else c["word_mask_a"]
    cols = snr_db[:, c["le_rows"]] if le else snr_db
    gate = hit_table._squelch_gate_words(cols, s0, ma, fe.statics["squelch"])
    R, w = gate.shape
    on = np.flatnonzero(detect_kernel.unpack_words(gate, 32 * w).cpu()
                        .numpy())
    if density == "one block":
        split = hit_table.cluster_split(R * w)
        blocks = [on[(on >= 32 * lo) & (on < 32 * hi)] for lo, hi in
                  (split.block_range(b, R * w) for b in range(split.blocks))]
        on = max(blocks, key=len)
    max_hits = fe.max_le_hits if le else fe.max_hits
    k = min(on.size, {"zero": 0, "one": 1, "exactly max_hits": max_hits,
                      "above max_hits": max_hits + 57,
                      "one block": 150}[density])
    hit = np.zeros(R * 32 * w, bool)
    hit[np.random.default_rng(seed).choice(on, k, replace=False)] = True
    hitw = np.packbits(hit.reshape(R, 32 * w), axis=1, bitorder="little")
    return torch.from_numpy(hitw.view("<u4").view(np.int32).copy()).to(
        fe.device), k


def density_cases(fe, seed: int = 0):
    """(label, classic tail, LE tail, hits of each) of every density
    case on fe's geometry: both tails over one random word plane and
    slot SNR."""
    for j, density in enumerate(HT_DENSITIES):
        words, snr_db = tail_inputs(fe, seed + j)
        cp, kc = density_plane(fe, False, density, snr_db, seed + j)
        lp, kl = density_plane(fe, True, density, snr_db, seed + 100 + j)
        yield (density, tail_dict(fe, cp, words, snr_db, False),
               tail_dict(fe, lp, words, snr_db, True), (kc, kl))


def hit_cluster_checks(fes):
    """Phase 3: hit_table's cluster kernel on HT_DENSITIES' cases of
    each (label, front end with LE on): each form alone and both in one
    launch, and the two forms launched at once on two streams, each
    equal to the plain version exactly."""
    for geo, fe in fes:
        n = 0
        side = (torch.cuda.Stream(), torch.cuda.Stream())
        pending = []
        for density, cl, le, k in density_cases(fe):
            got = tails_exact(f"{geo} {density} classic", (cl,))
            got += tails_exact(f"{geo} {density} LE", (le,))
            assert got == list(k), (geo, density, got, k)
            both = tails_exact(f"{geo} {density} joint", (cl, le))
            assert both == got, (geo, density, both, got)
            n += 3
            # the two tails at once, each on its own stream, no sync
            for t, st in zip((cl, le), side):
                st.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(st):
                    pending.append((t, hit_table._run((t,))))
        torch.cuda.synchronize()
        for t, got in pending:
            tails_exact(f"{geo} two streams", (t,), got=got)
        print(f"hit_table cluster ({geo}, {len(fe.bank.channels)} x "
              f"{fe.consts['word_s0'].shape[0]} classic and "
              f"{len(fe.le_rows)} x {fe.consts['le_word_s0'].shape[0]} LE "
              f"words): {n} launches over {len(HT_DENSITIES)} density "
              f"cases ({', '.join(HT_DENSITIES)}), each form alone and "
              f"both in one launch, and {len(pending)} tails on two streams at once: all equal to "
              f"the plain version (exact required)")


def tail_checks(fe, fe_le, words, snr_db, words5, snr5, le_hitw5):
    """Phase 3: hit_table's two forms against the plain version: the
    classic one over detect_words' planes of phase 3's block and of
    phase 5's first block, the LE one over le_detect's plane of phase
    5's first block, each timed on phase 5's block; both in one launch
    (the step's joint form, timed as a nested row of the classic one),
    and the launch floor beside them.  Returns their rows."""
    det = lambda f, w: detect_kernel.detect_words(  # noqa: E731
        w, f.statics["n_sym"] - 72 + 1, f.statics["max_ac_errors"],
        f.consts["ac_masks"])[0]
    hitw5 = det(fe_le, words5)
    rows = {
        "hit_table": hit_table_check("hit_table", fe, (
            ("phase 3's block", det(fe, words), words, snr_db),
            ("phase 5's first block", hitw5, words5, snr5))),
        HT_LE: hit_table_check(HT_LE, fe_le, (
            ("phase 5's first block", le_hitw5, words5, snr5),))}
    cl = tail_dict(fe_le, hitw5, words5, snr5, False)
    le = tail_dict(fe_le, le_hitw5, words5, snr5, True)
    counts = tails_exact("joint, phase 5's first block", (cl, le))
    cost = [hit_table_cost(*t["hitw"].shape, t["snr_db"].shape[0],
                           t["max_hits"], hit_table_row_words(t),
                           min(n, t["max_hits"]), t.get("le") is not None,
                           t["squelch"] is not None)
            for t, n in zip((cl, le), counts)]
    joint = _timed_row(
        lambda: hit_table.hit_tables(cl, le),
        lambda: [hit_table.hit_table_plain(**t) for t in (cl, le)],
        *bound(sum(c[0] for c in cost), sum(c[1] for c in cost), cost[0][2]))
    _print_row("hit_table joint (both tails, one launch)", joint,
               f" (counts {counts})")
    floor = {"one_warp": graph_ms(lambda: hit_table.launch_floor(0)),
             "one_cluster": graph_ms(lambda: hit_table.launch_floor(1, 1)),
             "two_clusters": graph_ms(lambda: hit_table.launch_floor(1, 2))}
    print(f"launch floor (an empty kernel, graph replay): one block of 32 "
          f"threads {floor['one_warp']:.4f} ms; hit_table's grid, one "
          f"cluster of {hit_table.CLUSTER} x {hit_table.THREADS} threads "
          f"with two cluster barriers {floor['one_cluster']:.4f} ms, two "
          f"{floor['two_clusters']:.4f} ms")
    rows["hit_table"].update(joint=joint, launch_floor_ms=floor)
    return rows


def hit_table_row_words(t: dict) -> int:
    """A tail's window words per hit."""
    return (hit_table.WIN_SYMBOLS if t.get("le") is None
            else hit_table.LE_WIN_SYMBOLS) // 32 + 1


def device_events(fn, n: int):
    """torch.profiler over n calls of fn: its device-side events (a host
    op's device time repeats that of the kernels it launched), busiest
    first, and the window's host-clock seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and
           e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    return evs, wall


def step_profile(label, step, xb, kernels, reps: int = 20):
    """Phase 3b: one block's whole device step on one chain (`step`, its
    kernels, named in `kernels`, and the torch glue between them) timed
    with CUDA events, and a torch.profiler window over a few steps:
    device time by kernel, and the device's busy share of the CUDA-event
    step time (the profiler's own overhead stretches its window's host
    clock, so that is not the denominator).  Returns {kernel name: its
    profiled device ms per step}."""
    ms = time_ms(lambda: step(xb), reps)
    print(f"{label} step: {ms:.4f} ms per block (CUDA events, {reps} "
          f"steps)")
    n = 5
    evs, wall = device_events(lambda: step(xb), n)
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / n
    assert busy > 0, "the profiler saw no device time"
    print(f"{label} profiler: {n} steps, device busy {busy:.4f} ms per "
          f"step = {100 * busy / ms:.1f}% of the {ms:.4f} ms CUDA-event "
          f"step (profiled window {wall * 1e3 / n:.3f} ms per step, host "
          f"clock)")
    print_ops(evs, n, 12)
    prof_ms = {}
    for name in kernels:
        sym = SYMBOL.get(name, f"{name}_kernel")
        t = [e.self_device_time_total for e in evs
             if e.key.removeprefix("void ").startswith(sym)]
        assert t, f"{sym} not in the profile"
        prof_ms[name] = sum(t) / n / 1e3
    return prof_ms


def print_ops(evs, n: int, k: int):
    """The k busiest device ops of a profiler window over n steps."""
    for e in evs[:k]:
        print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms/step "
              f"{e.count // n:4d} calls/step  {e.key[:70]}")


# ------------------------------------------------------------------ phase 3d

STEP_OUTPUTS = ("snr_db", "n_hits", "tab", "windows", "n_le", "le_tab",
                "le_windows")


class EagerIngest(ingest.PipelinedIngest):
    """PipelinedIngest with its step run op by op at every block (a
    CompiledStep that is not a graph): the eager form of stream(), which
    phase 3d holds the compiled one to."""

    def _build(self, graph=None):
        return super()._build(graph=False)


def check_replay(label, got, want):
    """A compiled step's outputs against the eager step's: every output
    bit for bit (the SNR's float32 bits, the counts, hit tables and
    windows)."""
    assert len(got) == len(want) == len(STEP_OUTPUTS), label
    for name, g, w in zip(STEP_OUTPUTS, got, want):
        assert (g is None) == (w is None), (label, name)
        if g is None:
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.shape == w.shape and torch.equal(g, w), (label, name)


def busy_ms(fn, n: int = 5):
    """Device time of fn per call (kernels, copies and memsets) from a
    profiler window over n calls, or None when it saw no device time."""
    t = sum(e.self_device_time_total for e in device_events(fn, n)[0])
    return t / 1e3 / n if t > 0 else None


def _share(busy, ms):
    return ("not measured (the profiler saw no device time)" if busy is None
            else f"{busy:.4f} ms = {100 * busy / ms:.1f}%")


def compiled_phase(fe, fe_le, xb):
    """Phase 3d: each chain's compiled step (FrontEnd.compiled_step, one
    CUDA graph replay) on phase 3's block against its eager step, bit for
    bit: fused LE off, fused LE on, flat LE on, and the conv bank at
    81 Msps (its own planted block).  Event ms per block of each form
    and the device-busy share of each; then stream() over phase 4's
    capture, eager and compiled, in turns: the same hits, samples/s and
    the stage split."""
    fe81 = frontend.FrontEnd(81e6, CENTER, block_slots=BLOCK_SLOTS)
    x81, _ = plant_capture(fe81, 1, seed=3)
    xb81 = fe81.to_planes(x81[: fe81.block_samples])
    chains = (("fused LE off", fe, "fused", xb),
              ("fused LE on", fe_le, "fused", xb),
              ("flat LE on", fe_le, "flat", xb),
              ("conv bank 81 Msps", fe81, "flat", xb81))
    for label, f, chain, x in chains:
        eager = f.fused_step if chain == "fused" else f.device_step
        want = [None if o is None else o.clone() for o in eager(x)]
        step = f.compiled_step(chain)
        check_replay(label, step(x), want)
        check_replay(label + ", again", step(x), want)
        run_eager = functools.partial(eager, x)
        e_ms, r_ms = time_ms(run_eager, 20), time_ms(step.replay, 20)
        e_busy, r_busy = busy_ms(run_eager), busy_ms(step.replay)
        print(f"compiled {label}: replay equals eager bit for bit (SNR, "
              f"counts, tables, windows); eager {e_ms:.4f} ms per block, "
              f"device busy {_share(e_busy, e_ms)}; replay {r_ms:.4f} ms "
              f"per block, device busy {_share(r_busy, r_ms)} (CUDA "
              f"events, 20 steps; profiler, 5); launches per replay "
              f"{step.launches_per_replay}")
        if chain == "fused":
            evs, _ = device_events(step.replay, 5)
            n_ops = sum(e.count for e in evs) // 5
            print(f"compiled {label}: {n_ops} device ops per replay "
                  f"(kernels, copies and memsets; profiler, 5 replays); "
                  f"every op")
            print_ops(evs, 5, len(evs))
            # hit_table keeps no state: the replay's one memset is
            # pfb_snr's (it zeroes the energies its tiles add to,
            # csrc/pfb_snr.cu), no int64 fill, and one hit_table launch
            # per replay (both tails)
            n_set = sum(e.count for e in evs if "memset" in e.key.lower())
            fills = [e.key for e in evs if "FillFunctor<long" in e.key]
            assert n_set == 5 and not fills, (label, n_set, fills)
            n_ht = sum(e.count for e in evs if e.key.removeprefix(
                "void ").startswith("hit_table_kernel"))
            assert n_ht == 5, (label, n_ht)
    stream_phase()


def stream_phase(n_blocks: int = N_BLOCKS, runs: int = 2):
    """stream() over phase 4's capture on two fresh front ends of the
    survey's configuration, one with the eager ingest (EagerIngest), one
    compiled: a cold run each, then `runs` warm runs each in turns
    (e, c, c, e, ...): the same hits, samples/s host clock to the last
    result and the stage split (metrics: wire_encode, h2d, device_step,
    assemble, ms per block)."""
    from gr_bluetooth_tpu_torch.utils.metrics import metrics
    fes = {form: frontend.FrontEnd(FS, CENTER, block_slots=BLOCK_SLOTS,
                                   max_ac_errors=1)
           for form in ("eager", "compiled")}
    fes["eager"]._ingests["f32"] = EagerIngest(fes["eager"], "f32")
    x, planted = plant_capture(fes["compiled"], n_blocks)
    n_in = n_blocks * fes["compiled"].step_samples
    cold = {form: list(f.stream(x)) for form, f in fes.items()}
    keys = {form: stream_keys(res) for form, res in cold.items()}
    assert keys["eager"] == keys["compiled"], "stream() hits differ"
    check_survey([h for r in cold["compiled"] for h in r.hits], planted)
    order = [("eager", "compiled")[(i + i // 2) % 2] for i in range(2 * runs)]
    for form in order:
        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(fes[form].stream(x))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert stream_keys(got) == keys[form]
        st = metrics.snapshot()["stages"]
        split = ", ".join(f"{k} {st[k]['total_s'] * 1e3 / n_blocks:.4f}"
                          for k in ("wire_encode", "h2d", "device_step",
                                    "assemble") if k in st)
        print(f"stream() {form}: {n_in / dt:.6g} samples/s host clock "
              f"({dt:.4f} s for {n_blocks} blocks, warm); stage ms per "
              f"block: {split}")
    ing = fes["compiled"]._ingests["f32"]
    print(f"stream() compiled: {len(keys['compiled'][0])} hits equal to "
          f"the eager ingest's; launches per replay "
          f"{ing._step.launches_per_replay}")


def main_path(survey, n_blocks: int):
    """Phase 4: the survey over a planted capture, counters read around
    exactly this run; then the same capture again, warm, for the
    steady-state host-clock rate and its stage breakdown."""
    from gr_bluetooth_tpu_torch.utils.metrics import metrics
    x, planted = plant_capture(survey.fe, n_blocks)
    _zero_counts()
    t0 = time.perf_counter()
    obs = list(survey.run(x, emit_console=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    n_found = check_survey(obs, planted)
    n_in = n_blocks * survey.fe.step_samples
    print(f"main path: {n_blocks} blocks of {survey.fe.block_slots} slots, "
          f"{len(planted)} packets planted, {len(obs)} observations, "
          f"{n_found} (LAP, channel) pairs found; launches {launches}")
    print(f"main path: {n_in / dt:.6g} samples/s host clock to synchronize "
          f"({dt:.4f} s for {n_in} samples), peak device memory "
          f"{peak / 2 ** 20:.1f} MiB")
    _want_fused(launches, n_blocks, survey.fe.enable_le)

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


def flat_path(fe, n_blocks: int):
    """Phase 5: stream_sync (the flat chain, LE on) over a capture with
    classic and LE advertising packets, counters read around exactly
    this run; then the same capture through stream() (the fused chain)
    against it."""
    x, planted, le_planted = plant_le_capture(fe, n_blocks)
    _zero_counts()
    t0 = time.perf_counter()
    flat = list(fe.stream_sync(x))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    n_found = check_survey([h for r in flat for h in r.hits], planted)
    n_le = check_le([h for r in flat for h in r.le_hits], le_planted)
    n_in = x.shape[0]
    print(f"flat path: {len(flat)} blocks of {fe.block_slots} slots, "
          f"{len(planted)} classic and {len(le_planted)} LE advertising "
          f"packets planted, {n_found} (LAP, channel) pairs and {n_le} LE "
          f"packets found, {sum(len(r.le_hits) for r in flat)} LE hits in "
          f"all; launches {launches}")
    print(f"flat path: {n_in / dt:.6g} samples/s host clock to synchronize "
          f"({dt:.4f} s for {n_in} samples, the first blocks' warm-up "
          f"included), peak device memory {peak / 2 ** 20:.1f} MiB")
    assert len(flat) == n_blocks, len(flat)
    _want_chain(launches, n_blocks, FLAT, True)

    fused = list(fe.stream(x))
    d_snr, d_sym, n_sym = compare_chains(fe, flat, fused, x.shape[0])
    print(f"flat path against stream() (fused chain, LE on): same classic "
          f"and LE hit keys, slot SNR within {d_snr:.3e} dB, {d_sym} of "
          f"{n_sym} window symbols differ")
    return launches


def small_reference():
    """Phase 6: an 8 Msps survey on the card against the plain versions
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


def dense_detector(words, n_sym: int, masks, max_ac_errors: int = 6):
    """Phase 3c: the dense detector entry points, whose kernel is
    detect_words with emit_err.  The block's (C, W) words unpacked to
    (C, n_sym) bits go through gated_error and classic_detect_words on
    the words' device and through the plain versions on the CPU, which
    must agree at every offset; classic_detect_words' hit plane must
    equal detect_words' at the same max_ac_errors.  Returns
    (error-plane launches of the device run, offsets, hits)."""
    bits = detect_kernel.unpack_words(words, n_sym)
    detect_kernel.detect_words.err_launches = 0
    g = detect_kernel.gated_error(bits)
    hits, err = detect_kernel.classic_detect_words(bits, max_ac_errors)
    launches = detect_kernel.detect_words.err_launches
    g, hits, err = g.cpu(), hits.cpu(), err.cpu()
    cpu_bits = bits.cpu()
    assert torch.equal(g, detect_kernel.gated_error(cpu_bits))
    ph, pe = detect_kernel.classic_detect_words(cpu_bits, max_ac_errors)
    assert torch.equal(hits, ph) and torch.equal(err, pe)
    n = n_sym - 72 + 1
    assert g.shape == (words.shape[0], n)
    hitw, _, _ = detect_kernel.detect_words(words, n, max_ac_errors, masks)
    assert torch.equal(detect_kernel.unpack_words(hitw, n).cpu() > 0, hits)
    n_hits = int(hits.sum())
    assert n_hits > 0, "no access code in the block"
    print(f"dense detector: gated_error and classic_detect_words "
          f"{tuple(g.shape)} equal to the plain versions at every offset; "
          f"{n_hits} hits at max_ac_errors={max_ac_errors}, the same as "
          f"detect_words' hit plane; {launches} error-plane launches")
    return launches, n, n_hits


def _pkt_key(p):
    return (p.clkn, p.channel, p.lap, p.uap, p.packet_type,
            None if p.payload is None else p.payload.tobytes())


def check_sniffer(decoded, bus, sent, sims, min_decoded: int):
    """Every decoded packet is a planted one: at its slot (clkn), on its
    channel, with its LAP, its piconet's UAP and its type (sent rows are
    (slot, channel, lap[, type]); without a type the capture planted DM1
    only), none decoded twice, at least min_decoded of them; exactly one
    uap_found per piconet, with its UAP.  Returns the decoded count."""
    uap_of = {s.lap: s.uap for s in sims}
    planted = {row[0]: (row[1], row[2], row[3] if len(row) > 3 else 3)
               for row in sent}
    seen = set()
    for p in decoded:
        want = planted.get(p.clkn)
        assert want is not None, f"decoded a packet at unplanted slot {p.clkn}"
        got = (p.channel, p.lap, p.packet_type)
        assert got == want, f"slot {p.clkn}: decoded {got}, planted {want}"
        assert p.uap == uap_of[p.lap], (p.clkn, hex(p.uap))
        assert p.clkn not in seen, f"slot {p.clkn} decoded twice"
        seen.add(p.clkn)
    assert len(seen) >= min_decoded, \
        f"{len(seen)} decoded, at least {min_decoded} required"
    found = sorted((e["lap"], e["uap"]) for e in bus.events("uap_found"))
    assert found == sorted(uap_of.items()), f"uap_found events {found}"
    return len(seen)


def check_uap(mode, uap, sent, sim):
    """UapDiscovery found the piconet's UAP and a CLK1-6 offset that maps
    the capture's slots onto its master's clock."""
    pn = mode.piconet
    assert uap == sim.uap, f"UAP {uap} found, {sim.uap:#x} planted"
    assert pn.have_clk6
    for slot, *_ in sent[:8]:
        assert (slot + pn.clk_offset) & 0x3F == (sim.clk0 + slot) & 0x3F


def check_hopper(mode, decoded, sim):
    """Hopper acquired CLK1-27 once, at the master's clock, and every
    packet it decoded carries the piconet's LAP and UAP, the master's
    clock and the hop channel of that clock.  Returns the number of
    initial CLK1-27 candidates."""
    pn = mode.piconet
    assert pn.have_clk27, "CLK1-27 not acquired"
    assert pn.get_offset() == sim.clk0, hex(pn.get_offset())
    assert len(mode.bus.events("clock_acquired")) == 1
    assert decoded, "nothing decoded after acquisition"
    for p in decoded:
        assert (p.lap, p.uap) == (sim.lap, sim.uap), (hex(p.lap), hex(p.uap))
        assert p.clock & 0x7FFFFFF == (sim.clk0 + p.clkn) & 0x7FFFFFF
        assert p.channel == sim.channel_at(p.clkn)
    return mode.bus.events("hop_reversal_started")[0]["candidates"]


def replay_winnower(pn, device):
    """The piconet's recorded (offset, channel) pattern through a
    DeviceWinnower on `device` and on the CPU: the same candidates at
    every step, ending at the acquired clock.  Returns the survivors."""
    addr = ((pn.uap << 24) | pn.lap) & 0xFFFFFFF
    clk6 = (pn.clk_offset + pn.first_pkt_time) & 0x3F
    ws = [hop_ops.DeviceWinnower(addr, clk6, int(pn.pattern_channels[0]),
                                 aliased=pn.aliased, afh=pn.afh, device=d)
          for d in (device, "cpu")]
    assert ws[0].mask.device.type == torch.device(device).type
    for off, ch in zip(pn.pattern_indices, pn.pattern_channels):
        counts = [w.winnow(int(off), int(ch)) for w in ws]
        assert counts[0] == counts[1], counts
    got = ws[0].candidates()
    assert np.array_equal(got, ws[1].candidates())
    want = (pn.clk_offset + pn.first_pkt_time) & 0x7FFFFFF
    assert got.tolist() == [want], (got[:4], want)
    return got


def check_le_connection(mode, sim, sent):
    """One le_connection event with the sim's access address, CRCInit and
    hop increment, and every planted data packet seen on its channel
    index at its slot (+-1) with a good CRC and the channel the follower
    predicts.  Returns the data packets seen."""
    (conn,) = mode.bus.events("le_connection")
    assert (conn["aa"], conn["crc_init"], conn["hop"]) == \
        (sim.conn_aa, sim.crc_init, sim.hop_increment), conn
    pn = mode.low_energy_piconets[sim.conn_aa]
    data = [p for p in mode.le_packets
            if p.aa == sim.conn_aa and p.index < 37]
    for slot, index, kind in sent:
        if kind != "DATA":
            continue
        assert any(p.index == index and abs(p.clkn - slot) <= 1 and
                   p.crc_ok(sim.crc_init) for p in data), \
            f"data packet at slot {slot} on index {index} not followed"
    assert pn.crc_bad_count == 0 and pn.crc_ok_count == len(data)
    assert all(pn.predict_channel(p.clkn) == p.index for p in data)
    return len(data)


def _zero_counts():
    for k in KERNELS:
        k.launches = 0
    detect_kernel.detect_words.err_launches = 0
    LE.dist_launches = 0
    HT.le_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _counts():
    c = {k.__name__: k.launches for k in KERNELS}
    c[DETECT_ERR] = detect_kernel.detect_words.err_launches
    c[LE_DIST] = LE.dist_launches
    c[HT_LE] = HT.le_launches
    return c


def _want_chain(counts, n_blocks, chain, le: bool):
    """A path's launches: the chain's kernels (`chain`) and the hit table
    once per block, le_detect (its step form) and the hit table's LE
    form once per block where LE is on (`le`), no other."""
    on = {k.__name__ for k in chain} | {HT.__name__}
    if le:
        on |= {LE.__name__, HT_LE}
    for name, n in counts.items():
        want = n_blocks if name in on else 0
        assert n == want, (name, counts, n_blocks)


def _want_fused(counts, n_blocks, le: bool):
    """The modes' path: the fused chain's kernels once per block (see
    _want_chain)."""
    _want_chain(counts, n_blocks, FUSED, le)


def sniffer_phase(name: str, x, sent, sims):
    """Phase 7a: Sniffer(80 Msps, LE on).run over one of bench.py's
    sniffer captures, counters read around exactly that run; then the
    host decode alone, over the same capture's fetched blocks through a
    fresh Sniffer, which must decode the same packets."""
    sn = Sniffer(FS, CENTER, block_slots=BLOCK_SLOTS, bus=EventBus())
    _zero_counts()
    t0 = time.perf_counter()
    decoded = sn.run(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    n = check_sniffer(decoded, sn.bus, sent, sims, MIN_DECODED[name])
    blocks = list(sn.fe.stream(x))
    _want_fused(counts, len(blocks), sn.fe.enable_le)
    n_hits = sum(len(r.hits) for r in blocks)
    again = Sniffer(FS, CENTER, block_slots=BLOCK_SLOTS, bus=EventBus())
    t0 = time.perf_counter()
    d2 = again.run_blocks(iter(blocks))
    th = time.perf_counter() - t0
    assert [_pkt_key(p) for p in d2] == [_pkt_key(p) for p in decoded]
    n_le = sum(len(r.le_hits) for r in blocks)
    print(f"sniffer {name}: {len(sent)} planted, {n_hits} hits, {n} decoded "
          f"(each a planted packet), uap_found {len(sims)} of {len(sims)}, "
          f"clock_lost {len(sn.bus.events('clock_lost'))}; {n_le} LE hits; "
          f"launches {counts}")
    print(f"sniffer {name}: {dt:.4f} s host clock for {x.shape[0]} samples "
          f"({len(blocks)} blocks), {x.shape[0] / dt:.6g} samples/s to the "
          f"last result; host decode alone {th:.4f} s = "
          f"{th / max(n_hits, 1) * 1e6:.1f} us per hit; peak device memory "
          f"{peak / 2 ** 20:.1f} MiB")
    return sn.fe, blocks


def e2e_phase(x, sent, sim):
    """Phase 7b: UapDiscovery and then Hopper over the e2e capture, the
    Hopper's on the int16 wire (bench.py:457-460); counters read around
    each run.  The Hopper's recorded pattern is replayed through a
    DeviceWinnower on the card and on the CPU."""
    ud = UapDiscovery(FS, CENTER, lap=sim.lap, block_slots=BLOCK_SLOTS,
                      bus=EventBus())
    _zero_counts()
    t0 = time.perf_counter()
    uap = ud.run(x)
    torch.cuda.synchronize()
    dt_uap = time.perf_counter() - t0
    c_uap = _counts()
    check_uap(ud, uap, sent, sim)
    assert c_uap["pfb_snr"] >= 1 and c_uap[DETECT_ERR] == 0, c_uap

    hp = Hopper(FS, CENTER, lap=sim.lap, block_slots=BLOCK_SLOTS,
                bus=EventBus())
    _zero_counts()
    t0 = time.perf_counter()
    decoded = hp.run_blocks(hp.fe.stream(x, wire="i16"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    n0 = check_hopper(hp, decoded, sim)
    n_blocks = -(-x.shape[0] // hp.fe.step_samples)
    _want_fused(counts, n_blocks, hp.fe.enable_le)
    assert hp.piconet.device.type == "cuda" and \
        n0 > hp.piconet.DEVICE_WINNOW_THRESHOLD, (hp.piconet.device, n0)
    survivors = replay_winnower(hp.piconet, hp.piconet.device)
    print(f"uap discovery e2e: UAP {uap:#04x}, CLK1-6 offset "
          f"{ud.piconet.clk_offset}, {dt_uap:.4f} s host clock; launches "
          f"{c_uap}")
    print(f"hopper e2e (int16 wire): CLK1-27 offset "
          f"{hp.piconet.get_offset():#07x} from {n0} candidates on the card, "
          f"{len(hp.piconet.pattern_indices)} packets; {len(decoded)} "
          f"packets decoded at the master's clock; replayed winnow on the "
          f"card equals the CPU's and ends at {survivors.tolist()}")
    print(f"hopper e2e: {dt:.4f} s host clock for {x.shape[0]} samples, "
          f"{x.shape[0] / dt:.6g} samples/s to the last result; peak device "
          f"memory {peak / 2 ** 20:.1f} MiB; launches {counts}")


def le_phase():
    """Phase 7c: Sniffer over an LE connection capture at full band (a
    CONNECT_REQ on advertising channel 38, then one data packet per
    connection event, CSA#1 over all 37 data channels)."""
    sim = testing.LeConnectionSim()
    x, sent = testing.make_le_connection_capture(
        sim, n_slots=2 * BLOCK_SLOTS, fs=FS, center_freq=CENTER)
    sn = Sniffer(FS, CENTER, block_slots=BLOCK_SLOTS, bus=EventBus())
    _zero_counts()
    t0 = time.perf_counter()
    sn.run(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    n = check_le_connection(sn, sim, sent)
    _want_fused(counts, 2, sn.fe.enable_le)
    print(f"sniffer LE connection: AA {sim.conn_aa:#010x}, CRCInit "
          f"{sim.crc_init:#08x}, hop {sim.hop_increment}; {n} data packets "
          f"followed with a good CRC of "
          f"{sum(1 for *_, k in sent if k == 'DATA')} planted; {dt:.4f} s "
          f"host clock; launches {counts}")

# ------------------------------------------------------------------ phase 8

ROOT = os.path.dirname(os.path.abspath(__file__))
CLI = "gr_bluetooth_tpu_torch.apps.btrx"
LOOKAHEAD = frontend.LOOKAHEAD_SLOTS
_LOG_PKT = re.compile(r"grbt\.sniffer INFO time\s+(\d+) ch\s+(\d+) LAP "
                      r"([0-9a-f]{6}) (\S+)")


def run_cli(args, stdin: bytes, device=None, module=CLI, timeout=600):
    """The port's btrx (or another of its CLIs, `module`) as a subprocess
    from the checkout's root, fed `stdin`; `device` adds --device.
    Returns (CompletedProcess, host seconds)."""
    cmd = [sys.executable, "-m", module, *args]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, input=stdin, capture_output=True, cwd=ROOT,
                       env=env, timeout=timeout)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{module} exit {r.returncode}:\n"
                           f"{r.stderr.decode()[-3000:]}")
    return r, dt


def stdin_chunks(inter: np.ndarray, step: int, wire: str):
    """The wire chunks that btrx's stdin path (io/sources.stream_stdin_raw)
    cuts from a byte stream: `step` samples each from the first byte, the
    last one padded with the wire's zero byte."""
    from gr_bluetooth_tpu_torch.io.ingest import WIRE_ZERO_BYTE
    n = inter.shape[0]
    for i in range(0, n, step):
        c = inter[i: i + step]
        if c.shape[0] < step:
            pad = np.full((step - c.shape[0],) + c.shape[1:],
                          WIRE_ZERO_BYTE[wire], c.dtype)
            c = np.concatenate([c, pad])
        yield c


def frames_decoded(frames):
    """pcap records (caplen, bytes) -> [(lap, uap, type, channel)] of the
    decoded-packet frames (dst = NAP:UAP:LAP, tun_format body), ID frames
    (empty bodies) left out."""
    out = []
    for _, f in frames:
        body = f[14:]
        if not body:
            continue
        dst = int.from_bytes(f[0:6], "big")
        out.append((dst & 0xFFFFFF, (dst >> 24) & 0xFF,
                    (body[6] & 0x78) >> 3, body[4]))
    return out


def planted_by_slot(sent, sims):
    """slot -> (channel, lap, uap, type) of a capture's sent rows
    ((slot, channel, lap[, type]); DM1 where no type is given)."""
    uap_of = {s.lap: s.uap for s in sims}
    return {row[0]: (row[1], row[2], uap_of[row[2]],
                     row[3] if len(row) > 3 else 3) for row in sent}


def check_cli_frames(frames, sent, sims, min_decoded: int):
    """Every decoded frame is a planted (LAP, UAP, type, channel), at
    least min_decoded of them.  Returns the decoded count."""
    planted = {(lap, uap, t, ch)
               for ch, lap, uap, t in planted_by_slot(sent, sims).values()}
    dec = frames_decoded(frames)
    for d in dec:
        assert d in planted, f"unplanted decoded frame {d}"
    assert len(dec) >= min_decoded, (len(dec), min_decoded)
    return len(dec)


def logged_packets(stderr: bytes):
    """[(clkn, channel, lap, type name)] of the sniffer's decoded-packet
    log lines in a btrx run's stderr."""
    return [(int(m.group(1)), int(m.group(2)), int(m.group(3), 16),
             m.group(4)) for m in map(_LOG_PKT.search,
                                      stderr.decode().splitlines()) if m]


def check_air_slots(packets, sent, sims, shift: int = LOOKAHEAD,
                    slack: int = 0):
    """Every logged packet is a planted one at its air slot: clkn - shift
    (a stream that starts from a zero carry reports air slot s at clkn
    s + LOOKAHEAD_SLOTS), or up to `slack` slots later where a clock slip
    rounded dropped air to whole slots.  Returns (count, count exactly
    at the slot)."""
    planted = planted_by_slot(sent, sims)
    exact = 0
    for clkn, ch, lap, tname in packets:
        t = TYPE_NAMES.index(tname)
        ok = [d for d in range(slack + 1)
              if planted.get(clkn - shift + d, (None,) * 4)[:2] == (ch, lap)
              and planted[clkn - shift + d][3] == t]
        assert ok, (f"logged packet clkn {clkn} ch {ch} LAP {lap:06x} "
                    f"{tname} is not planted at its air slot")
        exact += ok[0] == 0
    return len(packets), exact


def cli_phase(x, sent, sims, device=None, n_min=MIN_DECODED["max_rate"],
              fs=FS, center=CENTER):
    """Phase 8a: btrx -S on int16 stdin at full band against the same
    wire chunks through PipelinedIngest.run in this process (zero carry,
    as the stdin path starts), then the same bytes with --live."""
    from gr_bluetooth_tpu_torch.io import ingest, native
    from gr_bluetooth_tpu_torch.io.writers import PcapWriter
    lib = native.load()
    assert lib is not None, "the native runtime did not build"
    print(f"cli: native runtime {native.library_path()} (g++ build of "
          f"{os.path.relpath(native.SOURCE, ROOT)}) loaded")
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    inter = ingest.wire_encode(planes, "i16")
    data = inter.tobytes()
    n_in = inter.shape[0]
    args = ["-r", f"{fs:.0f}", "-f", f"{center:.0f}", "-S", "-i", "-", "-s",
            "--stats"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.pcap")
                 for k in ("cli", "live", "inproc")}
        r, dt = run_cli(args + ["-W", paths["cli"]], data, device)
        print(f"cli: btrx {' '.join(args)}: {dt:.4f} s host clock for "
              f"{n_in} samples = {n_in / dt:.6g} samples/s (process start, "
              f"CUDA context and kernel loads included)")
        frames = pcap_frames(paths["cli"])
        n_dec = check_cli_frames(frames, sent, sims, n_min)
        logged = logged_packets(r.stderr)
        n_log, exact = check_air_slots(logged, sent, sims)
        assert n_log == n_dec and exact == n_log, (n_log, n_dec, exact)

        sn = Sniffer(fs, center, block_slots=16, bus=EventBus(),
                     writer=PcapWriter(paths["inproc"]),
                     device=device or "cuda")
        pipe = ingest.PipelinedIngest(sn.fe, "i16")
        t0 = time.perf_counter()
        sn.run_blocks(pipe.run(stdin_chunks(inter, sn.fe.step_samples,
                                            "i16"), 0, bus=sn.bus))
        dt_in = time.perf_counter() - t0
        sn.writer.close()
        ref = pcap_frames(paths["inproc"])
        assert frames == ref, (len(frames), len(ref))
        print(f"cli: {len(frames)} pcap frames ({n_dec} decoded packets, "
              f"each a planted (LAP, UAP, type, channel) at its air slot) "
              f"equal in order to the in-process Sniffer's over the same "
              f"wire chunks ({dt_in:.4f} s = {n_in / dt_in:.6g} samples/s)")

        rl, dtl = run_cli(args + ["--live", "-W", paths["live"]], data,
                          device)
        m = re.search(rb"live source: (\d+) overruns, (\d+) bytes dropped",
                      rl.stderr)
        overruns, dropped = (int(m.group(1)), int(m.group(2))) if m else \
            (0, 0)
        live = pcap_frames(paths["live"])
        lp = logged_packets(rl.stderr)
        if overruns == 0:
            assert live == frames, "live run without overruns differs"
            n_l, ex = check_air_slots(lp, sent, sims)
        else:
            check_cli_frames(live, sent, sims, 1)
            n_l, ex = check_air_slots(lp, sent, sims, slack=1)
        print(f"cli --live: {overruns} overruns, {dropped} bytes dropped; "
              f"{len(frames_decoded(live))} decoded, {n_l} logged packets "
              f"each planted at its air slot ({ex} exactly, the rest one "
              f"slot early after a slip rounded to whole slots); "
              f"{dtl:.4f} s host clock = {n_in / dtl:.6g} samples/s")
    return dict(cli_sps=n_in / dt, live_sps=n_in / dtl, overruns=overruns)


def pcap_frames(path):
    """A pcap's records without timestamps: [(caplen, bytes)]."""
    with open(path, "rb") as f:
        data = f.read()
    frames, pos = [], 24
    while pos < len(data):
        _, _, caplen, _ = struct.unpack("<IIII", data[pos:pos + 16])
        frames.append((caplen, data[pos + 16: pos + 16 + caplen]))
        pos += 16 + caplen
    return frames


# the planted (LAP, channel) pairs of the 81 Msps capture (plant_capture,
# 3 blocks of 64 slots, seed 3) that the conv bank's step misses: the
# access code of 0x123456 on channel 0 (slot 10) comes out with 2
# errors (the survey allows 1), and 0x5A17EC on channel 64 (slot 177) is
# not detected at all.  The JAX package's LapSurvey misses the same two
# on this capture, with observations equal to the port's plain versions
# (tests/oddrate_fullband_check.py), so they are the reference's
# behaviour, which the port matches (ROADMAP.md §3)
MISSED_81 = {(0x123456, 0), (0x5A17EC, 64)}


def odd_rate_phase(n_blocks: int = N_BLOCKS):
    """Phase 8b: LapSurvey at 81 Msps (the conv bank, 79 channels) over a
    planted capture; detect_words and hit_table once per block and no
    other kernel; the observations equal to the same survey on the CPU
    (the plain versions), every one a planted packet, every planted pair
    found but the two the reference misses (MISSED_81).  The conv bank timed alone
    against its bound; then 5 Msps on the card against the CPU."""
    from gr_bluetooth_tpu_torch.ops import channelizer
    survey = LapSurvey(81e6, CENTER, block_slots=BLOCK_SLOTS)
    fe = survey.fe
    assert not fe.is_pfb and fe.bank.n_channels == 79
    x, planted = plant_capture(fe, n_blocks, seed=3)
    _zero_counts()
    t0 = time.perf_counter()
    obs = list(survey.run(x, emit_console=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    _want_chain(counts, n_blocks, (detect_kernel.detect_words,), False)
    cpu = LapSurvey(81e6, CENTER, block_slots=BLOCK_SLOTS, device="cpu")
    oc = list(cpu.run(x, emit_console=False))
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in obs] == [key(o) for o in oc]
    d_snr = max(abs(a.snr_db - b.snr_db) for a, b in zip(obs, oc))
    assert d_snr <= 1e-3, d_snr
    n_found = check_survey(obs, [p for p in planted
                                 if (p[0], p[1]) not in MISSED_81])
    seen = {(o.lap, o.channel) for o in obs}
    assert not MISSED_81 & seen, MISSED_81 & seen
    n_in = n_blocks * fe.step_samples
    print(f"odd rate 81 Msps: {n_blocks} blocks, {len(planted)} planted, "
          f"{n_found} of {n_found + len(MISSED_81)} (LAP, channel) pairs "
          f"found, the two the reference misses not ("
          f"{sorted((hex(a), b) for a, b in MISSED_81)}), no unplanted "
          f"LAP; {len(obs)} observations equal to the CPU's, SNR within "
          f"{d_snr:.2e} dB; launches {counts}; {dt:.4f} s host clock "
          f"({n_in / dt:.6g} samples/s, first-call set-up included), peak "
          f"device memory {peak / 2 ** 20:.1f} MiB")
    xb = fe.to_planes(x[: fe.block_samples])
    prof = step_profile("odd rate 81 Msps (conv bank)", fe.device_step, xb,
                        ("detect_words", "hit_table"))
    c, s = fe.consts, fe.statics
    torch.backends.cudnn.allow_tf32 = True        # the guard must hold
    conv = lambda: channelizer._channelize_impl(  # noqa: E731
        xb[None], c["kernel"], c["rot_q"], 0, decim=s["decim"], sps=s["sps"])
    yr, yi = conv()
    torch.backends.cudnn.allow_tf32 = False
    pr, pi = channelizer._channelize_impl(
        xb[None].cpu(), c["kernel"].cpu(), c["rot_q"].cpu(), 0,
        decim=s["decim"], sps=s["sps"])
    err = max((yr.cpu() - pr).abs().max().item(),
              (yi.cpu() - pi).abs().max().item())
    assert err <= 2e-5, err
    C2, _, T = c["kernel"].shape
    n_out = yr.shape[1]
    flops = C2 * 2 * T * n_out * 2
    nbytes = xb.numel() * 4 + c["kernel"].numel() * 4 + 2 * yr.numel() * 4
    b_ms, b_by = bound(nbytes, flops)
    ms = time_ms(conv, 10)
    print(f"odd rate 81 Msps conv bank: y {tuple(yr.shape)} within "
          f"{err:.3e} of the CPU's (cuDNN TF32 on for the process, off "
          f"inside the guard); {ms:.4f} ms per block (CUDA events), bound "
          f"{b_ms:.4f} ms by {b_by} ({flops:.4g} FP32 operations = "
          f"{C2} x 2 x {T} x {n_out} x 2, {nbytes:.4g} bytes)")

    kw = dict(block_slots=8)
    gpu = LapSurvey(5e6, CENTER, **kw)
    cpu = LapSurvey(5e6, CENTER, device="cpu", **kw)
    x5, planted5 = plant_capture(gpu.fe, 2, seed=5)
    og = gpu.run(x5, emit_console=False)
    oc = cpu.run(x5, emit_console=False)
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in og] == [key(o) for o in oc]
    d = max((abs(a.snr_db - b.snr_db) for a, b in zip(og, oc)), default=0.0)
    assert d <= 1e-3, d
    n = check_survey(og, planted5)
    print(f"odd rate 5 Msps: {len(og)} observations equal on the card and "
          f"the CPU, SNR within {d:.2e} dB, {n} pairs found")
    return dict(conv_ms=ms, conv_bound_ms=b_ms, profile=prof)


class OneChannelSim(testing.PiconetSim):
    """A master on channel 39 (the centre) in every slot."""

    def channel_at(self, slot):
        return 39


def offgrid_capture(fs: float, n_slots: int, seed: int = 5):
    """A piconet capture (LAP 0x24D952, UAP 0x47, a DM1 every other slot
    on channel 39) at an off-grid rate: synthesized at the next integer
    rate above and resampled to fs.  Returns (planes, sent, sim)."""
    from gr_bluetooth_tpu_torch.ops import resample
    fs_syn = 1e6 * math.ceil(fs / 1e6)
    sim = OneChannelSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, sent = testing.make_piconet_capture(
        sim, n_slots=n_slots, fs=fs_syn, center_freq=CENTER, seed=seed,
        tx_slots=range(0, n_slots - 6, 2), noise_std=0.01)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    return resample.make_resampler(fs_syn, fs)(planes), sent, sim


def offgrid_phase(fs: float = 7.68e6, n_slots: int = 96, device="cuda"):
    """Phase 8c: Sniffer at an off-grid rate (resampled to the next even
    integer Msps, the polyphase bank on the true band's channels): the
    planted UAP decoded, and the hits equal to the same run on the CPU.
    8-slot blocks: on this one-channel capture both packages' sniffers
    lose the clock after slot 22 with 16-slot blocks (ROADMAP.md §3)."""
    x, sent, sim = offgrid_capture(fs, n_slots)
    runs = {}
    for dev in (device, "cpu"):
        sn = Sniffer(fs, CENTER, block_slots=8, bus=EventBus(), device=dev,
                     enable_le=False)
        on_card = sn.device.type == "cuda"
        if on_card:
            _zero_counts()
        t0 = time.perf_counter()
        blocks = list(sn.fe.stream(x))
        counts = _counts() if on_card else None
        sn.run_blocks(iter(blocks))
        runs[dev] = (sn, blocks, time.perf_counter() - t0, counts)
    sn, blocks, dt, counts = runs[device]
    keys = [[(r.slot_base, h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
             for r in b for h in r.hits] for b in (blocks, runs["cpu"][1])]
    assert keys[0] == keys[1], "off-grid hits differ between card and CPU"
    pn = sn.basic_rate_piconets.get(sim.lap)
    assert pn is not None and pn.have_uap and pn.uap == sim.uap, pn
    assert sn.decoded and all((p.lap, p.uap) == (sim.lap, sim.uap)
                              for p in sn.decoded)
    if counts is not None:
        _want_fused(counts, len(blocks), sn.fe.enable_le)
    print(f"off-grid {fs / 1e6:g} Msps -> {sn.fe.bank.fs / 1e6:g} Msps, "
          f"channels {sn.fe.bank.channels}: UAP {pn.uap:#04x}, "
          f"{len(sn.decoded)} packets decoded of {len(sent)} planted, "
          f"{len(keys[0])} hits equal to the CPU's; launches {counts}; "
          f"{dt:.4f} s host clock")


def _relabelled(blocks, flip: int = 0x800000):
    """The blocks with every classic hit's LAP XOR `flip`: the same
    decode work (UAP discovery and decoding do not read the LAP) for
    piconets other than the real ones."""
    from dataclasses import replace
    return [replace(r, hits=[replace(h, lap=h.lap ^ flip) for h in r.hits])
            for r in blocks]


def _by_lap(rows):
    out = {}
    for lap, *rest in rows:
        out.setdefault(lap, []).append(tuple(rest))
    return out


def pool_phase(blocks_by_name, fe, n_workers: int = 4):
    """Phase 8d: the multiprocess host decode (ParallelHostDecoder) over
    fetched blocks against the single-process decode alone over the same
    blocks (this process, its caches warm): the same packets per LAP, in
    order; microseconds per hit of each.  Each capture runs on two fresh
    pools (workers keep their piconet registries across drives), each
    timed from when every worker has answered a first message (its
    imports done): a cold one, whose workers meet the capture first, and
    a warm one, driven first over the same blocks with every LAP
    relabelled (_relabelled)."""
    from gr_bluetooth_tpu_torch.models.parallel_host import \
        ParallelHostDecoder
    out = {}
    for name, blocks in blocks_by_name.items():
        n_hits = max(sum(len(r.hits) for r in blocks), 1)
        one = Sniffer(fe.input_rate, fe.bank.center_freq,
                      block_slots=fe.block_slots, bus=EventBus(),
                      enable_le=False, device=fe.device)
        t0 = time.perf_counter()
        one.run_blocks(iter(blocks))
        t_one = time.perf_counter() - t0
        want = _by_lap((p.lap, p.uap, p.clkn, p.channel, p.packet_type,
                        p.payload_length, None if p.payload is None
                        else np.packbits(p.payload).tobytes())
                       for p in one.decoded)
        times = {}
        for mode in ("cold", "warm"):
            with ParallelHostDecoder(n_workers=n_workers) as pool:
                for c in pool._conns:
                    c.send(("stats",))
                assert all(c.recv()[0] == "ok" for c in pool._conns)
                if mode == "warm":
                    pool.drive(fe, iter(_relabelled(blocks)))
                t0 = time.perf_counter()
                got = pool.drive(fe, iter(blocks))
                times[mode] = time.perf_counter() - t0
            assert _by_lap((d.lap, d.uap, d.clkn, d.channel, d.packet_type,
                            d.payload_length, d.payload)
                           for d in got) == want, \
                f"{name}: the {mode} pool differs from the single decoder"
        us = [t_one / n_hits * 1e6, times["cold"] / n_hits * 1e6,
              times["warm"] / n_hits * 1e6]
        print(f"host decode {name}: {len(got)} packets equal per LAP and in "
              f"order; {n_hits} hits in {len(blocks)} blocks, single process "
              f"{us[0]:.1f} us per hit, {n_workers} workers {us[1]:.1f} us "
              f"per hit cold, {us[2]:.1f} us per hit warm")
        out[name] = tuple(us)
    return out


# ------------------------------------------------------------------ phase 9

SURVEY_CLI = "gr_bluetooth_tpu_torch.kismet"
N_SHARDS, SHARD_BLOCKS = 4, 8        # 9b: 4 shards, two superblocks
GRID_BLOCKS = 4                      # 9c: a 2 x 2 grid, two superblocks


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _peak(devices) -> int:
    """Peak device memory, summed over the distinct cards."""
    return sum(torch.cuda.max_memory_allocated(d) for d in set(devices))


def stream_keys(results):
    """Classic and LE hit keys of BlockResults, block by block."""
    return ([(r.slot_base, h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
             for r in results for h in r.hits],
            [(r.slot_base, h.channel, h.index, h.clkn, h.sym_offset,
              h.distance) for r in results for h in r.le_hits])


def compare_streams(label, got, want):
    """Sharded BlockResults against FrontEnd.stream's: the same blocks,
    classic and LE hit keys exactly, slot SNR within 1e-3 dB.  Returns
    the largest SNR difference."""
    assert len(got) == len(want), (label, len(got), len(want))
    (gc, gl), (wc, wl) = stream_keys(got), stream_keys(want)
    assert gc == wc, f"{label}: classic hits differ: {set(gc) ^ set(wc)}"
    assert gl == wl, f"{label}: LE hits differ: {set(gl) ^ set(wl)}"
    d_snr = max(float(np.abs(a.snr_db - b.snr_db).max())
                for a, b in zip(got, want))
    assert d_snr <= 1e-3, f"{label}: slot SNR differs by {d_snr} dB"
    return d_snr


def kismet_phase(fs=FS, center=CENTER, block_slots=BLOCK_SLOTS,
                 n_blocks=N_BLOCKS, device="cuda", cli_slots=256):
    """Phase 9a: KismetSource over phase 4's planted capture: its frames
    equal, in order, the one-per-(channel, clkn) reduction of the front
    end's hits, and its tracked networks are the planted LAPs framed at
    least twice; a BtbbDevServer client receives the snapshot and then
    one tick's updates, none lost; then the btsurvey CLI (no --device on
    the card) prints the synthetic piconet's row."""
    from collections import Counter

    from gr_bluetooth_tpu_torch.kismet import (BtbbDevServer, FrameQueue,
                                               KismetSource,
                                               TrackerBluetooth)
    from gr_bluetooth_tpu_torch.kismet.server import parse_record
    src = KismetSource(fs, center, block_slots=block_slots,
                       queue=FrameQueue(maxsize=1 << 20),
                       tracker=TrackerBluetooth(clock=lambda: 0.0),
                       device=device)
    x, planted = plant_capture(src.fe, n_blocks)
    card = _on_card(device)
    if card:
        _zero_counts()
    t0 = time.perf_counter()
    n = src.run(x)
    dt = time.perf_counter() - t0
    counts = _counts() if card else None
    frames = [(f.lap, f.channel, f.clkn) for f in src.queue.drain()]
    blocks = list(src.fe.stream(x))
    check_survey([h for r in blocks for h in r.hits], planted)
    want = []
    for r in blocks:
        seen = set()
        for h in r.hits:
            if (h.channel, h.clkn) not in seen:
                seen.add((h.channel, h.clkn))
                want.append((h.lap, h.channel, h.clkn))
    assert frames == want and n == len(want), (n, len(frames), len(want))
    per_lap = Counter(lap for lap, _, _ in frames)
    twice = {lap for lap, c in per_lap.items() if c >= 2}
    assert set(per_lap) <= set(LAPS), set(per_lap) - set(LAPS)
    assert set(src.tracker.tracked_nets) == twice, \
        (sorted(src.tracker.tracked_nets), sorted(twice))
    if card:
        _want_fused(counts, n_blocks, src.fe.enable_le)

    # the server: snapshot on connect, then one tick's dirty records
    server = BtbbDevServer(src.tracker)
    try:
        with socket.create_connection(server.address, timeout=60) as c:
            c.settimeout(60)
            f = c.makefile()
            snap = [parse_record(f.readline())
                    for _ in range(len(src.tracker.tracked_nets))]
            assert sorted(r["bdaddr"] for r in snap) == sorted(
                net.bd_addr for net in src.tracker.tracked_nets.values())
            src.tracker.blit()                 # everything sent is clean
            src.run_blocks(iter(blocks[:1]))   # the first block again
            dirty = {net.bd_addr: net.num_packets
                     for net in src.tracker.tracked_nets.values()
                     if net.dirty}
            assert server.tick() == len(dirty) > 0
            upd = {r["bdaddr"]: r["packets"]
                   for r in (parse_record(f.readline())
                             for _ in range(len(dirty)))}
            assert upd == dirty, (upd, dirty)
    finally:
        server.close()
    print(f"kismet: {fs / 1e6:g} Msps, {n_blocks} blocks: {n} frames equal "
          f"in order to the one-per-(channel, clkn) reduction of the "
          f"{sum(len(r.hits) for r in blocks)} hits; {len(twice)} tracked "
          f"networks = the planted LAPs framed twice or more; BTBBDEV "
          f"client: {len(snap)} snapshot records, then {len(dirty)} "
          f"updates of one tick, none lost; launches {counts}; "
          f"{x.shape[0] / dt:.6g} samples/s host clock ({dt:.4f} s)")

    args = ["-r", f"{fs:.0f}", "-f", f"{center:.0f}", "--synthetic",
            str(cli_slots), "--table"]
    r, dt = run_cli(args, b"", None if card else device, module=SURVEY_CLI)
    assert b"00:00:00:24:d9:52" in r.stdout, r.stdout.decode()[-1000:]
    print(f"kismet: btsurvey {' '.join(args)}: exit 0 in {dt:.4f} s; "
          f"{r.stderr.decode().strip().splitlines()[-1]}; row "
          f"00:00:00:24:d9:52 printed")


def sharded_phase(fs=FS, center=CENTER, block_slots=BLOCK_SLOTS,
                  device="cuda", n_shards=N_SHARDS, n_blocks=SHARD_BLOCKS,
                  devices=None):
    """Phase 9b: ShardedFrontEnd over [device] * n_shards, or over
    `devices` (one shard each) when given (the survey's max_ac_errors=1,
    as phase 5, so that no noise hit is taken for an unplanted LAP), LE
    on, two superblocks of planted ID and LE advertising packets, some
    across a shard boundary and one across the superblock boundary: the
    same hits as FrontEnd.stream, slot SNR within 1e-3 dB, the fused
    chain's kernels once per shard and superblock; then
    measure_scaling_efficiency.  Returns (capture planes, results)."""
    from gr_bluetooth_tpu_torch.parallel import (ShardedFrontEnd,
                                                 measure_scaling_efficiency)
    if devices is not None:
        device, n_shards = devices[0], len(devices)
    fe = frontend.FrontEnd(fs, center, block_slots=block_slots,
                           max_ac_errors=1, enable_le=True, device=device)
    if devices is None:
        devices = [torch.device(fe.device)] * n_shards
    sfe = ShardedFrontEnd(fe, devices)
    B = block_slots
    # the last slot of shard 0's chunk and of the first superblock
    x, planted, le_planted = plant_le_capture(
        fe, n_blocks, seed=6, le_per_block=1,
        boundary_slots=(B - 1, 2 * B - 1, n_shards * B - 1))
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    card = _on_card(fe.device)
    if card:
        _zero_counts()
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    got = sfe.process(planes)
    if card:
        for d in set(devices):
            torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    counts = _counts() if card else None
    peak = _peak(devices) if card else None
    n_sb = n_blocks // n_shards
    if card:
        _want_fused(counts, n_shards * n_sb, fe.enable_le)
    t0 = time.perf_counter()
    want = list(fe.stream(planes))
    dt_stream = time.perf_counter() - t0
    d_snr = compare_streams("sharded", got, want)
    n_found = check_survey([h for r in got for h in r.hits], planted)
    n_le = check_le([h for r in got for h in r.le_hits], le_planted)
    n_in = planes.shape[1]
    on = ", ".join(sorted({str(d) for d in devices}))
    print(f"sharded: {n_shards} shards on {on}, {n_sb} superblocks "
          f"of {n_shards} x {B} slots ({n_in} samples): hits equal to "
          f"FrontEnd.stream's ({len(stream_keys(got)[0])} classic, "
          f"{len(stream_keys(got)[1])} LE), slot SNR within {d_snr:.3e} "
          f"dB; {n_found} (LAP, channel) pairs and {n_le} LE packets "
          f"found, boundary packets among them; launches {counts}; "
          f"{n_in / dt:.6g} samples/s host clock, first call ({dt:.4f} s),"
          f" FrontEnd.stream after it {n_in / dt_stream:.6g}; peak device "
          f"memory "
          f"{'not measured' if peak is None else f'{peak / 2 ** 20:.1f} MiB'}")

    if card:
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
    eff = measure_scaling_efficiency(fe, devices, n_superblocks=2,
                                     repeats=3)
    peak = _peak(devices) if card else None
    print(f"sharded scaling ({n_shards} shards on {on}): "
          f"efficiency {eff['efficiency']:.4f} "
          f"[q25 {eff['efficiency_q25']:.4f}, q75 {eff['efficiency_q75']:.4f}]"
          f", halo cost {eff['halo_cost_ms']:.4f} ms per run of 2 "
          f"superblocks (jitter {eff['timer_jitter_ms']:.4f} ms, noise "
          f"floor {eff['noise_floor']}), sharded {eff['sharded_sps']:.6g} / "
          f"ideal {eff['ideal_sps']:.6g} / one-device loop "
          f"{eff['scan_1dev_sps']:.6g} samples/s, speedup against the loop "
          f"{eff['speedup_vs_scan_1dev']:.4f}; peak device memory "
          f"{'not measured' if peak is None else f'{peak / 2 ** 20:.1f} MiB'}")
    print(f"sharded scaling, every figure: {json.dumps(eff)}")
    return planes, got


def fused_kernel_checks(label, s, c, xb):
    """pfb_snr, demod_pack and detect_words on one block, with the
    statics `s` and the constants `c` on their device (which need not be
    the current one), against their plain versions with phase 3's
    bounds."""
    xb = xb.to(c["h0"].device)
    Q, D = c["h0"].shape
    n, n_data, S, n_k, n_frames = frontend.step_geometry(
        xb.shape[1], Q, D, s["n_sym"], s["slot_ch"], c["probe_re"].shape[0])
    bank = (c["h0"], c["h1"], c["dft_c"], c["dft_s"], c["bin_odd"])
    yr, yi, oe = pfb_kernel.pfb_snr(xb, *bank, n_frames)
    pr, pi, poe = pfb_kernel.pfb_snr_plain(xb, *bank, n_frames)
    err_y = max((yr - pr).abs().max().item(), (yi - pi).abs().max().item())
    assert err_y <= 2e-5, (label, err_y)
    args = (yr, yi, s["demod_gain"], s["n_sym"], c["probe_re"],
            c["probe_im"], n_k, n_data)
    words, pe = demod_kernel.demod_pack(*args)
    pwords, ppe = demod_kernel.demod_pack_plain(*args)
    diff = detect_kernel.popcount((words ^ pwords).to(torch.int64)
                                  & 0xFFFFFFFF).sum().item()
    n_bits = words.shape[0] * s["n_sym"]
    assert diff <= n_bits * 1e-5, (label, diff, n_bits)
    dargs = (words[:-1], s["n_sym"] - 72 + 1, s["max_ac_errors"],
             c["ac_masks"])
    hit, gate, _ = detect_kernel.detect_words(*dargs)
    phit, pgate, _ = detect_kernel.detect_words_plain(*dargs)
    assert torch.equal(hit, phit) and torch.equal(gate, pgate), label
    print(f"{label}, {c['dft_c'].shape[1]} DFT columns on {xb.device}: "
          f"pfb_snr y within {err_y:.3e} (2e-5), demod_pack {diff} of "
          f"{n_bits} symbols mismatched, detect_words planes "
          f"{tuple(hit.shape)} exact")


def group_kernel_checks(s2, xb):
    """The three kernels at each channel group's width (Cg + 1 DFT
    columns) on one block."""
    for g, col in enumerate(s2.columns):
        last = s2.starts[g] + s2.group_size - 1
        fused_kernel_checks(f"group {g} (channels {s2.starts[g]}..{last})",
                            s2.fe.statics, col.consts[0], xb)


def grid_phase(fs=FS, center=CENTER, block_slots=BLOCK_SLOTS,
               device="cuda", n_blocks=GRID_BLOCKS, grid=None):
    """Phase 9c: Sharded2DFrontEnd on a 2 x 2 grid of `device` (or on
    `grid`, a 2 x 2 nested list of devices), LE on: the same hits as
    FrontEnd.stream, the fused chain's kernels once per shard and
    superblock, and the three kernels at the group width against their
    plain versions."""
    from gr_bluetooth_tpu_torch.parallel import Sharded2DFrontEnd
    fe = frontend.FrontEnd(fs, center, block_slots=block_slots,
                           max_ac_errors=1, enable_le=True,
                           device=grid[0][0] if grid else device)
    dev = torch.device(fe.device)
    grid = grid or [[dev, dev], [dev, dev]]
    s2 = Sharded2DFrontEnd(fe, grid)
    x, planted, le_planted = plant_le_capture(
        fe, n_blocks, seed=8, le_per_block=1,
        boundary_slots=(block_slots - 1, 2 * block_slots - 1))
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    card = _on_card(dev)
    if card:
        _zero_counts()
    t0 = time.perf_counter()
    got = s2.process(planes)
    dt = time.perf_counter() - t0
    counts = _counts() if card else None
    if card:
        _want_fused(counts, 2 * n_blocks, fe.enable_le)
    want = list(fe.stream(planes))
    d_snr = compare_streams("2-D", got, want)
    check_survey([h for r in got for h in r.hits], planted)
    check_le([h for r in got for h in r.le_hits], le_planted)
    on = ", ".join(sorted({str(d) for row in grid for d in row}))
    print(f"2-D: 2 x 2 grid on {on}, groups of {s2.group_size} channels "
          f"from {s2.starts} (valid from {s2.valid_start}), "
          f"{n_blocks} blocks: hits equal to FrontEnd.stream's "
          f"({len(stream_keys(got)[0])} classic, "
          f"{len(stream_keys(got)[1])} LE), slot SNR within {d_snr:.3e} "
          f"dB; launches {counts}; {planes.shape[1] / dt:.6g} samples/s "
          f"host clock, first call")
    xb = fe.to_planes(planes[:, :fe.block_samples])
    group_kernel_checks(s2, xb)


def two_process_phase(planes, results, fs=FS, center=CENTER,
                      block_slots=BLOCK_SLOTS, device="cuda:0",
                      n_shards=N_SHARDS, n_procs=2, backend="gloo"):
    """Phase 9d: n_procs processes under a `backend` process group,
    n_shards / n_procs shards each on `device` ("{rank}" in it is the
    process's rank), through device_put_local: process 0's hits equal
    phase 9b's."""
    from gr_bluetooth_tpu_torch.parallel.worker import hit_keys, launch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.npy")
        np.save(path, planes)
        t0 = time.perf_counter()
        got = launch(n_procs, path, rate=fs, freq=center,
                     block_slots=block_slots, shards=n_shards // n_procs,
                     device=str(device), backend=backend, enable_le=True,
                     max_ac_errors=1, timeout=300)
        dt = time.perf_counter() - t0
    classic, le = hit_keys(results)
    assert got["hits"] == classic, "multi-process classic hits differ"
    assert got["le_hits"] == le, "multi-process LE hits differ"
    assert got["backend"] == backend and got["blocks"] == len(results)
    how = ("through host memory" if backend == "gloo"
           else "device to device")
    print(f"{n_procs} processes: {backend}, {n_shards // n_procs} shards "
          f"each on {device}, halo {how}: {len(classic)} classic and "
          f"{len(le)} LE hits equal to the one-process run's; {dt:.4f} s "
          f"wall, process start included (stream {got['seconds']:.4f} s "
          f"in process 0)")


def multicard_phase(n_cards: int):
    """`--cards N`: phase 9 across N cards (N even, at least 2): the
    three fused kernels and the compiled fused step (a graph captured on
    that card, against its eager step) on every card with card 0
    current; 9b with one
    shard per card; 9c on the grid [[0, 1], [2, 3]] (the first four
    cards, or [[0, 1], [0, 1]] with two); 9d under NCCL, one process
    per card; then parallel.dryrun.dryrun_multichip(N) on the cards."""
    from gr_bluetooth_tpu_torch.parallel.dryrun import dryrun_multichip
    from gr_bluetooth_tpu_torch.parallel.sharded import host_consts
    have = torch.cuda.device_count()
    assert have >= n_cards >= 2 and n_cards % 2 == 0, (have, n_cards)
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    with timed("phase 9m-a, kernels on every card"):
        fe = frontend.FrontEnd(FS, CENTER, block_slots=BLOCK_SLOTS,
                               device=cards[0])
        x, _ = plant_capture(fe, 1, seed=9)
        xb = fe.to_planes(x[: fe.block_samples])
        host = host_consts(fe)
        with torch.cuda.device(cards[0]):
            for d in reversed(cards):
                fused_kernel_checks(f"card {d}, card 0 current", fe.statics,
                                    frontend.consts_to_device(host, d), xb)
                # a graph per card, captured and replayed on that card
                fd = frontend.FrontEnd(FS, CENTER, block_slots=BLOCK_SLOTS,
                                       device=d)
                xd = xb.to(d)
                want = [None if o is None else o.clone()
                        for o in fd.fused_step(xd)]
                step = fd.compiled_step("fused")
                check_replay(f"card {d}", step(xd), want)
                assert all(o is None or o.device == d for o in step.outputs)
                print(f"card {d}, card 0 current: the compiled fused step "
                      f"replays there, bit for bit the eager step")
    with timed("phase 9m-b, one shard per card"):
        planes, sharded = sharded_phase(devices=cards)
    with timed("phase 9m-c, a grid over the cards"):
        grid_phase(grid=[cards[0:2], cards[2:4] if n_cards >= 4
                         else cards[0:2]])
    with timed("phase 9m-d, NCCL, one process per card"):
        two_process_phase(planes, sharded, device="cuda:{rank}",
                          n_shards=n_cards, n_procs=n_cards,
                          backend="nccl")
    with timed("phase 9m-e, dry run"):
        dryrun_multichip(n_cards, cards)


# ------------------------------------------------------------------ phase 10

BENCH = "gr_bluetooth_tpu_torch.bench"
# the 16 and 8 MHz int8 operating points decode every planted in-band
# packet, 94 and 44 (the JAX package's counts on the same captures,
# BENCH_r05.json)
BENCH_POINTS = {"band16MHz_int8": 94, "band8MHz_int8": 44}


def check_bench(out: dict, stderr: str, rows: dict):
    """Phase 10's checks on the bench's JSON line `out` (and its
    stderr): LAP parity held (no parity failure reported, value > 0);
    the BENCH_POINTS operating points decoded all their planted in-band
    packets; the hostile loads decoded at least MIN_DECODED in every
    decode mode they ran (scalar and batched; for max_rate also the
    second batched run and the pool); and roofline.modeled_ms equals the
    sum of phase 3's bounds of the fused chain's kernels (`rows`)."""
    assert "parity FAIL" not in stderr and out["value"] > 0, \
        f"LAP parity failed: value {out['value']}"
    points = out["e2e_operating_points"]
    for name, want in BENCH_POINTS.items():
        p = points[name]
        assert p["planted_in_band"] == p["decoded"] == want, (name, p)
    for name, want in MIN_DECODED.items():
        dec = {k: v for k, v in out["sniffer_hostile"][name].items()
               if k.startswith("decoded_")}
        modes = ["decoded_scalar", "decoded_batched"]
        if name == "max_rate":
            modes += ["decoded_batched_run2"] + [
                k for k in dec if k.startswith("decoded_parallel")][:1]
        assert len(modes) == len(dec) and set(modes) == set(dec), \
            (name, sorted(dec))
        assert all(v >= want for v in dec.values()), (name, dec, want)
    modeled = sum(rows[k.__name__]["bound_ms"] for k in FUSED)
    assert out["roofline"]["modeled_ms"] == modeled, \
        (out["roofline"]["modeled_ms"], modeled)


def bench_phase(rows: dict):
    """Phase 10: `python -m gr_bluetooth_tpu_torch.bench` (no --device)
    as a subprocess; its whole output read here, its last line parsed
    and held to check_bench against phase 3's rows."""
    r, dt = run_cli([], b"", module=BENCH, timeout=900)
    out = json.loads(r.stdout.decode().strip().splitlines()[-1])
    check_bench(out, r.stderr.decode(), rows)
    roof, points = out["roofline"], out["e2e_operating_points"]
    print(f"bench: exit 0 in {dt:.1f} s wall; device loop {out['value']:.6g} "
          f"samples/s (parity held); ingest int16 / int8 / int4 "
          f"{out['ingest_samples_per_s_int16']:.6g} / "
          f"{out['ingest_samples_per_s_int8']:.6g} / "
          f"{out['ingest_samples_per_s_int4']:.6g} samples/s; roofline "
          f"modeled {roof['modeled_ms']:.4f} ms = phase 3's bounds, actual "
          f"{roof['actual_ms']:.4f} ms")
    for name, p in points.items():
        if name in BENCH_POINTS or name == "note":
            continue
        print(f"bench {name}: {p['decoded']} decoded of "
              f"{p['planted_in_band']} planted in band")
    for name, want in BENCH_POINTS.items():
        print(f"bench {name}: {want} of {want} decoded")
    for op in roof["top_ops"]:
        print(f"bench top op: {op['ms_per_block']:.4f} ms/block "
              f"{op['calls_per_block']:g} calls/block  {op['op']}")
    print(f"bench line: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def timed(label: str):
    """Print a phase's wall time when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"[{label}: {time.perf_counter() - t0:.1f} s wall]")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the port's smoke test on "
                                 "the card; see the module's notes")
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1: only the build and phase 9 across N "
                         "cards (one shard and one NCCL process per card)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the modes log every decoded packet at INFO; warnings (hit-table
    # overflow) still print
    logging.getLogger("grbt").setLevel(logging.WARNING)
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    with timed("phase 2, build"):
        t0 = time.perf_counter()
        libs = cuda_build.build_all()
        print(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
        for name, log in cuda_build.build_logs.items():
            print(f"--- nvcc {name}\n{log.strip()}")
    if opts.cards > 1:
        multicard_phase(opts.cards)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    with timed("phase 3, kernels and steps"):
        survey = LapSurvey(FS, CENTER, block_slots=BLOCK_SLOTS)
        fe = survey.fe
        fe_le = frontend.FrontEnd(FS, CENTER, block_slots=BLOCK_SLOTS,
                                  max_ac_errors=1, enable_le=True)
        x, _ = plant_capture(fe, 1, seed=9)
        xb = fe.to_planes(x[: fe.block_samples])
        rows, words, snr_db = kernel_checks(fe, xb)
        x_le, _, _ = plant_le_capture(fe_le, N_BLOCKS)
        words5, snr5 = block_step_inputs(
            fe_le, fe_le.to_planes(x_le[: fe_le.block_samples]))
        rows["le_detect"], le_hitw5 = le_kernel_check(fe_le, (
            ("phase 3's block", words),
            ("phase 5's first block, with LE packets", words5)))
        rows.update(tail_checks(fe, fe_le, words, snr_db, words5, snr5,
                                le_hitw5))
        hit_cluster_checks((
            ("full band", fe_le),
            ("full band, 128-slot blocks", frontend.FrontEnd(
                FS, CENTER, block_slots=128, max_ac_errors=1,
                enable_le=True)),
            ("8 Msps, 8-slot blocks", frontend.FrontEnd(
                8e6, 2426e6, block_slots=8, max_ac_errors=1,
                enable_le=True))))
        err_launches, _, _ = dense_detector(words, fe.statics["n_sym"],
                                            fe.consts["ac_masks"])
        names = lambda ks: [k.__name__ for k in ks]  # noqa: E731
        profs = (("fused", step_profile(
                     "fused chain (LE off)", fe.fused_step, xb,
                     names(FUSED + (HT,)))),
                 ("flat", step_profile(
                     "flat chain (LE on; hit_table: both tails, one "
                     "launch)", fe_le.device_step, xb,
                     names(FLAT + (LE, HT)))))
        ms = time_ms(lambda: fe_le.fused_step(xb), 20)
        print(f"fused chain (LE on) step: {ms:.4f} ms per block (CUDA "
              f"events, 20 steps)")
        # detect_words runs on both chains; its row keeps the fused chain's
        for chain, prof in profs:
            for name, t in prof.items():
                rows[name].setdefault("profiler_ms", t)
                print(f"{name}: {rows[name]['ms']:.4f} ms per launch (CUDA "
                      f"graph replay), {t:.4f} ms device time (profiler, "
                      f"in the {chain} step)")
    with timed("phase 3d, compiled steps"):
        compiled_phase(fe, fe_le, xb)
    with timed("phase 4, main path"):
        launches = main_path(survey, N_BLOCKS)
    with timed("phase 5, flat path"):
        flat_launches = flat_path(fe_le, N_BLOCKS)
    for name in names(FLAT[:2] + (LE,)) + [HT_LE]:
        launches[name] = flat_launches[name]
    with timed("phase 6, small reference"):
        small_reference()

    with timed("phase 7, modes"):
        caps, sims = mode_captures(FS, CENTER), piconet_sims()
        e2e_phase(*caps["e2e"], sims[0])
        le_phase()
        fetched = {name: sniffer_phase(name, *caps[name], sims)
                   for name in ("max_rate", "mixed")}

    with timed("phase 8a, btrx on stdin"):
        cli_phase(*caps["max_rate"], sims)
    with timed("phase 8b, odd rate"):
        odd_rate_phase()
    with timed("phase 8c, off-grid rate"):
        offgrid_phase()
    with timed("phase 8d, multiprocess host decode"):
        pool_phase({name: blocks for name, (_, blocks) in fetched.items()},
                   fetched["max_rate"][0])

    with timed("phase 9a, Kismet survey"):
        kismet_phase()
    with timed("phase 9b, time-sharded front end"):
        planes, sharded = sharded_phase()
    with timed("phase 9c, time x channel-group grid"):
        grid_phase()
    with timed("phase 9d, two processes"):
        two_process_phase(planes, sharded)
    print("two processes: the NCCL path (halo device to device) was not "
          "run: NCCL refuses two ranks on one GPU (`--cards N` runs it)")

    with timed("phase 10, the bench"):
        bench_phase(rows)

    launches[DETECT_ERR] = err_launches
    out = []
    for name in names(KERNELS) + [HT_LE, DETECT_ERR]:
        source = {DETECT_ERR: "detect_words", HT_LE: "hit_table"}.get(name,
                                                                      name)
        out.append(dict(name=name, route="cuda",
                        source=f"gr_bluetooth_tpu_torch/csrc/{source}.cu",
                        replaces=REPLACES[name], launches=launches[name],
                        **rows[name]))
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
