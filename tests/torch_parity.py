"""Shared inputs and helpers of the tests that hold the PyTorch port to
the JAX package (tests/test_torch_*.py): golden and planted captures made
from a seed with numpy, the pair of front ends on identical constants,
and the symbol-window comparison the two demodulators allow."""
import contextlib

import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.constants import SYMBOLS_PER_SLOT
from gr_bluetooth_tpu.core import access_code
from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import detect_pallas
from gr_bluetooth_tpu.ops import synth as jsynth
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu_torch import convert
from gr_bluetooth_tpu_torch.models import frontend

LAPS = (0x24D952, 0x9E8B33, 0x123456, 0xABCDEF, 0x5A17EC, 0x000F0F)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Imported by a test module, runs its torch CPU ops on one
    intra-op thread and restores the count after it.  The tier-1 command
    puts six pytest workers on the machine's cores, and the torch thread
    pools of several workers at once starve one another: the port's
    tests then run tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas detector in interpret mode."""
    old = detect_pallas.DEFAULT_INTERPRET
    detect_pallas.DEFAULT_INTERPRET = True
    try:
        yield
    finally:
        detect_pallas.DEFAULT_INTERPRET = old


def planes(x):
    return np.stack([x.real, x.imag]).astype(np.float32)


def piconet(fs, n_blocks, seed=3):
    """A golden piconet capture of 8-slot blocks, as (2, N) planes."""
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    n_slots = 8 * n_blocks + 8
    samples, _ = make_piconet_capture(sim, n_slots=n_slots, fs=fs,
                                      center_freq=2441e6, seed=seed,
                                      tx_slots=range(0, n_slots - 6),
                                      noise_std=0.02)
    return planes(samples)


def planted(fs, n_slots, seed):
    """ID packets (access code + random tail) with several LAPs on every
    channel of the band centred on 2441 MHz, some in the same slot, at
    random jitter."""
    sps = int(fs // 1e6)
    r = np.random.default_rng(seed)
    n_ch = int(fs // 1e6) - 1
    plan = []
    for i in range(3 * n_ch):
        ch = 2441 - 2402 - n_ch // 2 + (i % n_ch)
        slot = 1 + (i * 5) % (n_slots - 7)
        bits = np.concatenate([access_code.ac_bits(LAPS[i % len(LAPS)])[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        plan.append(jsynth.PlannedPacket(
            channel=ch, bits=bits,
            start_sample=(slot * SYMBOLS_PER_SLOT
                          + int(r.integers(0, 300))) * sps))
    x = jsynth.synthesize_capture(plan, n_samples=n_slots * SYMBOLS_PER_SLOT
                                  * sps, fs=fs, center_freq=2441e6,
                                  noise_std=0.02, seed=seed)
    return planes(x)


LE_CENTER = 2426e6       # 8 Msps here holds advertising channel 38


def le_capture(n_slots=30, seed=11):
    """8 Msps centred on 2426 MHz: LE advertising packets on BR channel
    24 (LE index 38), LE data packets on 22 and 26 (indices 10 and 11),
    classic ID packets on 23 and 25, from the JAX package's encoders.
    Returns (planes, [(kind, BR channel, slot)])."""
    sps = 8
    r = np.random.default_rng(seed)
    plan, want = [], []
    for i in range(n_slots // 3 - 1):
        slot = 1 + 3 * i
        jit = int(r.integers(0, 300))
        adv = jpackets.encode_le_adv(0x8E89BED6, 38, i % 7,
                                     bytes(r.integers(0, 256, 9).tolist()),
                                     crc=False)
        data_ch, data_idx = (22, 10) if i % 2 else (26, 11)
        dat = jpackets.encode_le_data(0x50654A3B + i, data_idx, 1 + i % 3,
                                      bytes(r.integers(0, 256, 6).tolist()),
                                      crc_init=0x555555)
        cl = np.concatenate([access_code.ac_bits(LAPS[i % 4])[:72],
                             r.integers(0, 2, 60).astype(np.uint8)])
        for kind, ch, bits in (("adv", 24, adv), ("data", data_ch, dat),
                               ("classic", 23 + 2 * (i % 2), cl)):
            plan.append(jsynth.PlannedPacket(
                channel=ch, bits=np.concatenate([bits, np.zeros(8, np.uint8)]),
                start_sample=(slot * SYMBOLS_PER_SLOT + jit) * sps))
            want.append((kind, ch, slot))
    x = jsynth.synthesize_capture(plan, n_samples=n_slots * SYMBOLS_PER_SLOT
                                  * sps, fs=8e6, center_freq=LE_CENTER,
                                  noise_std=0.02, seed=seed)
    return planes(x), want


def pair(fs, center=2441e6, **kw):
    """(JAX front end on its packed Pallas path, the port's front end on
    the CPU holding the JAX front end's constants)."""
    fj = jfrontend.FrontEnd(fs, center, block_slots=8, use_pallas=True, **kw)
    ft = frontend.FrontEnd(fs, center, block_slots=8, device="cpu", **kw)
    kwargs = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fj._step_kwargs.items()}
    ft.consts, statics = convert.consts_from_jax(kwargs)
    assert statics == ft.statics
    return fj, ft


def blocks(fe, x):
    """The (2, block_samples) blocks that stream_sync cuts from x."""
    n_blocks = (x.shape[1] - fe.overlap_samples) // fe.step_samples
    return [x[:, i * fe.step_samples: i * fe.step_samples + fe.block_samples]
            for i in range(n_blocks)]


def window_mismatches(a, b):
    """(differing symbols, symbols) of two packed int32 window tables."""
    a = np.ascontiguousarray(a).view(np.uint8)
    b = np.ascontiguousarray(b).view(np.uint8)
    return int(np.unpackbits(a ^ b).sum()), a.size * 8


def assert_windows_agree(a, b):
    """Windows of the two demodulators (torch.atan2 / jnp.arctan2 against
    atan2_poly, sums in another order): identical, or at most one
    differing symbol per 10^5 (the symbols whose soft value lies within
    the discriminators' difference of zero)."""
    d, n = window_mismatches(a, b)
    assert d <= n * 1e-5, (d, n)
    return d


REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))
CLIS = {"jax": ("gr_bluetooth_tpu.apps.btrx", []),
        "port": ("gr_bluetooth_tpu_torch.apps.btrx", ["--device", "cpu"])}
SURVEY_CLIS = {"jax": ("gr_bluetooth_tpu.kismet", []),
               "port": ("gr_bluetooth_tpu_torch.kismet", ["--device", "cpu"])}


def run_clis(make_args, stdin=None, timeout=300, names=("jax", "port"),
             clis=CLIS):
    """Both packages' btrx (or, with clis=SURVEY_CLIS, btsurvey) as
    subprocesses side by side on the same input (the port's with
    --device cpu), each on one CPU thread (OMP_NUM_THREADS=1):
    make_args(name) gives each its arguments.  Returns {name:
    CompletedProcess}."""
    import os
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")

    def one(name):
        mod, extra = clis[name]
        return subprocess.run(
            [sys.executable, "-m", mod] + list(make_args(name)) + extra,
            input=stdin, capture_output=True, timeout=timeout, env=env,
            cwd=REPO)

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def log_lines(stderr: bytes) -> list:
    """The logger's lines ("<name> <level> <message>") of a btrx run,
    without their timestamps."""
    import re
    pat = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} (grbt\.\S+ .*)$")
    return [m.group(1) for m in map(pat.match,
                                    stderr.decode().splitlines()) if m]


def same_cli_output(runs, rc=0):
    """Both runs exit with rc and print the same stdout and the same log
    lines; returns the port's CompletedProcess."""
    j, t = runs["jax"], runs["port"]
    assert j.returncode == rc, j.stderr.decode()[-800:]
    assert t.returncode == rc, t.stderr.decode()[-800:]
    assert t.stdout.decode().splitlines() == j.stdout.decode().splitlines()
    assert log_lines(t.stderr) == log_lines(j.stderr)
    return t
