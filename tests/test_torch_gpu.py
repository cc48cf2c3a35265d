"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the `gpu` marker and skips without a CUDA device
(decided in the fixture, so every worker collects the same tests).  This
file imports neither JAX nor the JAX package, and tests/conftest.py
imports JAX, so on a machine without JAX run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the card's: the kernels contract multiply-adds into FMAs
and sum in another order than the plain versions, so channel streams
agree within 2e-5, slot SNR within 1e-3 dB, packed symbols up to one
mismatch per 10^5 (at least one allowed), detector planes and the
deinterleaved planes, the LE detector's hit plane and distances and the
hit table's count, rows and windows exactly.  The two chains of the step (device_step
and stream_sync: deinterleave, pfb_channelize, torch demod; stream():
pfb_snr, demod_pack) are held to each other with the same tolerances.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu_torch.io import ingest
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.core import packets
from gr_bluetooth_tpu_torch.ops import (demod_kernel, detect, detect_kernel,
                                        hit_table, pfb, pfb_kernel, snr)
from gr_bluetooth_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fe8(cuda):
    return FrontEnd(8e6, 2441e6, block_slots=8, max_ac_errors=6)


def _bank(fs, center, device):
    b = pfb.make_pfb_bank(fs, center)
    return [torch.from_numpy(a.copy()).to(device)
            for a in (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd)]


def _popcount_diff(a, b):
    return int(detect_kernel.popcount((a ^ b).to(torch.int64) & 0xFFFFFFFF)
               .sum().item())


def test_kernels_build(cuda):
    libs = cuda_build.build_all()
    assert set(libs) == set(cuda_build.SOURCES)
    assert all(p.exists() for p in libs.values())


# the banks the channelizer kernels branch on: 8 and 20 Msps (few bins,
# branches padded to the mma depth), full band, and 128 Msps (W too large
# for one block's shared memory: the bins split over two or more groups)
BANKS = [(8e6, 2441e6), (20e6, 2450e6), (80e6, 2441e6), (128e6, 2441e6)]


@pytest.mark.parametrize("fs,center", BANKS)
def test_pfb_snr_kernel_matches_plain(cuda, fs, center):
    """Frames past the data read zeros; 400 tiles, more than the
    persistent grid has blocks at 80 and 128 Msps."""
    bank = _bank(fs, center, cuda)
    D = bank[0].shape[1]
    r = np.random.default_rng(int(fs) // 1000)
    x = torch.from_numpy(r.normal(0, 0.5, (2, 19_000 * D + 17)).astype(
        np.float32)).to(cuda)
    n_frames = 20_000
    before = pfb_kernel.pfb_snr.launches
    yr, yi, oe = pfb_kernel.pfb_snr(x, *bank, n_frames)
    assert pfb_kernel.pfb_snr.launches == before + 1
    pr, pi, poe = pfb_kernel.pfb_snr_plain(x, *bank, n_frames)
    assert oe.shape == poe.shape == (bank[2].shape[1], n_frames // 50)
    torch.testing.assert_close(yr, pr, atol=2e-5, rtol=0)
    torch.testing.assert_close(yi, pi, atol=2e-5, rtol=0)
    torch.testing.assert_close(oe, poe, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("allow", [False, True])
@pytest.mark.parametrize("plain", ["pfb_channelize_plain", "pfb_snr_plain",
                                   "demod_pack_plain"])
def test_plain_versions_keep_the_callers_tf32_flags(cuda, plain, allow):
    """Each plain version leaves both TF32 flags as the caller set them,
    and its matmuls run in FP32 either way (equal results)."""
    bank = _bank(8e6, 2441e6, cuda)
    D = bank[0].shape[1]
    r = np.random.default_rng(7)
    if plain == "demod_pack_plain":
        sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(8e6, 2441e6))
        y = torch.from_numpy(r.normal(0, 1, (2, 9, 5000)).astype(
            np.float32)).to(cuda)
        args = (y[0], y[1], 1.27, 2000,
                *[torch.from_numpy(a.copy()).to(cuda)
                  for a in (sc.taps_re, sc.taps_im)], 100)
        fn = demod_kernel.demod_pack_plain
    else:
        x = torch.from_numpy(r.normal(0, 0.5, (2, 3000 * D)).astype(
            np.float32)).to(cuda)
        if plain == "pfb_snr_plain":
            args, fn = (x, *bank, 2950), pfb_kernel.pfb_snr_plain
        else:
            args = (pfb.deinterleave_plain(x, D), *bank)
            fn = pfb_kernel.pfb_channelize_plain
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = False
        ref = fn(*args)
        for f in flags:
            f.allow_tf32 = allow
        got = fn(*args)
        assert [f.allow_tf32 for f in flags] == [allow, allow]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_demod_pack_kernel_matches_plain(cuda):
    """Including groups past the data (all-ones words) and a tail word."""
    sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(8e6, 2441e6))
    taps = [torch.from_numpy(a.copy()).to(cuda)
            for a in (sc.taps_re, sc.taps_im)]
    r = np.random.default_rng(1)
    C, F = 9, 7000
    ph = np.cumsum(r.normal(0, 0.8, (C, F)), axis=1)
    y = np.exp(1j * ph) + 0.05 * (r.normal(size=(C, F)) +
                                  1j * r.normal(size=(C, F)))
    yr = torch.from_numpy(y.real.astype(np.float32)).to(cuda)
    yi = torch.from_numpy(y.imag.astype(np.float32)).to(cuda)
    n_sym, n_k = 4000, 120
    for n_data in (None, 5):
        args = (yr, yi, 1.2732395447351628, n_sym, *taps, n_k, n_data)
        words, pe = demod_kernel.demod_pack(*args)
        pw, ppe = demod_kernel.demod_pack_plain(*args)
        assert words.shape == pw.shape == (C, -(-n_sym // 32))
        assert _popcount_diff(words, pw) <= max(1, C * n_sym * 1e-5)
        torch.testing.assert_close(pe, ppe, atol=1e-6, rtol=1e-4)
        if n_data is not None:
            assert bool((words[:, 5 * 16: -1] == -1).all())


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("n_data", [None, 40])
def test_demod_pack_kernel_at_full_band_shape(cuda, n_data, shift):
    """80 rows of F = 87,050 frames (odd rows 8-byte aligned; with shift 1
    every row one float further, so rows sit at all four alignments), 85
    groups, a tail word; n_data_groups by default and short (groups 40 to
    84 all ones, their probe energies zero)."""
    sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(80e6, 2441e6))
    taps = [torch.from_numpy(a.copy()).to(cuda)
            for a in (sc.taps_re, sc.taps_im)]
    r = np.random.default_rng(5 + shift)
    C, F = 80, 87_050
    ph = np.cumsum(r.normal(0, 0.8, (C, F)), axis=1)
    y = np.exp(1j * ph) + 0.05 * (r.normal(size=(C, F)) +
                                  1j * r.normal(size=(C, F)))
    planes = []
    for part in (y.real, y.imag):
        buf = torch.zeros(C * F + shift, device=cuda)
        buf[shift:] = torch.from_numpy(part.astype(np.float32)).reshape(-1)
        planes.append(buf[shift:].view(C, F))
    assert planes[0].data_ptr() % 16 == 4 * shift
    n_sym, n_k = 43_125, 2151
    args = (*planes, 1.2732395447351628, n_sym, *taps, n_k, n_data)
    before = demod_kernel.demod_pack.launches
    words, pe = demod_kernel.demod_pack(*args)
    assert demod_kernel.demod_pack.launches == before + 1
    pw, ppe = demod_kernel.demod_pack_plain(*args)
    assert words.shape == pw.shape == (C, -(-n_sym // 32))
    assert _popcount_diff(words, pw) <= max(1, C * n_sym * 1e-5)
    torch.testing.assert_close(pe, ppe, atol=1e-6, rtol=1e-4)
    assert bool((words[:, -1] >> (n_sym % 32) == 0).all())
    if n_data is not None:
        assert bool((words[:, n_data * 16: -1] == -1).all())
        assert bool((pe[:, -(-n_data * 1024 // 40):] == 0).all())


def test_demod_pack_kernel_keeps_the_earliest_tie(cuda):
    """Rows whose 16 timing metrics tie exactly (testing.make_tied_streams):
    all zeros (every hypothesis 0) and +-pi/2 steps (hypotheses 0 and 8
    tie at the maximum).  The kernel, like torch.argmax and the TPU
    kernel, takes hypothesis 0: every word equal to the plain version's,
    the zero row all ones, the step row the even frames' steps."""
    from gr_bluetooth_tpu_torch.testing import make_tied_streams
    sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(80e6, 2441e6))
    taps = [torch.from_numpy(a.copy()).to(cuda)
            for a in (sc.taps_re, sc.taps_im)]
    F, n_sym = 20 * 1024 + 200, 20 * 512
    yr, yi, steps = make_tied_streams(F, seed=3)
    args = (torch.from_numpy(yr).to(cuda), torch.from_numpy(yi).to(cuda),
            1.2732395447351628, n_sym, *taps, 400)
    words, _ = demod_kernel.demod_pack(*args)
    pw, _ = demod_kernel.demod_pack_plain(*args)
    assert torch.equal(words, pw)
    assert bool((words[0] == -1).all())
    even = detect_kernel.pack_bits_words(
        torch.from_numpy(steps[0:2 * n_sym:2] > 0)[None]).to(cuda)
    assert torch.equal(words[1:2], even)


@pytest.mark.parametrize("max_ac_errors", [0, 1, 2, 6, 68])
def test_detect_words_bitsliced_planes_are_exact(cuda, max_ac_errors):
    """Hit, gate and the 7 error-count planes equal to the plain version
    with n % 32 != 0 and W short of n_words + 3 (windows read zeros past
    the words), access codes planted with 0 to 7 errors."""
    from gr_bluetooth_tpu_torch.core.access_code import ac_bits
    r = np.random.default_rng(max_ac_errors)
    C, T = 9, 12_000
    bits = r.integers(0, 2, (C, T)).astype(np.int64)
    for i in range(40):
        ac = ac_bits(int(r.integers(0, 1 << 24)))[:68].copy()
        ac[r.choice(68, size=i % 8, replace=False)] ^= 1
        off = int(r.integers(0, T - 68))
        bits[i % C, off:off + 68] = ac
    words = detect_kernel.pack_bits_words(torch.from_numpy(bits)).to(cuda)
    masks = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    W = words.shape[1] - 2
    n = W * 32 - 37
    assert n % 32 and W < -(-n // 32) + 3
    w = words[:, :W].contiguous()
    h, g, e = detect_kernel.detect_words(w, n, max_ac_errors, masks,
                                         emit_err=True)
    ph, pg, pe = detect_kernel.detect_words_plain(w, n, max_ac_errors, masks,
                                                  emit_err=True)
    assert torch.equal(h, ph) and torch.equal(g, pg) and torch.equal(e, pe)
    h2, g2, none = detect_kernel.detect_words(w, n, max_ac_errors, masks)
    assert none is None and torch.equal(h2, ph) and torch.equal(g2, pg)
    assert int(detect_kernel.popcount(ph.to(torch.int64) & 0xFFFFFFFF)
               .sum()) >= (1 if max_ac_errors == 0 else 5)


def test_detect_words_raises_on_masks_other_than_the_compiled_map(cuda):
    """The kernel has ac_masks() compiled in: other masks raise (checked
    once per tensor and version); the plain version still takes them."""
    words = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    masks = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    detect_kernel.detect_words(words, 100, 1, masks)
    masks[3] ^= 1
    with pytest.raises(ValueError, match="compiled"):
        detect_kernel.detect_words(words, 100, 1, masks)
    other = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    other[74] ^= 4
    with pytest.raises(ValueError, match="compiled"):
        detect_kernel.detect_words(words, 100, 1, other)
    detect_kernel.detect_words_plain(words, 100, 1, other)


def test_demod_pack_raises_on_a_longer_probe(cuda):
    """The launcher refuses a probe longer than the kernel's TMAX (224)
    taps; every bank's probe has 201."""
    y = torch.zeros((2, 3000), device=cuda)
    taps = torch.zeros(225, device=cuda)
    with pytest.raises(RuntimeError, match="demod_pack"):
        demod_kernel.demod_pack(y, y, 1.0, 1000, taps, taps, 10)


def test_demod_pack_kernel_is_exact_at_extreme_magnitudes(cuda):
    """The discriminator's divisions over operands far from unit scale:
    rows whose products |y[l+1] y[l]| straddle 2^-60 and 2^60, sit just
    inside them, mix exponents from 2^-80 to 2^80 frame by frame (warps
    with lanes on both sides), or hold zeros and subnormals.  Every word
    equal to the plain version's."""
    r = np.random.default_rng(11)
    C, F = 8, 6 * 1024 + 300
    ph = r.uniform(-np.pi, np.pi, (C, F))
    mag = r.uniform(0.5, 2.0, (C, F))
    exps = np.zeros((C, F))
    exps[0], exps[1], exps[2], exps[3] = -30, 30, -29, 29
    exps[4] = r.integers(-40, 41, F)
    exps[5] = np.where((np.arange(F) // 100) % 2, 35, -35)
    y = mag * np.exp(1j * ph) * np.exp2(exps)
    tiny = np.array([0.0, 1e-40, -1e-40, 1e-45, -3e-44, 1.0, -1.0])
    # a third of the frames replaced (metrics stay far from exact ties)
    y[6] = np.where(r.random(F) < 0.3,
                    r.choice(tiny, F) + 1j * r.choice(tiny, F), y[6])
    y[7] = np.where(r.random(F) < 0.3, 0.0, y[4])
    yr = torch.from_numpy(y.real.astype(np.float32)).to(cuda)
    yi = torch.from_numpy(y.imag.astype(np.float32)).to(cuda)
    assert bool((yr[6] != 0).any()) and bool((yr[6].abs() < 1e-38).any())
    sc = snr.make_stream_snr_consts(pfb.make_pfb_bank(8e6, 2441e6))
    taps = [torch.from_numpy(a.copy()).to(cuda)
            for a in (sc.taps_re, sc.taps_im)]
    args = (yr, yi, 1.2732395447351628, 3000, *taps, 100)
    words, _ = demod_kernel.demod_pack(*args)
    pw, _ = demod_kernel.demod_pack_plain(*args)
    assert torch.equal(words, pw)


@pytest.mark.parametrize("max_ac_errors", [1, 6])
def test_detect_words_kernel_is_exact(cuda, max_ac_errors):
    from gr_bluetooth_tpu_torch.core.access_code import ac_bits
    r = np.random.default_rng(2)
    C, T = 7, 20000
    bits = r.integers(0, 2, (C, T)).astype(np.int64)
    for i, off in enumerate((0, 31, 32, 4095, 4096, 9000, T - 72)):
        ac = ac_bits(0x24D952 + i)[:68].copy()
        ac[5 + i] ^= i % 2
        bits[i % C, off:off + 68] = ac
    words = detect_kernel.pack_bits_words(torch.from_numpy(bits)).to(cuda)
    masks = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    for W in (words.shape[1], words.shape[1] - 5):      # zero past W
        n = W * 32 - 71
        hit, gate, err = detect_kernel.detect_words(
            words[:, :W].contiguous(), n, max_ac_errors, masks)
        ph, pg, perr = detect_kernel.detect_words_plain(words[:, :W], n,
                                                        max_ac_errors, masks)
        assert torch.equal(hit, ph) and torch.equal(gate, pg)
        assert err is None and perr is None
        assert int(detect_kernel.popcount(hit.to(torch.int64) & 0xFFFFFFFF)
                   .sum()) >= 5


def _launches():
    return {k.__name__: k.launches for k in chip_smoke.KERNELS}


def test_device_step_on_card_matches_cpu(fe8):
    """The whole fused step (stream()'s chain) through its three kernels
    against the plain versions on the CPU: same hit table, windows
    within the symbol tolerance, SNR within 1e-3 dB; each of its kernels
    launched once, the flat chain's not at all."""
    fc = FrontEnd(8e6, 2441e6, block_slots=8, max_ac_errors=6, device="cpu")
    x, planted = chip_smoke.plant_capture(fc, 1, seed=4)
    counts = _launches()
    og = fe8.fused_step(x)
    assert _launches() == {k: c + (k in ("pfb_snr", "demod_pack",
                                         "detect_words", "hit_table"))
                           for k, c in counts.items()}
    oc = fc.fused_step(x)
    assert og[0].is_cuda and og[2].is_cuda
    torch.testing.assert_close(og[0].cpu(), oc[0], atol=1e-3, rtol=0)
    assert int(og[1]) == int(oc[1]) >= 10
    assert torch.equal(og[2].cpu(), oc[2])
    w = og[3].cpu()
    assert _popcount_diff(w, oc[3]) <= max(1, w.numel() * 32 * 1e-5)


def test_flat_step_on_card_matches_cpu(fe8):
    """The flat step (device_step) through deinterleave, pfb_channelize
    and detect_words against the plain versions on the CPU; each of
    those launched once, pfb_snr and demod_pack not at all."""
    fc = FrontEnd(8e6, 2441e6, block_slots=8, max_ac_errors=6, device="cpu")
    x, planted = chip_smoke.plant_capture(fc, 1, seed=4)
    counts = _launches()
    og = fe8.device_step(x)
    assert _launches() == {k: c + (k in ("deinterleave", "pfb_channelize",
                                         "detect_words", "hit_table"))
                           for k, c in counts.items()}
    oc = fc.device_step(x)
    torch.testing.assert_close(og[0].cpu(), oc[0], atol=1e-3, rtol=0)
    assert int(og[1]) == int(oc[1]) >= 10
    assert torch.equal(og[2].cpu(), oc[2])
    w = og[3].cpu()
    assert _popcount_diff(w, oc[3]) <= max(1, w.numel() * 32 * 1e-5)


def test_stream_on_card_matches_stream_sync(fe8):
    """The pipelined ingest (int16 wire, device carry, packed outputs,
    the fused chain) against the synchronous loop (the flat chain) on
    the same quantized samples, over a capture whose last block is
    zero-padded: the same hits, SNR within 1e-3 dB, windows within the
    symbol tolerance."""
    x, planted = chip_smoke.plant_capture(fe8, 3, seed=6)
    x = 0.25 * x[:-1000]                  # inside int16 full scale
    a = list(fe8.stream(x, start_clkn=7, wire="i16"))
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    b = list(fe8.stream_sync(
        ingest.wire_decode_np(ingest.wire_encode(planes, "i16"), "i16"),
        start_clkn=7))
    key = [[(h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
            for h in r.hits] for r in a]
    assert len(a) == len(b) == 3
    assert key == [[(h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
                    for h in r.hits] for r in b]
    assert sum(map(len, key)) >= 15
    chip_smoke.compare_chains(fe8, b, a, x.shape[0])


def test_stream_with_le_matches_stream_sync_on_card(cuda):
    """LE on, 8 Msps centred on 2426 MHz (advertising channel 38): both
    chains on the card report every planted classic and LE packet, with
    the same hit keys, SNR within 1e-3 dB and windows within the symbol
    tolerance."""
    fe = FrontEnd(8e6, 2426e6, block_slots=8, max_ac_errors=1,
                  enable_le=True)
    x, planted, le_planted = chip_smoke.plant_le_capture(fe, 3,
                                                         le_per_block=2)
    flat, fused = list(fe.stream_sync(x)), list(fe.stream(x))
    for res in (flat, fused):
        chip_smoke.check_survey([h for r in res for h in r.hits], planted)
        chip_smoke.check_le([h for r in res for h in r.le_hits], le_planted)
    chip_smoke.compare_chains(fe, flat, fused, x.shape[0])


@pytest.mark.parametrize("fs,center", BANKS)
@pytest.mark.parametrize("n", [1, 37, 50, 1000, 1234, 100_000])
def test_pfb_channelize_kernel_matches_plain(cuda, n, fs, center):
    """Below one tile, whole tiles, a ragged last tile, and more tiles
    than the persistent grid has blocks."""
    bank = _bank(fs, center, cuda)
    Q, D = bank[0].shape
    r = np.random.default_rng(n)
    xp = torch.from_numpy(r.normal(0, 0.5, (2, D, n + 2 * Q)).astype(
        np.float32)).to(cuda)
    before = pfb_kernel.pfb_channelize.launches
    yr, yi = pfb_kernel.pfb_channelize(xp, *bank)
    assert pfb_kernel.pfb_channelize.launches == before + 1
    pr, pi = pfb_kernel.pfb_channelize_plain(xp, *bank)
    assert yr.shape == pr.shape == (bank[2].shape[1], n)
    torch.testing.assert_close(yr, pr, atol=2e-5, rtol=0)
    torch.testing.assert_close(yi, pi, atol=2e-5, rtol=0)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_pfb_channelize_kernel_reads_rows_at_any_alignment(cuda, offset):
    """Branch rows that start `offset` floats past a 16-byte boundary (a
    contiguous view into a larger buffer): the kernel's 16-byte window
    copies realign per row."""
    bank = _bank(80e6, 2441e6, cuda)
    Q, D = bank[0].shape
    n_x = 1000 + 2 * Q
    r = np.random.default_rng(offset)
    buf = torch.from_numpy(r.normal(0, 0.5, 2 * D * n_x + offset).astype(
        np.float32)).to(cuda)
    xp = buf[offset:].view(2, D, n_x)
    assert xp.data_ptr() % 16 == 4 * offset
    yr, yi = pfb_kernel.pfb_channelize(xp, *bank)
    pr, pi = pfb_kernel.pfb_channelize_plain(xp, *bank)
    torch.testing.assert_close(yr, pr, atol=2e-5, rtol=0)
    torch.testing.assert_close(yi, pi, atol=2e-5, rtol=0)


@pytest.mark.parametrize("D,N", [(40, 40 * 3000 + 17), (10, 10 * 33),
                                 (3, 31), (64, 64 * 100), (33, 33 * 65 + 32)])
def test_deinterleave_kernel_is_exact(cuda, D, N):
    r = np.random.default_rng(N)
    x = torch.from_numpy(r.normal(size=(2, N)).astype(np.float32)).to(cuda)
    before = pfb.deinterleave.launches
    xp = pfb.deinterleave(x, D)
    assert pfb.deinterleave.launches == before + 1
    assert xp.shape == (2, D, N // D)
    assert torch.equal(xp, pfb.deinterleave_plain(x, D))
    # a view whose rows are not contiguous is copied first
    wide = torch.zeros((2, N + 5), device=cuda)
    wide[:, :N] = x
    assert torch.equal(pfb.deinterleave(wide[:, :N], D), xp)


def test_wrappers_raise_on_bad_cuda_input(cuda):
    masks = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    with pytest.raises(TypeError):
        detect_kernel.detect_words(torch.zeros((2, 8), device=cuda), 32, 1,
                                   masks)
    h = torch.zeros((7, 4), device=cuda)
    with pytest.raises(ValueError):
        pfb_kernel.pfb_snr(torch.zeros((2, 400), device=cuda), h, h,
                           torch.zeros((8, 3), device=cuda),
                           torch.zeros((8, 3), device=cuda),
                           torch.zeros(3, device=cuda), 49)


def test_flat_wrappers_raise_on_bad_cuda_input(cuda):
    bank = _bank(8e6, 2441e6, cuda)
    Q, D = bank[0].shape
    with pytest.raises(TypeError):
        pfb.deinterleave(torch.zeros((2, 400), dtype=torch.float64,
                                     device=cuda), D)
    with pytest.raises(ValueError):
        pfb_kernel.pfb_channelize(torch.zeros((2, D, 2 * Q), device=cuda),
                                  *bank)
    with pytest.raises(ValueError):
        pfb_kernel.pfb_channelize(torch.zeros((2, D, 50), device=cuda),
                                  *[t.cpu() for t in bank])
    # the kernels take Q = QTAPS taps per branch, as every bank has
    short = [bank[0][:5], bank[1][:5], *bank[2:]]
    with pytest.raises(ValueError, match="taps per branch"):
        pfb_kernel.pfb_channelize(torch.zeros((2, D, 50), device=cuda),
                                  *short)
    with pytest.raises(ValueError, match="taps per branch"):
        pfb_kernel.pfb_snr(torch.zeros((2, 100 * D), device=cuda), *short,
                           50)


@pytest.mark.parametrize("C,n", [(3, 1), (5, 37), (7, 1234), (79, 43054)])
def test_error_planes_kernel_matches_plain(cuda, C, n):
    """detect_words with emit_err: all 9 planes equal to the plain
    version, at one offset, a ragged word, and the full band (79 rows,
    43,054 offsets); and the dense entry points over them against the
    plain versions on the CPU."""
    from gr_bluetooth_tpu_torch.core.access_code import ac_bits
    r = np.random.default_rng(n)
    T = n + 71
    bits = r.integers(0, 2, (C, T)).astype(np.int64)
    for i, off in enumerate(sorted({0, n // 2, n - 1})):
        ac = ac_bits(0x24D952 + i)[:68].copy()
        ac[6 + i] ^= i % 2
        bits[i % C, off:off + 68] = ac
    tb = torch.from_numpy(bits)
    words = detect_kernel.pack_bits_words(tb).to(cuda)
    masks = torch.from_numpy(detect_kernel.ac_masks()).to(cuda)
    before = (detect_kernel.detect_words.launches,
              detect_kernel.detect_words.err_launches)
    h, g, e = detect_kernel.detect_words(words, n, 6, masks, emit_err=True)
    assert (detect_kernel.detect_words.launches,
            detect_kernel.detect_words.err_launches) == \
        (before[0], before[1] + 1)
    ph, pg, pe = detect_kernel.detect_words_plain(words, n, 6, masks,
                                                  emit_err=True)
    assert e.shape == (detect_kernel.N_ERR, C, -(-n // 32))
    assert torch.equal(h, ph) and torch.equal(g, pg) and torch.equal(e, pe)
    hit0, gate0, none = detect_kernel.detect_words(words, n, 6, masks)
    assert none is None and torch.equal(hit0, h) and torch.equal(gate0, g)
    assert torch.equal(detect_kernel.gated_error(tb.to(cuda)).cpu(),
                       detect_kernel.gated_error(tb))
    hk, ek = detect_kernel.classic_detect_words(tb.to(cuda))
    hc, ec = detect_kernel.classic_detect_words(tb)
    assert torch.equal(hk.cpu(), hc) and torch.equal(ek.cpu(), ec)
    assert int(hc.sum()) >= 1


@pytest.mark.parametrize("aliased,afh", [(False, False), (True, False),
                                         (False, True)])
def test_device_winnower_on_card_matches_cpu(cuda, aliased, afh):
    """DeviceWinnower's mask on the card, winnowed along a hop-consistent
    pattern, against the same on the CPU: equal counts at every step and
    equal survivors, the master's clock among them."""
    from gr_bluetooth_tpu_torch.core import hop
    from gr_bluetooth_tpu_torch.ops import hop_ops
    r = np.random.default_rng(3 + 2 * aliased + afh)
    address = int(r.integers(0, 1 << 28))
    clk0 = int(r.integers(0, 1 << 27))
    ac = hop.address_precalc(address)

    def ch(off):
        c = int(hop.hop((clk0 + off) & 0x7FFFFFF, ac, afh=afh))
        return int(hop.aliased_channel(c)) if aliased else c

    pattern = [(o, ch(o)) for o in (0, 2, 5, 9, 14, 27, 33, 1000, 40000)]
    ws = [hop_ops.DeviceWinnower(address, clk0 & 0x3F, pattern[0][1],
                                 aliased=aliased, afh=afh, device=d)
          for d in (cuda, "cpu")]
    assert ws[0].mask.is_cuda and ws[0].count == ws[1].count > 8192
    for off, c in pattern[1:]:
        assert ws[0].winnow(off, c) == ws[1].winnow(off, c)
    got = ws[0].candidates()
    assert np.array_equal(got, ws[1].candidates())
    assert clk0 in got.tolist()


# ------------------------------------------- odd and off-grid rates, the CLI

def test_conv_bank_step_at_81_msps_matches_cpu(cuda):
    """The 81 Msps conv-bank step on the card (cuDNN conv1d, cuFFT slot
    SNR, torch demod, the detect_words kernel) against the plain step on
    the CPU, with cuDNN and matmul TF32 ON for the process: the channel
    streams within 2e-5 (the guard keeps the conv in FP32), the
    detector planes of the card's words exact against the plain
    detector, the hit table equal and SNR within 1e-3 dB."""
    from gr_bluetooth_tpu_torch.ops import channelizer
    fg = FrontEnd(81e6, 2441e6, block_slots=16)
    fc = FrontEnd(81e6, 2441e6, block_slots=16, device="cpu")
    assert not fg.is_pfb and fg.bank.n_channels == 79
    x, _ = chip_smoke.plant_capture(fc, 1, seed=8)
    c, s = fg.consts, fg.statics
    xb = fg.to_planes(x[: fg.block_samples])
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yr, yi = channelizer._channelize_impl(
            xb[None], c["kernel"], c["rot_q"], 0, decim=s["decim"],
            sps=s["sps"])
        assert torch.backends.cudnn.allow_tf32      # restored after
        counts = _launches()
        og = fg.device_step(xb)
        assert _launches() == {k: n + (k in ("detect_words", "hit_table"))
                               for k, n in counts.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    pr, pi = channelizer._channelize_impl(
        xb[None].cpu(), fc.consts["kernel"], fc.consts["rot_q"], 0,
        decim=s["decim"], sps=s["sps"])
    err = max((yr.cpu() - pr).abs().max().item(),
              (yi.cpu() - pi).abs().max().item())
    assert err <= 2e-5, err
    oc = fc.device_step(x[: fc.block_samples])
    torch.testing.assert_close(og[0].cpu(), oc[0], atol=1e-3, rtol=0)
    assert int(og[1]) == int(oc[1]) >= 10
    assert torch.equal(og[2].cpu(), oc[2])
    # the detector on the card's own words: kernel against plain, exact
    from gr_bluetooth_tpu_torch.ops import demod
    _, bits = demod.demod_and_slice(yr, yi, s["demod_gain"], s["ch_sps"],
                                    s["n_sym"])
    words = detect_kernel.pack_bits_words(bits)
    n = s["n_sym"] - 72 + 1
    hit, gate, _ = detect_kernel.detect_words(words, n, 6, c["ac_masks"])
    phit, pgate, _ = detect_kernel.detect_words_plain(
        words.cpu(), n, 6, c["ac_masks"].cpu())
    assert torch.equal(hit.cpu(), phit) and torch.equal(gate.cpu(), pgate)


@pytest.mark.parametrize("fs", [7.68e6, 2.5e6])
def test_fused_kernels_on_the_restricted_channel_set(cuda, fs):
    """Off-grid rates run the polyphase bank at the internal rate on the
    true band's channels only (2.5 -> 4 Msps: channel 39 and its probe
    row; 7.68 -> 8 Msps: 36..42): pfb_snr and demod_pack against their
    plain versions on such a bank."""
    fe = FrontEnd(fs, 2441e6, block_slots=8)
    assert fe.resampler is not None and fe.is_pfb
    c, s = fe.consts, fe.statics
    assert c["dft_c"].shape[1] == fe.bank.n_channels + 1
    r = np.random.default_rng(int(fs) // 1000)
    xb = torch.from_numpy(r.normal(0, 0.5, (2, fe.block_samples)).astype(
        np.float32)).to(cuda)
    Q, D = c["h0"].shape
    n, n_data, S, n_k, n_frames = frontend.step_geometry(
        xb.shape[1], Q, D, s["n_sym"], s["slot_ch"], c["probe_re"].shape[0])
    bank = (c["h0"], c["h1"], c["dft_c"], c["dft_s"], c["bin_odd"])
    yr, yi, oe = pfb_kernel.pfb_snr(xb, *bank, n_frames)
    pr, pi, poe = pfb_kernel.pfb_snr_plain(xb, *bank, n_frames)
    assert (yr - pr).abs().max().item() <= 2e-5
    assert (yi - pi).abs().max().item() <= 2e-5
    torch.testing.assert_close(oe, poe, atol=1e-4, rtol=1e-4)
    args = (yr, yi, s["demod_gain"], s["n_sym"], c["probe_re"],
            c["probe_im"], n_k, n_data)
    words, pe = demod_kernel.demod_pack(*args)
    pwords, ppe = demod_kernel.demod_pack_plain(*args)
    assert _popcount_diff(words, pwords) <= max(
        1, words.shape[0] * s["n_sym"] * 1e-5)
    torch.testing.assert_close(pe, ppe, atol=1e-6, rtol=1e-4)


def test_odd_rate_stream_on_card_matches_cpu(cuda):
    """5 Msps (the conv bank, 5 channels) through stream() on the card
    against the CPU: the same hits, SNR within 1e-3 dB; detect_words
    and hit_table once per block and no other kernel."""
    from gr_bluetooth_tpu_torch.models.lap_survey import LapSurvey
    gpu = LapSurvey(5e6, 2441e6, block_slots=8)
    cpu = LapSurvey(5e6, 2441e6, block_slots=8, device="cpu")
    x, planted = chip_smoke.plant_capture(gpu.fe, 2, seed=5)
    counts = _launches()
    og = gpu.run(x, emit_console=False)
    assert _launches() == {k: n + 2 * (k in ("detect_words", "hit_table"))
                           for k, n in counts.items()}
    oc = cpu.run(x, emit_console=False)
    key = lambda o: (o.clkn, o.channel, o.lap, o.errors)  # noqa: E731
    assert [key(o) for o in og] == [key(o) for o in oc]
    assert max(abs(a.snr_db - b.snr_db) for a, b in zip(og, oc)) <= 1e-3
    chip_smoke.check_survey(og, planted)


def test_cli_without_device_runs_on_the_card(cuda):
    """btrx with no --device runs on the card: in this process its main
    launches the fused chain's kernels, and as a subprocess it surveys
    the planted LAP."""
    import contextlib
    import io
    import os
    import subprocess
    import sys
    from gr_bluetooth_tpu_torch.apps import btrx
    args = ["-r", "8e6", "-f", "2441e6", "--synthetic", "128"]
    counts = _launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert btrx.main(args) == 0
    after = _launches()
    for k in ("pfb_snr", "demod_pack", "detect_words"):
        assert after[k] > counts[k], (k, counts, after)
    assert "LAP 24d952" in out.getvalue()
    r = subprocess.run([sys.executable, "-m",
                        "gr_bluetooth_tpu_torch.apps.btrx", *args],
                       capture_output=True, timeout=300,
                       cwd=chip_smoke.ROOT,
                       env=dict(os.environ, PYTHONPATH=chip_smoke.ROOT))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"LAP 24d952" in r.stdout


def test_sharded_front_end_on_card(cuda):
    """chip_smoke.py's phase 9b at 8 Msps: four shards on the card, each
    on its own stream, LE on, two superblocks with packets across shard
    and superblock boundaries: the same hits as FrontEnd.stream, the
    fused chain's kernels once per shard and superblock."""
    planes, results = chip_smoke.sharded_phase(
        8e6, 2426e6, block_slots=8, device=cuda, n_shards=4, n_blocks=8)
    assert len(results) == 8 and any(r.le_hits for r in results)


def test_grid_front_end_on_card(cuda):
    """chip_smoke.py's phase 9c at 8 Msps: a 2 x 2 grid on the card, the
    same hits as FrontEnd.stream, and the three kernels at the group
    width (5 DFT columns) against their plain versions."""
    chip_smoke.grid_phase(8e6, 2426e6, block_slots=8, device=cuda,
                          n_blocks=4)


def test_sharded_outputs_on_card_match_cpu(cuda):
    """The sharded step's stacked outputs on the card equal the CPU's:
    hit counts and tables exactly, slot SNR within 1e-3 dB, windows up
    to one mismatched symbol per 10^5."""
    from gr_bluetooth_tpu_torch.parallel import ShardedFrontEnd
    fe_g = FrontEnd(8e6, 2426e6, block_slots=8, enable_le=True)
    fe_c = FrontEnd(8e6, 2426e6, block_slots=8, enable_le=True,
                    device="cpu")
    x, _, _ = chip_smoke.plant_le_capture(fe_g, 4, seed=3)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    outs = []
    for fe, dev in ((fe_g, cuda), (fe_c, torch.device("cpu"))):
        sfe = ShardedFrontEnd(fe, [dev] * 4)
        outs.append([o.cpu() for o in sfe.step(
            sfe.device_put(planes), np.zeros((2, sfe.overlap_samples),
                                             np.float32))])
    g, c = outs
    torch.testing.assert_close(g[0], c[0], atol=1e-3, rtol=0)
    for i in (1, 2, 4, 5):
        assert torch.equal(g[i], c[i]), i
    for i in (3, 6):
        assert _popcount_diff(g[i], c[i]) <= max(1, g[i].numel() * 32e-5)


def _two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_kernels_on_a_card_that_is_not_the_current_one(cuda):
    """The wrappers launch under their tensors' device: the three fused
    kernels on card 1 with card 0 current (card 1 launched first, so its
    shared-memory attribute and occupancy are set on card 1 itself)."""
    c0, c1 = _two_cards(cuda)
    fe = FrontEnd(8e6, 2441e6, block_slots=8, device=c1)
    x, _ = chip_smoke.plant_capture(fe, 1, seed=2)
    xb = fe.to_planes(x[: fe.block_samples])
    with torch.cuda.device(c0):
        chip_smoke.fused_kernel_checks("card 1, card 0 current",
                                       fe.statics, fe.consts, xb)


def test_shards_on_two_cards_match_stream(cuda):
    """Four shards alternating over two cards (peer halo copies): the
    same hits as FrontEnd.stream."""
    c0, c1 = _two_cards(cuda)
    chip_smoke.sharded_phase(8e6, 2426e6, block_slots=8, n_blocks=8,
                             devices=[c0, c1, c0, c1])


# ------------------------------------------------------------ compiled steps

def _clone(outs):
    return [None if o is None else o.clone() for o in outs]


@pytest.mark.parametrize("chain,fs,center,le", [
    ("fused", 8e6, 2426e6, False), ("fused", 8e6, 2426e6, True),
    ("flat", 8e6, 2426e6, True), ("flat", 81e6, 2441e6, False)])
def test_replay_equals_eager_exactly(cuda, chain, fs, center, le):
    """Each chain's compiled step (one graph replay) against its eager
    step on a planted block, twice: every output bit for bit (the fused
    chain with LE off and on, the flat chain, the 81 Msps conv bank)."""
    fe = FrontEnd(fs, center, block_slots=16, enable_le=le)
    x, _ = chip_smoke.plant_capture(fe, 1, seed=4)
    xb = fe.to_planes(x[: fe.block_samples])
    eager = fe.fused_step if chain == "fused" else fe.device_step
    want = _clone(eager(xb))
    step = fe.compiled_step(chain)
    assert step.graph is not None and fe.compiled_step(chain) is step
    for _ in range(2):
        chip_smoke.check_replay(chain, step(xb), want)
    assert int(want[1]) >= 5


def test_graph_captured_on_a_non_default_stream(cuda):
    """A CompiledStep captured on a stream the caller gives replays
    there, called from the default stream and from a third stream: the
    outputs equal the eager step's each time."""
    from gr_bluetooth_tpu_torch.utils.graph import CompiledStep
    fe = FrontEnd(8e6, 2441e6, block_slots=8)
    x, _ = chip_smoke.plant_capture(fe, 1, seed=5)
    xb = fe.to_planes(x[: fe.block_samples])
    want = _clone(fe.fused_step(xb))
    s = torch.cuda.Stream()
    step = CompiledStep(
        lambda v: frontend._fused_step(v, **fe.consts, **fe.statics), [xb],
        stream=s)
    assert step.stream == s and step.stream != torch.cuda.current_stream()
    chip_smoke.check_replay("default stream", step(xb), want)
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        got = _clone(step(xb))
    torch.cuda.current_stream().wait_stream(other)
    chip_smoke.check_replay("third stream", got, want)


def test_entry_on_the_card(cuda):
    """graft_entry.entry() with no device runs on the card: its step is a
    graph, and on its zeros and on a planted block it equals the eager
    flat step of the same front end."""
    from gr_bluetooth_tpu_torch import graft_entry
    step, (x,) = graft_entry.entry()
    assert x.is_cuda and x.shape == (2, step.inputs[0].shape[1])
    assert step.graph is not None
    fe = FrontEnd(16e6, 2441e6, block_slots=16)
    chip_smoke.check_replay("zeros", step(x), _clone(fe.device_step(x)))
    xp, _ = chip_smoke.plant_capture(fe, 1, seed=7)
    xb = fe.to_planes(xp[: fe.block_samples])
    want = _clone(fe.device_step(xb))
    chip_smoke.check_replay("planted", step(xb), want)
    assert int(want[1]) >= 5


def test_launches_count_replays(cuda):
    """A replay calls no wrapper: the capture (its warm-up included)
    counts nothing, records each kernel's launches per replay, and every
    replay adds them; stream() counts one replay per block."""
    fe = FrontEnd(8e6, 2441e6, block_slots=8)
    xb = torch.zeros((2, fe.block_samples), device=cuda)
    fused = ("pfb_snr", "demod_pack", "detect_words", "hit_table")
    flat = ("deinterleave", "pfb_channelize", "detect_words", "hit_table")
    for chain, names in (("fused", fused), ("flat", flat)):
        counts = _launches()
        step = fe.compiled_step(chain)
        assert _launches() == counts
        assert step.launches_per_replay == {f"{k}.launches": 1
                                            for k in names}
        for _ in range(3):
            step(xb)
        assert _launches() == {k: c + 3 * (k in names)
                               for k, c in counts.items()}
    x, _ = chip_smoke.plant_capture(fe, 3, seed=2)
    counts = _launches()
    n = len(list(fe.stream(x)))
    assert n == 3 and _launches() == {k: c + 3 * (k in fused)
                                      for k, c in counts.items()}


def test_compiled_ingest_equals_eager_ingest_on_card(cuda):
    """The compiled ingest (one replay per block, the pinned ring
    wrapping) against the eager ingest on the same int16 chunks with a
    slip among them: the same blocks, bit for bit."""
    fe = FrontEnd(8e6, 2426e6, block_slots=8, enable_le=True)
    x, _, _ = chip_smoke.plant_le_capture(fe, ingest.DEPTH + 4, seed=9)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    carry, chunks = ingest.wire_chunks(0.5 * planes, fe, "i16")
    chunks = list(chunks)
    chunks.insert(3, ingest._Slip(slots=5, samples=5 * fe.samples_per_slot))
    runs = []
    for cls in (ingest.PipelinedIngest, chip_smoke.EagerIngest):
        runs.append(list(cls(fe, "i16").run(iter(chunks), 11,
                                            initial_carry=carry)))
    a, b = runs
    assert len(a) == len(b) == len(chunks) - 1 >= ingest.DEPTH + 3
    for ra, rb in zip(a, b):
        assert ra.slot_base == rb.slot_base and ra.hits == rb.hits
        assert ra.le_hits == rb.le_hits
        assert np.array_equal(ra.snr_db.view(np.int32),
                              rb.snr_db.view(np.int32))
        assert np.array_equal(ra.windows, rb.windows)
        assert np.array_equal(ra.le_windows, rb.le_windows)
    assert sum(len(r.hits) for r in a) >= 10


def test_bench_stream_runner_equals_eager_on_card(cuda):
    """The bench's device loop (gr_bluetooth_tpu_torch/bench.py: block
    i % K copied into the compiled fused step's input, the checksum added
    on the step's stream) over more blocks than it holds: the checksum of
    the eager fused step on the same blocks, exactly; the parity runner's
    counts and tables equal the eager step's."""
    from gr_bluetooth_tpu_torch import bench
    fe = FrontEnd(8e6, 2441e6, block_slots=8, max_ac_errors=1)
    x, _ = chip_smoke.plant_capture(fe, 3, seed=4)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    xd = bench.stage_blocks(fe, planes, 3)
    want = torch.zeros((), device=cuda)
    outs = []
    for i in range(7):
        _, n, tab, win, _, _, _ = fe.fused_step(xd[i % 3])
        want = (want + n.to(torch.float32) + tab[0, 1].to(torch.float32)
                + win[0, 0].to(torch.float32))
        outs.append((n.clone(), tab.clone()))
    assert bench.make_stream_runner(fe, 3)(xd, 7) == float(want) != 0.0
    n, tabs = bench.make_parity_runner(fe, 3)(xd)
    for i in range(3):
        assert int(n[i]) == int(outs[i][0])
        assert torch.equal(tabs[i], outs[i][1])
    assert int(n.sum()) >= 5


@pytest.mark.parametrize("name,wire,np_dtype,scale,full", [
    ("int16", "i16", np.int16, 32767.0, 32768.0),
    ("int8", "i8", np.int8, 127.0, 128.0),
    ("int4", "i4", np.uint8, 8.0, 8.0)])
def test_bench_ingest_runner_equals_eager_on_card(cuda, name, wire,
                                                  np_dtype, scale, full):
    """The bench's ingest (pageable copies on a copy stream, two blocks
    in flight, the compiled flat step with its static carry) against the
    eager body on the card: every block's checksum and the final carry,
    bit for bit."""
    from gr_bluetooth_tpu_torch import bench
    fe = FrontEnd(8e6, 2441e6, block_slots=8, max_ac_errors=1)
    x, _ = chip_smoke.plant_capture(fe, 4, seed=6)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    ov, st = fe.overlap_samples, fe.step_samples
    if wire == "i4":
        xi = ingest.wire_encode(planes, wire)
        blocks = [xi[ov + i * st: ov + (i + 1) * st] for i in range(3)]
    else:
        xc = np.clip(planes * scale, -full, full - 1).astype(np_dtype)
        blocks = [xc[:, ov + i * st: ov + (i + 1) * st] for i in range(3)]
    step = bench.make_ingest_runner(fe, np_dtype, 1.0 / full, wire=wire)
    assert step.step.graph is not None
    carry0 = torch.from_numpy(planes[:, :ov].copy()).to(cuda)
    _, accs, carry = bench.run_ingest(step, carry0, blocks, 5)
    c = carry0.clone()
    for i in range(5):
        new = torch.from_numpy(np.ascontiguousarray(blocks[i % 3])).to(cuda)
        x_new = (ingest.wire_decode(new, "i4") if wire == "i4"
                 else new.to(torch.float32) * (1.0 / full))
        xb = torch.cat([c, x_new], 1)
        _, n, tab, win, _, _, _ = fe.device_step(xb)
        want = (n.to(torch.float32) + tab[0, 1].to(torch.float32)
                + win[0, 0].to(torch.float32))
        assert float(accs[i]) == float(want), i
        c = xb[:, -ov:].clone()
    assert torch.equal(carry.view(torch.int32), c.view(torch.int32))


def _le_args(fe, words):
    c, s = fe.consts, fe.statics
    tables = {k: c[k] for k in ("le_pre_dist", "le_aa_dist", "le_acc_dist",
                                "le_dat_dist")}
    return (words, c["le_rows"], s["n_sym"], c["le_white_word"],
            c["le_aa_on"], c["le_max_dist"]), tables


def _le_exact(fe, words):
    """le_detect in both forms against its plain version on one word
    plane: the hit plane (of the step's form, hits only, and of the form
    with the distances) and the distances bit for bit.  Returns the hit
    count."""
    args, tables = _le_args(fe, words)
    n, nd = detect.le_detect.launches, detect.le_detect.dist_launches
    hitw, dist = detect.le_detect(*args, **tables)
    step_hitw, none = detect.le_detect(*args, with_dist=False, **tables)
    assert detect.le_detect.launches == n + 1
    assert detect.le_detect.dist_launches == nd + 1
    phitw, pdist = detect.le_detect_plain(*args, **tables)
    assert torch.equal(hitw, phitw) and torch.equal(dist, pdist)
    assert none is None and torch.equal(step_hitw, phitw)
    return _popcount_diff(hitw, torch.zeros_like(hitw))


@pytest.mark.parametrize("seed", [0, 1])
def test_le_detect_kernel_matches_plain_at_full_band(cuda, seed):
    """Full band (40 LE rows of 79, n_sym 43,125): random words with LE
    advertising and data frames planted at every bit alignment, some
    with flipped symbols, and at the rows' last offset; bits past n_sym
    random."""
    fe = FrontEnd(80e6, 2441e6, block_slots=64, enable_le=True)
    n_sym = fe.n_sym
    W = -(-n_sym // 32) + 2
    r = np.random.default_rng(seed)
    bits = r.integers(0, 2, (79, 32 * W)).astype(np.uint8)
    n_le = n_sym - detect.LE_SPAN + 1
    for j, (row, _ch, index) in enumerate(fe.le_rows):
        for k in range(40):
            off = n_le - 1 if k == 39 else 97 * (j + 40 * k) % (n_le - 64) \
                + k % 32
            if index >= 37:
                f = packets.encode_le_adv(0x8E89BED6, index, k % 7,
                                          bytes(range(8)), crc=False)
            else:
                f = packets.encode_le_data(0x50654A3B + k, index, 1 + k % 3,
                                           bytes(range(5)),
                                           crc_init=0x555555)
            f = f[:detect.LE_SPAN].copy()
            f[r.permutation(detect.LE_SPAN)[:k % 4]] ^= 1
            bits[row, off: off + detect.LE_SPAN] = f
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    w = torch.from_numpy(words.view(np.int32).copy()).to(cuda)
    assert _le_exact(fe, w) >= 200


def test_le_detect_kernel_on_a_planted_block(cuda):
    """The words of a full-band block with LE advertising packets
    planted (chip_smoke.py phase 5's capture, its first block)."""
    fe = FrontEnd(80e6, 2441e6, block_slots=64, max_ac_errors=1,
                  enable_le=True)
    x, _, le_planted = chip_smoke.plant_le_capture(fe, chip_smoke.N_BLOCKS)
    words, _ = chip_smoke.block_step_inputs(
        fe, fe.to_planes(x[: fe.block_samples]))
    assert _le_exact(fe, words) >= len(le_planted) // chip_smoke.N_BLOCKS


@pytest.mark.parametrize("chain", ["fused", "flat"])
def test_le_detect_launches_once_per_replay(cuda, chain):
    """With LE on, each replay of either chain's step launches le_detect
    once, and equals the eager step."""
    fe = FrontEnd(8e6, 2426e6, block_slots=8, max_ac_errors=1,
                  enable_le=True)
    x, _, _ = chip_smoke.plant_le_capture(fe, 3, le_per_block=2)
    xb = fe.to_planes(x[: fe.block_samples])
    eager = fe.fused_step if chain == "fused" else fe.device_step
    want = _clone(eager(xb))
    step = fe.compiled_step(chain)
    assert step.launches_per_replay["le_detect.launches"] == 1
    n = detect.le_detect.launches
    for _ in range(3):
        chip_smoke.check_replay(chain, step(xb), want)
    assert detect.le_detect.launches == n + 3
    assert int(want[4]) >= 1


# ------------------------------------------------------------ hit_table

# the cases of tests/test_torch_hit_table.py at full band: (hit density,
# squelch on); "last words" sets bits in every row's last 40 offsets,
# past the detector's offsets among them
HT_CASES = {"zero hits": (0.0, True), "count > max_hits": (0.01, True),
            "last words": (2e-4, True), "sparse": (2e-4, True),
            "no squelch": (2e-4, False)}


@pytest.fixture(scope="module")
def fe_full(cuda):
    return FrontEnd(80e6, 2441e6, block_slots=64, max_ac_errors=1,
                    enable_le=True)


def _ht_exact(fe, hitw, words, snr_db, le, squelch=True):
    """hit_table against its plain version on the same device tensors:
    count, table and windows bit for bit, one launch counted.  Returns
    the count."""
    args, kw = chip_smoke.hit_table_args(fe, hitw, words, snr_db, le)
    if not squelch:
        kw["squelch"] = None
    counter = "le_launches" if le else "launches"
    n = getattr(hit_table.hit_table, counter)
    got = hit_table.hit_table(*args, **kw)
    assert getattr(hit_table.hit_table, counter) == n + 1
    want = hit_table.hit_table_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return int(got[0])


@pytest.mark.parametrize("le", [False, True])
@pytest.mark.parametrize("case", list(HT_CASES))
def test_hit_table_kernel_matches_plain_at_full_band(fe_full, case, le):
    """Random hit planes of the full-band geometry (79 x 1,346 classic,
    40 x 1,346 LE), random words and a random slot SNR (10 dB squelch:
    slot boundaries inside words, the last words in slot S mirrored)."""
    fe, cuda = fe_full, fe_full.device
    c = fe.consts
    s0 = c["le_word_s0"] if le else c["word_s0"]
    R, w = (len(fe.le_rows) if le else 79), s0.shape[0]
    S = fe.n_sym // 625
    assert int(s0.max()) + 1 >= S          # words reaching slot S
    density, squelch = HT_CASES[case]
    r = np.random.default_rng(len(case) + 7 * le)
    bits = r.random((R, 32 * w)) < density
    if case == "last words":
        bits[:, -40:] |= r.random((R, 40)) < 0.3
    hitw = torch.from_numpy(np.packbits(bits, axis=1, bitorder="little")
                            .view("<u4").view(np.int32).copy()).to(cuda)
    W = -(-fe.n_sym // 32)
    words = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31, (79, W))
                             .astype(np.int32)).to(cuda)
    snr_db = torch.from_numpy(np.where(r.random((S, 79)) < 0.5, 4.0, 16.0)
                              .astype(np.float32)).to(cuda)
    n = _ht_exact(fe, hitw, words, snr_db, le, squelch)
    max_hits = fe.max_le_hits if le else fe.max_hits
    if case == "zero hits":
        assert n == 0
    elif case == "count > max_hits":
        assert n > max_hits
    else:
        assert 0 < n


def test_hit_table_kernel_on_a_planted_block(fe_full):
    """Both forms on the tail inputs of a full-band block with classic
    and LE advertising packets planted (chip_smoke.py phase 5's capture,
    its first block): the classic one over detect_words' plane, the LE
    one over le_detect's step form."""
    fe = fe_full
    x, _, le_planted = chip_smoke.plant_le_capture(fe, chip_smoke.N_BLOCKS)
    words, snr_db = chip_smoke.block_step_inputs(
        fe, fe.to_planes(x[: fe.block_samples]))
    s, c = fe.statics, fe.consts
    hitw, _, _ = detect_kernel.detect_words(words, s["n_sym"] - 72 + 1,
                                            s["max_ac_errors"], c["ac_masks"])
    assert _ht_exact(fe, hitw, words, snr_db, False) >= 10
    args, tables = _le_args(fe, words)
    le_hitw, _ = detect.le_detect(*args, with_dist=False, **tables)
    assert _ht_exact(fe, le_hitw, words, snr_db, True) >= \
        len(le_planted) // chip_smoke.N_BLOCKS


@pytest.mark.parametrize("le", [False, True])
def test_hit_table_launches_once_per_tail(cuda, le):
    """Each replay of the fused and the flat step launches the classic
    hit table once and, with LE on, its LE form once, and equals the
    eager step."""
    fe = FrontEnd(8e6, 2426e6, block_slots=8, max_ac_errors=1,
                  enable_le=le)
    x, _, _ = chip_smoke.plant_le_capture(fe, 3, le_per_block=2)
    xb = fe.to_planes(x[: fe.block_samples])
    for chain in ("fused", "flat"):
        eager = fe.fused_step if chain == "fused" else fe.device_step
        want = _clone(eager(xb))
        step = fe.compiled_step(chain)
        per = step.launches_per_replay
        assert per["hit_table.launches"] == 1
        assert per.get("hit_table.le_launches", 0) == int(le)
        assert "le_detect.dist_launches" not in per
        n, n_le = hit_table.hit_table.launches, hit_table.hit_table.le_launches
        for _ in range(2):
            chip_smoke.check_replay(chain, step(xb), want)
        assert hit_table.hit_table.launches == n + 2
        assert hit_table.hit_table.le_launches == n_le + 2 * le
        assert int(want[1]) >= 1 and (not le or int(want[4]) >= 1)


# ------------------------------------------------------ hit_table's cluster

@pytest.fixture(scope="module")
def fe8_le(cuda):
    return FrontEnd(8e6, 2426e6, block_slots=8, max_ac_errors=1,
                    enable_le=True)


@pytest.fixture(scope="module")
def fe128_le(cuda):
    return FrontEnd(80e6, 2441e6, block_slots=128, max_ac_errors=1,
                    enable_le=True)


@pytest.mark.parametrize("geo", ["fe_full", "fe128_le", "fe8_le"])
def test_hit_cluster_density_cases(request, geo):
    """The cluster kernel in both forms and both in one launch, at full
    band with 64- and 128-slot blocks (the classic plane's 79 x 2,596
    words give a block more than one pass) and at 8 Msps with 8-slot
    blocks (fewer plane words than the cluster has threads), on
    chip_smoke.HT_DENSITIES' cases: no hit, one, exactly max_hits, more,
    and all in one block's range; count, table and windows exact."""
    fe = request.getfixturevalue(geo)
    if geo == "fe128_le":
        n = fe.consts["word_s0"].shape[0] * len(fe.bank.channels)
        assert hit_table.cluster_split(n).per > 8 * hit_table.THREADS
    for density, cl, le, k in chip_smoke.density_cases(fe, seed=16):
        got = (chip_smoke.tails_exact(density, (cl,)) +
               chip_smoke.tails_exact(density, (le,)))
        assert got == list(k)
        assert chip_smoke.tails_exact(density, (cl, le)) == got
        if density == "above max_hits":
            assert got[0] > fe.max_hits and got[1] > fe.max_le_hits
        elif density == "zero":
            assert got == [0, 0]
        elif density == "one block":
            assert got == [150, 150]


@pytest.mark.parametrize("geo", ["fe_full", "fe8_le"])
def test_hit_tails_on_two_streams_at_once(request, geo):
    """Tails launched on two streams of one card with no sync between
    them (as shards on one card run): each equals the plain version, so
    no launch shares state with another."""
    fe = request.getfixturevalue(geo)
    side = (torch.cuda.Stream(), torch.cuda.Stream())
    pending = []
    for _ in range(2):
        for _, cl, le, _ in chip_smoke.density_cases(fe, seed=5):
            for tails, st in (((cl,), side[0]), ((le,), side[1]),
                              ((cl, le), side[1]), ((cl,), side[1])):
                st.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(st):
                    pending.append((tails, hit_table._run(tails)))
    torch.cuda.synchronize()
    for tails, got in pending:
        chip_smoke.tails_exact("two streams", tails, got=got)


def test_hit_tables_counts_each_tail_once(fe_full):
    """hit_tables launches once and counts one classic and one LE tail,
    as two hit_table calls would."""
    _, cl, le, _ = next(chip_smoke.density_cases(fe_full, seed=3))
    n, n_le = hit_table.hit_table.launches, hit_table.hit_table.le_launches
    hit_table.hit_tables(cl, le)
    assert (hit_table.hit_table.launches,
            hit_table.hit_table.le_launches) == (n + 1, n_le + 1)


def test_hit_table_raises_on_a_refused_cluster(fe_full):
    """A cluster the card refuses (here for its shared memory: a list of
    65,536 hits takes 256 KB a block) raises; nothing falls back to the
    plain version."""
    _, cl, _, _ = next(chip_smoke.density_cases(fe_full, seed=4))
    n = hit_table.hit_table.launches
    with pytest.raises(RuntimeError):
        hit_table._run((dict(cl, max_hits=1 << 16),))
    assert hit_table.hit_table.launches == n
