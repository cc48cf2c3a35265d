"""The receiver's front end in plain PyTorch: bank, channelizer, SNR, demod,
access-code and LE detection, squelch and hit tables.

A frozen copy, for the benchmark's yardstick, of the port's plain versions (ops/*.py, models/frontend.py)
(gr_bluetooth_tpu_torch).  It imports nothing of the port; later
changes to the port leave it as it is.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..traffic.air import access_code, whitening
from ..traffic.air.constants import (BASE_FREQUENCY, CHANNEL_FILTER_CUTOFF,
                                     CHANNEL_FILTER_TRANSITION, CHANNEL_WIDTH,
                                     NOISE_FILTER_CUTOFF, NOISE_FILTER_TRANSITION,
                                     NOISE_PROBE_OFFSET, SYMBOLS_PER_SLOT)
from ..traffic.air.le_tables import (AA_DISTANCE, ACCESS_HEADER_DISTANCE,
                                     DATA_HEADER_DISTANCE, LE_PREAMBLE_DISTANCE)


@contextlib.contextmanager
def fp32_matmul():
    """Matmuls and cuDNN convolutions enqueued inside the block run in
    FP32, not TF32; both process-wide flags are restored on exit, so a
    caller's own setting holds outside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


_HANN_ATTEN_DB = 44.0


def ntaps_lowpass(fs: float, transition: float) -> int:
    n = int(_HANN_ATTEN_DB / (22.0 * (transition / fs)))
    return n | 1  # odd


def lowpass_taps(gain: float, fs: float, cutoff: float,
                 transition: float) -> np.ndarray:
    n = ntaps_lowpass(fs, transition)
    m = (n - 1) // 2
    k = np.arange(n) - m
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    fwt0 = 2.0 * np.pi * cutoff / fs
    kk = np.where(k == 0, 1, k)  # avoid 0/0; k==0 lane is replaced below
    taps = np.where(k == 0, fwt0 / np.pi, np.sin(fwt0 * kk) / (np.pi * kk)) * w
    taps *= gain / taps.sum()
    return taps.astype(np.float64)


def select_channels(fs: float, center_freq: float) -> tuple:
    """BR channels fitting in bandwidth with >= 0.9 MHz margin
    (multi_block.cc:305-324)."""
    center = (center_freq - BASE_FREQUENCY) / CHANNEL_WIDTH
    bw = fs / CHANNEL_WIDTH
    low = max(0, int(center - bw / 2 + 0.45 + 1))
    high = min(78, int(center + bw / 2 - 0.45))
    if high < low:
        raise ValueError("no BR channels fit in this bandwidth")
    return tuple(range(low, high + 1))


@dataclass(frozen=True)
class PfbBank:
    fs: float
    center_freq: float
    sps: int                      # wideband samples per symbol = M branches
    decim: int                    # D = M/2
    ch_sps: float                 # always 2.0
    channels: tuple               # BR channel numbers covered
    ntaps: int                    # prototype length before padding
    h0: np.ndarray                # (Q, D) branch taps, even half-frames
    h1: np.ndarray                # (Q, D) branch taps, odd half-frames
    dft_c: np.ndarray             # (M, C) cos DFT columns for covered bins
    dft_s: np.ndarray             # (M, C) sin DFT columns for covered bins
    bin_odd: np.ndarray           # (C,) float32: 1.0 where DFT bin is odd
    demod_gain: float

    @property
    def n_channels(self) -> int:
        return len(self.channels)


def make_pfb_bank(fs: float, center_freq: float,
                  channels: tuple | None = None) -> PfbBank:
    sps = int(round(fs / 1e6))
    if abs(fs - sps * 1e6) > 1e-3 or sps < 2:
        raise ValueError("sample rate must be an integer multiple of 1 Msps >= 2")
    if sps % 2:
        raise ValueError("polyphase bank requires an even samples/symbol; "
                         "use the conv bank for odd rates")
    if abs((center_freq / 1e6) - round(center_freq / 1e6)) > 1e-9:
        raise ValueError("center frequency must sit on the 1 MHz channel grid")
    M = sps
    D = M // 2

    # channels may be overridden by resampled front ends whose TRUE band
    # is narrower than the internal rate (ops/resample.py)
    channels = tuple(channels) if channels else \
        select_channels(fs, center_freq)
    # one extra "probe row" above the top channel: the off-channel noise
    # probe at f_c + 790 kHz (multi_block.cc:71-79, 336-340) sits at
    # -210 kHz inside channel c+1's passband, so the SNR squelch reads it
    # from the neighbor's stream (ops/snr.py) — rows = channels + [high+1]
    probe_rows = channels + (channels[-1] + 1,)

    taps = lowpass_taps(1.0, fs, CHANNEL_FILTER_CUTOFF,
                        CHANNEL_FILTER_TRANSITION)
    ntaps = len(taps)
    Q = -(-ntaps // M)                                 # half-frames, ceil
    h = np.zeros(Q * M, dtype=np.float64)
    h[:ntaps] = taps
    hm = h.reshape(Q, M)
    h0 = hm[:, :D].astype(np.float32)                  # h[qM + p]
    h1 = hm[:, D:].astype(np.float32)                  # h[qM + p + D]

    C = len(probe_rows)
    r = np.arange(M)
    dft_c = np.zeros((M, C), dtype=np.float32)
    dft_s = np.zeros((M, C), dtype=np.float32)
    bin_odd = np.zeros(C, dtype=np.float32)
    for i, ch in enumerate(probe_rows):
        f_rel = BASE_FREQUENCY + ch * CHANNEL_WIDTH - center_freq
        m = int(round(f_rel / 1e6)) % M                # DFT bin
        ang = 2.0 * np.pi * m * r / M
        dft_c[:, i] = np.cos(ang)
        dft_s[:, i] = np.sin(ang)
        bin_odd[i] = float(m & 1)
    demod_gain = 2.0 / (np.pi / 2.0)                   # ch_sps / (pi/2)
    return PfbBank(fs, center_freq, sps, D, 2.0, channels, ntaps,
                   h0, h1, dft_c, dft_s, bin_odd, float(demod_gain))


PROBE_STRIDE = 40                       # probe energy samples per slot: ~31


@dataclass(frozen=True)
class StreamSnrConsts:
    """Constants for the stream-based squelch (no FFT, no full-rate FIRs)."""
    slot_ch: int                  # channel-rate samples per slot
    taps_re: np.ndarray           # (T,) probe band-pass, real part
    taps_im: np.ndarray           # (T,) probe band-pass, imag part
    kappa: float


def make_stream_snr_consts(bank) -> StreamSnrConsts:
    ch_fs = bank.fs / bank.decim
    slot_ch = int(round(SYMBOLS_PER_SLOT * bank.ch_sps))
    # 2x the reference's 10 kHz transition: halves the tap count; kappa
    # below renormalizes the equivalent noise bandwidth so the on/off ratio
    # (and the 10 dB squelch meaning) is unchanged on a flat floor
    g = lowpass_taps(1.0, ch_fs, NOISE_FILTER_CUTOFF,
                     2.0 * NOISE_FILTER_TRANSITION)
    t = np.arange(len(g))
    theta = -2.0 * np.pi * ((NOISE_PROBE_OFFSET - CHANNEL_WIDTH) / ch_fs) * t
    taps_re = (g * np.cos(theta)).astype(np.float32)
    taps_im = (g * np.sin(theta)).astype(np.float32)
    # reference probe: 22.5 kHz cut / 10 kHz transition at the full rate
    h_ref = lowpass_taps(1.0, bank.fs, NOISE_FILTER_CUTOFF,
                         NOISE_FILTER_TRANSITION)
    h_ch = lowpass_taps(1.0, bank.fs, CHANNEL_FILTER_CUTOFF,
                        CHANNEL_FILTER_TRANSITION)
    # white-noise energies: reference off = sigma^2 sum h_ref^2 ; ours =
    # sigma^2 sum h_ch^2 * sum g^2 (probe runs on the channelized stream)
    kappa = float(np.sum(h_ref ** 2) /
                  (np.sum(h_ch ** 2) * np.sum(g ** 2)))
    return StreamSnrConsts(slot_ch, taps_re, taps_im, kappa)


def probe_points(S: int, slot_ch: int, taps_len: int) -> int:
    """Probe grid points the S-slot assembly reads: every window
    [40k, 40k + Tp) inside the first S slots, Tp the tap count rounded
    up to the stride."""
    Tp = -(-taps_len // PROBE_STRIDE) * PROBE_STRIDE
    n_k = (S * slot_ch - Tp) // PROBE_STRIDE + 1
    if n_k < 1:
        raise ValueError("block too short for the probe band-pass")
    return n_k


def assemble_slot_snr(oe, pe, *, S: int, slot_ch: int, kappa: float,
                      tile: int):
    """(S, C) slot SNR in dB from the kernels' partials.

    oe (C+1, G) on-energy sums over `tile`-frame tiles (tile divides
    slot_ch); pe (C+1, n_k) probe energies on the 40-frame grid.  Row
    C is the probe row above the top channel: channel c's noise comes
    from row c+1.  on = slot mean of |y|^2; off = mean of the probe
    energies k in [31s, 31s + 31), the slots past the last full group
    edge-padded from it, times kappa."""
    if slot_ch % tile:
        raise ValueError(f"tile {tile} does not divide slot_ch {slot_ch}")
    Cp, G = oe.shape
    C = Cp - 1
    # segment sums as reshaped sums, in a fixed order: the same bits at
    # every run (an index_add_ on a card adds in no fixed order)
    per_tile = slot_ch // tile
    oe = torch.nn.functional.pad(oe[:C], (0, max(0, S * per_tile - G)))
    on = oe[:, : S * per_tile].reshape(C, S, per_tile).sum(-1).T / slot_ch

    n_k = pe.shape[1]
    per_slot = slot_ch // PROBE_STRIDE
    Sp = min(S, n_k // per_slot)
    off = pe[1:C + 1, : Sp * per_slot].reshape(C, Sp, per_slot).sum(-1).T
    off = off / per_slot
    if Sp < S:
        off = torch.cat([off, off[-1:].expand(S - Sp, C)], 0)
    off = off * kappa
    return 10.0 * (torch.log10(torch.clamp(on, min=1e-30)) -
                   torch.log10(torch.clamp(off, min=1e-30)))


TF = 50            # frames per tile (csrc/pfb_snr.cu TF); divides slot_ch


def branch_fir(xp, h0, h1):
    """The branch FIRs of pfb_channelize_plain: (2, D, n_x) branch rows ->
    u (2, M, n), n = n_x - 2Q; branch d < D takes h0 at frame offsets
    2q, branch D + d takes h1 at offsets 2q + 1."""
    Q, D = h0.shape
    n = xp.shape[2] - 2 * Q
    v0 = torch.zeros((2, D, n), dtype=torch.float32, device=xp.device)
    v1 = torch.zeros_like(v0)
    for q in range(Q):
        v0 = v0 + xp[:, :, 2 * q: 2 * q + n] * h0[q][None, :, None]
        v1 = v1 + xp[:, :, 2 * q + 1: 2 * q + 1 + n] * h1[q][None, :, None]
    return torch.cat([v0, v1], dim=1)


def pfb_channelize_plain(xp, h0, h1, dft_c, dft_s, bin_odd):
    """Plain PyTorch version of pfb_channelize (same arguments and
    results): gr_bluetooth_tpu/ops/pfb.py:_pfb_impl's flat formulation,
    Q shifted multiply-adds along frames, then the DFT as FP32 matmuls
    (whatever the caller's TF32 setting)."""
    n = xp.shape[2] - 2 * h0.shape[0]
    u = branch_fir(xp, h0, h1)                         # (2, M, n)
    with fp32_matmul():
        yr = dft_c.T @ u[0] + dft_s.T @ u[1]           # (C, n)
        yi = dft_c.T @ u[1] - dft_s.T @ u[0]
    odd = (torch.arange(n, device=xp.device) & 1).to(torch.float32)
    sign = 1.0 - 2.0 * (bin_odd[:, None] * odd[None, :])
    return (yr * sign).contiguous(), (yi * sign).contiguous()


def pfb_snr_plain(x, h0, h1, dft_c, dft_s, bin_odd, n_frames: int):
    """Plain PyTorch version of pfb_snr (same arguments and results):
    pfb_channelize_plain over the branch rows of the flat planes, zero
    frames past the data, then the per-tile energies."""
    Q, D = h0.shape
    n_x = x.shape[1] // D
    xp = x[:, : n_x * D].reshape(2, n_x, D).transpose(1, 2)
    # n_frames outputs read n_frames + 2Q - 1 input frames
    xp = torch.nn.functional.pad(xp, (0, max(0, n_frames + 2 * Q - n_x)))
    yr, yi = pfb_channelize_plain(xp[:, :, : n_frames + 2 * Q], h0, h1,
                                  dft_c, dft_s, bin_odd)
    C = yr.shape[0]
    oe = (yr * yr + yi * yi).reshape(C, n_frames // TF, TF).sum(-1)
    return yr, yi, oe


GROUP = 512                    # symbols per timing group


GROUP_FRAMES = 2 * GROUP       # frames per group (2 samples/symbol)


def atan2_poly(y, x):
    """Branch-free float32 atan2: octant reduction + the Cephes atanf
    minimax polynomial, operation for operation the JAX package's
    ops/demod_kernel.py:atan2_poly (so the slicer's bits match it)."""
    ax, ay = x.abs(), y.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    q = num / torch.where(den == 0.0, torch.ones_like(den), den)
    big = q > 0.4142135624                             # tan(pi/8)
    t = torch.where(big, (q - 1.0) / (q + 1.0), q)
    z = t * t
    p = ((((8.05374449538e-2 * z - 1.38776856032e-1) * z
           + 1.99777106478e-1) * z - 3.33329491539e-1) * z * t + t)
    r = torch.where(big, 0.78539816339744831 + p, p)   # atan(q)
    r = torch.where(swap, 1.5707963267948966 - r, r)   # atan(ay/ax)
    r = torch.where(x < 0.0, 3.14159265358979 - r, r)
    return torch.where(y < 0.0, -r, r)


def n_groups(n_sym: int, n_k: int) -> int:
    """Groups a demod_pack launch covers: every symbol and every probe
    grid point k < n_k."""
    g = -(-n_sym // GROUP)
    if n_k > 0:
        g = max(g, PROBE_STRIDE * (n_k - 1) // GROUP_FRAMES + 1)
    return g


def _zero_extend(y, width: int):
    if y.shape[1] >= width:
        return y[:, :width]
    return torch.nn.functional.pad(y, (0, width - y.shape[1]))


def demod_pack_plain(yr, yi, gain: float, n_sym: int, taps_re, taps_im,
                     n_k: int, n_data_groups: int | None = None):
    """Plain PyTorch version of demod_pack (same arguments and results);
    its probe products are FP32 matmuls whatever the caller's TF32
    setting."""
    C, F = yr.shape
    dev = yr.device
    n_t = n_groups(n_sym, n_k)
    if n_data_groups is None:
        n_data_groups = -(-F // GROUP_FRAMES)
    T = taps_re.shape[0]
    width = max(n_t * GROUP_FRAMES + 2, PROBE_STRIDE * max(n_k - 1, 0) + T)
    wr, wi = _zero_extend(yr, width), _zero_extend(yi, width)

    Wr = wr.unfold(1, GROUP_FRAMES + 2, GROUP_FRAMES)[:, :n_t]
    Wi = wi.unfold(1, GROUP_FRAMES + 2, GROUP_FRAMES)[:, :n_t]
    pr = Wr[..., 1:] * Wr[..., :-1] + Wi[..., 1:] * Wi[..., :-1]
    pim = Wi[..., 1:] * Wr[..., :-1] - Wr[..., 1:] * Wi[..., :-1]
    d = gain * atan2_poly(pim, pr)                     # (C, n_t, 1025)
    de = d[..., 0:GROUP_FRAMES:2]                      # d[2s]
    dd = d[..., 1:GROUP_FRAMES:2]                      # d[2s+1]
    de1 = d[..., 2:GROUP_FRAMES + 1:2]                 # d[2s+2]

    t = torch.arange(n_t, device=dev)
    nvalid = (n_sym - GROUP * t).clamp(0, GROUP)
    valid = torch.arange(GROUP, device=dev)[None, :] < nvalid[:, None]
    cols = []
    for a, b in ((de, dd), (dd, de1)):
        for p8 in range(8):
            u = (a * (1.0 - p8 / 8.0) + b * (p8 / 8.0)).abs()
            cols.append(torch.where(valid, u, 0.0).sum(-1))
    best = torch.stack(cols, -1).argmax(-1, keepdim=True)  # (C, n_t, 1)
    fb = (best % 8).to(torch.float32) / 8.0
    soft = torch.where(best >= 8, dd * (1.0 - fb) + de1 * fb,
                       de * (1.0 - fb) + dd * fb)
    bits = (soft >= 0) | (t >= n_data_groups)[None, :, None]
    bits = bits.reshape(C, n_t * GROUP)
    sym = torch.arange(n_t * GROUP, device=dev)
    bits = bits & (sym < n_sym)[None, :]
    words = pack_bits_words(bits)[:, : -(-n_sym // 32)]

    P_r = wr[:, : PROBE_STRIDE * (n_k - 1) + T].unfold(1, T, PROBE_STRIDE)
    P_i = wi[:, : PROBE_STRIDE * (n_k - 1) + T].unfold(1, T, PROBE_STRIDE)
    with fp32_matmul():
        rr, ri = P_r @ taps_re, P_r @ taps_im
        ir, ii = P_i @ taps_re, P_i @ taps_im
    pe = (rr - ii) ** 2 + (ri + ir) ** 2               # (C, n_k)
    k_group = PROBE_STRIDE * torch.arange(n_k, device=dev) // GROUP_FRAMES
    pe = torch.where((k_group < n_data_groups)[None, :], pe, 0.0)
    return words.contiguous(), pe.contiguous()


_A, _C = access_code.affine_code()


A68 = _A[:68].astype(np.int32)                    # (68, 24) 0/1


C68V = _C[:68].astype(np.int32)                   # (68,)


_PRE = 0x15        # symbols 0..4 = 1,0,1,0,1


_BARK = 0x27       # symbols 61..67 = 1,1,1,0,0,1,0


_M32 = 0xFFFFFFFF


N_ERR = 7          # error-count planes: counts 0..68


def ac_masks(a68=A68, c68v=C68V) -> np.ndarray:
    """The affine AC map as 68-bit masks, three uint32 words each (stored
    as int32): columns k of A68 at [3k, 3k+3), C68 at [72, 75)."""
    def mask(bits):
        v = sum(int(b) << j for j, b in enumerate(np.asarray(bits)[:68]))
        return [(v >> (32 * i)) & _M32 for i in range(3)]
    a68 = np.asarray(a68)
    out = []
    for k in range(24):
        out += mask(a68[:, k] & 1)
    out += mask(np.asarray(c68v) & 1)
    return np.array(out, np.uint32).view(np.int32)


def u32_to_i32(x):
    """int64 tensor of uint32 values -> int32 tensor, same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def pack_bits_words(bits):
    """(C, T) {0,1} -> (C, ceil(T/32)) int32; symbol t sits at word t//32
    bit t%32 (byte-compatible with np.unpackbits(bitorder='little'))."""
    C, T = bits.shape
    nw = -(-T // 32)
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, nw * 32 - T))
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return u32_to_i32((b.reshape(C, nw, 32) << sh).sum(-1))


def popcount(x):
    """Popcount of int64 tensors holding values < 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def ac_errors(v0, v1, v2, masks):
    """68-symbol windows as three uint32 words in int64 tensors (symbols
    0-31, 32-63, 64-67) -> (lap, err): the LAP bits (symbols 38..61) and
    the mismatches against the access code those bits predict."""
    m = masks.to(torch.int64) & _M32
    lap = (v1 >> 6) & 0xFFFFFF
    p0, p1, p2 = m[72], m[73], m[74]
    for k in range(24):
        sel = -((lap >> k) & 1) & _M32
        p0 = p0 ^ (m[3 * k] & sel)
        p1 = p1 ^ (m[3 * k + 1] & sel)
        p2 = p2 ^ (m[3 * k + 2] & sel)
    err = popcount(v0 ^ p0) + popcount(v1 ^ p1) + popcount((v2 ^ p2) & 0xF)
    return lap, err


def detect_words_plain(words, n: int, max_ac_errors: int, masks,
                       emit_err: bool = False):
    """Plain PyTorch version of detect_words (same arguments/results)."""
    C, W = words.shape
    dev = words.device
    n_words = -(-n // 32)
    w = words.to(torch.int64) & _M32
    w = torch.nn.functional.pad(w, (0, max(0, n_words + 3 - W)))
    o = torch.arange(n_words * 32, device=dev)
    q, r = o >> 5, o & 31

    def view(i):                         # symbols o+32i .. o+32i+31
        two = (w[:, q + i + 1] << 32) | w[:, q + i]
        return (two >> r) & _M32

    v0, v1, v2 = view(0), view(1), view(2) & 0xF
    _, err = ac_errors(v0, v1, v2, masks)
    dp = popcount((v0 ^ _PRE) & 0x1F)
    db = popcount((((v1 >> 29) | (v2 << 3)) & 0x7F) ^ _BARK)
    gate = (torch.minimum(dp, 5 - dp) + torch.minimum(db, 7 - db) <= 2)
    gate = gate & (o < n)[None, :]
    hit = gate & (err <= max_ac_errors)
    planes = None
    if emit_err:
        planes = torch.stack([pack_bits_words((err >> b) & 1)
                              for b in range(N_ERR)])
    return pack_bits_words(hit), pack_bits_words(gate), planes


def unpack_words(w, n: int):
    """(..., W) int32 packed planes -> (..., n) int32 0/1 bits."""
    b = (w.to(torch.int64)[..., None] >>
         torch.arange(32, device=w.device)) & 1
    return b.reshape(*w.shape[:-1], -1)[..., :n].to(torch.int32)


LE_SPAN = 56       # symbols an offset reads: preamble, AA, header


def _le_dewhiten_header_bits(index: int) -> np.ndarray:
    """Whitening word covering symbols 40..55 (the 16 header bits)."""
    return whitening.le_whitening_word(index, 16, skip=0).astype(np.float32)


def le_row_consts(indices) -> tuple:
    """Per-row constants for le_detect_batch: (white (R,16) float32,
    aa_on (R,1) float32, max_dist (R,1) int32) for LE channel indices."""
    white = np.stack([_le_dewhiten_header_bits(i) for i in indices])
    aa_on = np.array([[1.0 if i >= 37 else 0.0] for i in indices],
                     dtype=np.float32)
    max_dist = np.array([[2 if i >= 37 else 0] for i in indices],
                        dtype=np.int32)
    return white.astype(np.float32), aa_on, max_dist


def le_white_words(white) -> np.ndarray:
    """(R, 16) 0/1 whitening bits (le_row_consts) -> (R,) int32, bit j =
    white[:, j]: le_detect's per-row whitening word."""
    w = np.asarray(white).astype(np.int64) & 1
    return (w << np.arange(16)).sum(1).astype(np.int32)


def le_table_consts() -> dict:
    """The distance tables as uint8 arrays (their type at the source),
    keyed as the step takes them: le_pre_dist (512,), le_aa_dist
    (4, 256), le_acc_dist and le_dat_dist (2, 256) (header byte 0,
    byte 1)."""
    return dict(le_pre_dist=LE_PREAMBLE_DISTANCE.astype(np.uint8),
                le_aa_dist=AA_DISTANCE.astype(np.uint8),
                le_acc_dist=np.stack(ACCESS_HEADER_DISTANCE).astype(np.uint8),
                le_dat_dist=np.stack(DATA_HEADER_DISTANCE).astype(np.uint8))


def le_detect_batch(bits, white, aa_on, max_dist, *, le_pre_dist,
                    le_aa_dist, le_acc_dist, le_dat_dist):
    """All LE rows at once.

    bits: (R, T) 0/1 symbols (any real or integer dtype); white (R, 16),
    aa_on (R, 1), max_dist (R, 1) from le_row_consts; the tables from
    le_table_consts, on the same device.  Returns (hits bool, dist int32),
    each (R, T-55)."""
    R, T = bits.shape
    n = T - 56 + 1
    b = bits.to(torch.int64)
    w = white.to(torch.int64)
    le_pre_dist, le_aa_dist, le_acc_dist, le_dat_dist = (
        t.to(torch.int32) for t in (le_pre_dist, le_aa_dist, le_acc_dist,
                                    le_dat_dist))

    def field(start, nbits, dewhiten_from=None):
        v = torch.zeros((R, n), dtype=torch.int64, device=b.device)
        for j in range(nbits):
            bj = b[:, start + j: start + j + n]
            if dewhiten_from is not None:
                bj = bj ^ w[:, dewhiten_from + j, None]
            v = v + (bj << j)
        return v

    pre_d = le_pre_dist[field(0, 9)]
    hdr_l = field(40, 8, dewhiten_from=0)
    hdr_m = field(48, 8, dewhiten_from=8)
    acc_d = le_acc_dist[0][hdr_l] + le_acc_dist[1][hdr_m]
    dat_d = le_dat_dist[0][hdr_l] + le_dat_dist[1][hdr_m]
    adv = aa_on > 0.5
    hdr_d = torch.where(adv, acc_d, dat_d)
    aa_d = torch.zeros_like(pre_d)
    for k in range(4):
        aa_d = aa_d + le_aa_dist[k][field(8 + 8 * k, 8)]
    dist = pre_d + hdr_d + torch.where(adv, aa_d, 0)
    return dist <= max_dist, dist


def le_detect_plain(words, rows, n_sym: int, white_word, aa_on, max_dist,
                    *, with_dist: bool = True, le_pre_dist, le_aa_dist,
                    le_acc_dist, le_dat_dist):
    """Plain PyTorch version of le_detect (same arguments and results):
    the rows unpacked to dense symbols, le_detect_batch, the hits
    packed."""
    bits = unpack_words(words[rows], n_sym)
    white = (white_word[:, None] >>
             torch.arange(16, device=words.device)) & 1
    hits, dist = le_detect_batch(
        bits, white, aa_on, max_dist, le_pre_dist=le_pre_dist,
        le_aa_dist=le_aa_dist, le_acc_dist=le_acc_dist,
        le_dat_dist=le_dat_dist)
    return pack_bits_words(hits), (dist if with_dist else None)


WIN_SYMBOLS = 3200       # per-hit symbol window (>= 3125)


LE_WIN_SYMBOLS = 512     # per-LE-hit window (>= 376 + header margin)


LE_TABLES = ("le_pre_dist", "le_aa_dist", "le_acc_dist", "le_dat_dist")


def _extract_hits_packed(hitw, max_hits: int):
    """Bit-packed (C, W) int32 hit plane -> the first max_hits set bits
    in channel-major order, with no host sync: an inclusive prefix sum
    of the word popcounts places rank r in its word (searchsorted), and
    a prefix sum over that word's 32 bits places it in the word.

    Returns (count, chan, off, valid); count is the total popcount, which
    may exceed max_hits; rows r >= count are not valid."""
    C, W = hitw.shape
    dev = hitw.device
    flat = hitw.reshape(-1).to(torch.int64) & _M32
    pc = popcount(flat)
    cum = torch.cumsum(pc, 0)
    count = cum[-1]
    r = torch.arange(max_hits, device=dev)
    widx = torch.searchsorted(cum, r, right=True).clamp(max=flat.numel() - 1)
    rank = r - (cum[widx] - pc[widx])                 # rank inside the word
    bits = (flat[widx][:, None] >> torch.arange(32, device=dev)) & 1
    before = torch.cumsum(bits, 1) - bits             # set bits below each
    b = ((bits == 1) & (before == rank[:, None])).to(torch.int32).argmax(1)
    idx = widx * 32 + b
    valid = r < count
    nbits = W * 32
    return count, idx // nbits, idx % nbits, valid


def _squelch_gate_words(snr_db, word_s0, word_mask_a, squelch: float):
    """Packed per-offset squelch gate: (S, C) slot SNR -> (C, W) int32
    word planes to AND with the packed hit plane.  Word w's low `mask_a`
    bits sit in slot s0[w], the rest in s0[w]+1; slot S mirrors S-1."""
    S, C = snr_db.shape
    g = snr_db.T >= squelch                            # (C, S)
    g = torch.cat([g, g[:, -1:]], 1)                   # slot S mirrors S-1
    g0 = g[:, word_s0.clamp(max=S)]
    g1 = g[:, (word_s0 + 1).clamp(max=S)]
    ma = word_mask_a[None, :]
    return torch.where(g0, ma, 0) | torch.where(g1, ~ma, 0)


def _gather_windows(words, chan, off, valid, width_bits: int):
    """(K,) channel/bit-offset -> (K, width_bits//32 + 1) int32 packed
    symbol windows, BIT-ALIGNED to each hit's offset (bit b of word j is
    the symbol at off + 32*j + b; words past the row read as zero, and
    the last word's high bits are zero).  Rows that are not valid are
    all zero."""
    C, nw = words.shape
    ww = width_bits // 32 + 1
    dev = words.device
    c = chan.clamp(0, C - 1)
    ow = (off // 32).clamp(0, nw - 1)
    idx = ow[:, None] + torch.arange(ww, device=dev)[None, :]
    src = words.to(torch.int64) & _M32
    u = src[c[:, None], idx.clamp(max=nw - 1)]
    u = torch.where((idx < nw) & valid[:, None], u, 0)
    nxt = torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], 1)
    s = torch.where(valid, off % 32, 0)[:, None]
    return u32_to_i32((u >> s) | ((nxt << (32 - s)) & _M32))


def _hit_rows(windows, chan, off, valid, ac_a68t, ac_c68):
    """The classic hit table (K, 4) int32 [chan, offset, LAP, errors], -1
    on rows that are not valid, from the hits' bit-aligned windows
    (gr_bluetooth_tpu/models/frontend.py:764-776 and :793-796): the LAP
    is symbols 38..61 = window word 1 bits 6..29, the error count the
    mismatches of the 68 bits with the access code that the LAP bits
    predict, A68 lap + C68 mod 2, as one float32 product (0/1 values and
    sums of at most 25: exact at any float32 precision, run in FP32 all
    the same)."""
    b = (windows[:, :3, None] >> torch.arange(32, device=windows.device)) & 1
    bits68 = b.reshape(-1, 96)[:, :68].to(torch.float32)
    with fp32_matmul():
        pred = torch.addmm(ac_c68, bits68[:, 38:62], ac_a68t)
    err = (bits68 != torch.remainder(pred, 2.0)).sum(1)
    lap = (windows[:, 1] >> 6) & 0xFFFFFF
    return torch.where(valid[:, None],
                       torch.stack([chan, off, lap, err], 1),
                       -1).to(torch.int32)


def _le_rows(windows, chan, off, valid, le_white_word, le_aa_on, tables):
    """The LE hit table (K, 3) int32 [row, offset, distance], -1 on rows
    that are not valid: the distance of each hit's window, whose first
    56 symbols are the ones the LE detector reads at the hit
    (le_detect_batch on them, with the hit row's constants)."""
    dev = windows.device
    b = (windows[:, :2, None].to(torch.int64) >>
         torch.arange(32, device=dev)) & 1
    bits = b.reshape(-1, 64)[:, :56]
    white = (le_white_word[chan, None] >> torch.arange(16, device=dev)) & 1
    _, d = le_detect_batch(bits, white, le_aa_on[chan],
                           torch.zeros_like(le_aa_on[chan],
                                            dtype=torch.int32), **tables)
    return torch.where(valid[:, None],
                       torch.stack([chan, off, d[:, 0].to(chan.dtype)], 1),
                       -1).to(torch.int32)


def hit_table_plain(hitw, words, rows, snr_db, *, word_s0, word_mask_a,
                    squelch, max_hits: int, ac=None, le=None):
    """Plain PyTorch version of hit_table (same arguments and results)."""
    if squelch is not None:
        cols = snr_db if rows is None else snr_db[:, rows]
        hitw = hitw & _squelch_gate_words(cols, word_s0, word_mask_a,
                                          squelch)
    count, chan, off, valid = _extract_hits_packed(hitw, max_hits)
    src = chan if rows is None else rows[chan]
    if le is None:
        windows = _gather_windows(words, src, off, valid, WIN_SYMBOLS)
        tab = _hit_rows(windows, chan, off, valid, ac["ac_a68t"],
                        ac["ac_c68"])
    else:
        windows = _gather_windows(words, src, off, valid, LE_WIN_SYMBOLS)
        tab = _le_rows(windows, chan, off, valid, le["le_white_word"],
                       le["le_aa_on"], {k: le[k] for k in LE_TABLES})
    return count.to(torch.int32), tab, windows


LOOKAHEAD_SLOTS = 5      # max packet length


def _word_slot_consts(n_words: int, delay_sym: int):
    """Static per-word slot indices + intra-word slot-boundary masks for
    _squelch_gate_words."""
    w = np.arange(n_words, dtype=np.int64)
    first = 32 * w + delay_sym                     # offset+delay of bit 0
    s0 = first // SYMBOLS_PER_SLOT
    boundary = (s0 + 1) * SYMBOLS_PER_SLOT - first  # bits before next slot
    bp = np.clip(boundary, 0, 32)
    mask_a = np.where(bp >= 32, np.int64(0xFFFFFFFF), (1 << bp) - 1)
    return (s0.astype(np.int32),
            mask_a.astype(np.int64).astype(np.uint32).view(np.int32))


def ac_product_consts(a68=A68, c68v=C68V):
    """The affine access-code map as the hit rows' float32 product takes
    it: ac_a68t (24, 68) = A68 transposed, ac_c68 (68,) = C68."""
    return dict(ac_a68t=np.ascontiguousarray(
                    (np.asarray(a68)[:68] & 1).T.astype(np.float32)),
                ac_c68=(np.asarray(c68v)[:68] & 1).astype(np.float32))


def le_step_consts(white, aa_on, max_dist, *, n_sym: int,
                   delay_sym: int) -> dict:
    """The LE branch's constants besides le_rows, from le_row_consts'
    (white, aa_on, max_dist): the packed whitening words, aa_on and
    max_dist, the squelch word constants for the n_sym - 55 LE offsets
    and the distance tables."""
    s0, ma = _word_slot_consts(-(-(n_sym - LE_SPAN + 1) // 32),
                               delay_sym)
    return dict(le_white_word=le_white_words(white), le_aa_on=aa_on,
                le_max_dist=max_dist, le_word_s0=s0, le_word_mask_a=ma,
                **le_table_consts())


def step_geometry(n_samples: int, Q: int, decim: int, n_sym: int,
                  slot_ch: int, taps_len: int):
    """Sizes of one block's step: (n, n_data, S, n_k, n_frames).

    n true channel frames (frame j reads input frames j .. j+2Q-1);
    n_data demod groups that start inside them (later groups give
    all-ones words, as the TPU megakernel's tiles past the data do);
    S slots; n_k probe grid points; n_frames channel frames pfb_snr
    computes, from zeros past the data: enough for every data group's
    window and every slot, rounded up to whole tiles."""
    G = GROUP_FRAMES
    n = n_samples // decim - 2 * Q
    n_data = -(-n // G)
    S = n // slot_ch
    n_k = probe_points(S, slot_ch, taps_len)
    n_t = n_groups(n_sym, n_k)
    need = max(G * min(n_data, n_t) + 2, S * slot_ch)
    n_frames = -(-need // TF) * TF
    return n, n_data, S, n_k, n_frames
