"""detect_words: bit-packed classic access-code detection.

The port of gr_bluetooth_tpu/ops/detect_pallas.py (detect_words over the
_planes_padded Pallas kernel, and pack_bits_words).  Words hold 32
symbols each (bit b of word j is symbol 32j + b).  For every candidate
offset o < n, with v_j the symbol at o + j (zero past the words):

    err  = #{j < 68 : v_j != (A68 v[38:62] + C68)_j mod 2}
    gate = min(dp, 5 - dp) + min(db, 7 - db) <= 2, dp/db the mismatches
           of v[0:5] with 10101 and of v[61:68] with 1110010
    hit  = gate & (err <= max_ac_errors)

returned as packed (C, ceil(n/32)) int32 hit and gate planes with bits
at offsets >= n zeroed (the reference's sniff_ac rule,
lib/packet_impl.cc:246-268), and with emit_err the 7 bit-sliced planes
of err (w1 ... w64, LSB first) as a (7, C, ceil(n/32)) tensor.  The error
planes are not masked past n, as the JAX kernel's are not: there they
hold the count of the window read with zeros past the words' end.

gated_error and classic_detect_words are the dense entry points over the
error planes (gr_bluetooth_tpu/ops/detect_pallas.py:gated_error and
classic_detect_pallas).

CUDA kernel: csrc/detect_words.cu, with A68/C68 compiled in
(csrc/ac_table.cuh); on a CUDA tensor the masks must equal ac_masks().
The plain PyTorch version below runs for CPU tensors and is the kernel's
yardstick on the card; it works in int64 because torch has no popcount
and no logical shift on int32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import access_code
from ..utils import cuda_build

__all__ = ["ac_errors", "ac_masks", "classic_detect_words", "detect_words",
           "detect_words_plain", "gated_error", "pack_bits_words",
           "popcount", "u32_to_i32", "unpack_words", "A68", "C68V", "BIG",
           "N_ERR"]

_A, _C = access_code.affine_code()
A68 = _A[:68].astype(np.int32)                    # (68, 24) 0/1
C68V = _C[:68].astype(np.int32)                   # (68,)
_PRE = 0x15        # symbols 0..4 = 1,0,1,0,1
_BARK = 0x27       # symbols 61..67 = 1,1,1,0,0,1,0
_M32 = 0xFFFFFFFF
N_ERR = 7          # error-count planes: counts 0..68
BIG = 1 << 20      # gated_error's mark where the prefilter rejects


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


def _launcher():
    fn = cuda_build.load("detect_words").detect_words_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_masks(masks):
    """The kernel has the map compiled in, so the masks it is handed must
    be ac_masks().  Compared once per tensor and version (one device
    sync), remembered on the tensor."""
    if getattr(masks, "_ac_masks_version", None) == masks._version:
        return
    if not torch.equal(masks.cpu(), torch.from_numpy(ac_masks())):
        raise ValueError("detect_words: the CUDA kernel has the access-code "
                         "map of ac_masks() compiled in; these masks differ")
    masks._ac_masks_version = masks._version


def detect_words(words, n: int, max_ac_errors: int, masks,
                 emit_err: bool = False):
    """words (C, W) int32 packed symbol streams, n candidate offsets,
    masks = ac_masks() as an int32 tensor on the words' device ->
    (hit, gate, err): packed (C, ceil(n/32)) int32 hit and gate planes
    and, with emit_err, the (7, C, ceil(n/32)) error-count planes (else
    None).  A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/detect_words.cu, counted in detect_words.launches (hit and gate
    only, the modes' path) or detect_words.err_launches (emit_err), and
    raises if the masks are not ac_masks()."""
    if words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError("detect_words: words must be (C, W) int32")
    if masks.dtype != torch.int32 or masks.shape != (75,) or \
            masks.device != words.device:
        raise ValueError("detect_words: masks must be ac_masks() as int32 "
                         "on the words' device")
    if n <= 0:
        raise ValueError("detect_words: need at least one offset")
    if words.device.type == "cpu":
        return detect_words_plain(words, n, max_ac_errors, masks, emit_err)
    if words.device.type != "cuda":
        raise ValueError(f"detect_words: unsupported device {words.device}")
    _check_masks(masks)
    C, W = words.shape
    words = words.contiguous()
    n_words = -(-n // 32)
    planes = torch.empty((2 + N_ERR if emit_err else 2, C, n_words),
                         dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _launcher()(words.data_ptr(), C, W, n, int(max_ac_errors),
                         planes.data_ptr(), n_words, int(emit_err), stream)
    cuda_build.check(rc, "detect_words")
    if emit_err:
        detect_words.err_launches += 1
        return planes[0], planes[1], planes[2:]
    detect_words.launches += 1
    return planes[0], planes[1], None


detect_words.launches = 0
detect_words.err_launches = 0


def unpack_words(w, n: int):
    """(..., W) int32 packed planes -> (..., n) int32 0/1 bits."""
    b = (w.to(torch.int64)[..., None] >>
         torch.arange(32, device=w.device)) & 1
    return b.reshape(*w.shape[:-1], -1)[..., :n].to(torch.int32)


def gated_error(bits):
    """bits (C, T) {0,1}, any real dtype -> (C, T-71) int32 gated AC
    error counts, BIG where the preamble/Barker prefilter rejects.

    The port of gr_bluetooth_tpu/ops/detect_pallas.py:gated_error: packs
    the bits to words, runs detect_words with emit_err on their device,
    and unpacks the gate and error planes.  The modes' path calls
    detect_words on packed streams instead."""
    C, T = bits.shape
    n = T - 72 + 1
    if n <= 0:
        raise ValueError("block shorter than one access code")
    masks = torch.from_numpy(ac_masks()).to(bits.device)
    _, gate, err = detect_words(pack_bits_words(bits), n, 68, masks,
                                emit_err=True)
    e = (unpack_words(err, n) <<
         torch.arange(N_ERR, dtype=torch.int32,
                      device=bits.device)[:, None, None]).sum(0)
    return torch.where(unpack_words(gate, n) > 0, e,
                       BIG).to(torch.int32)


def classic_detect_words(bits, max_ac_errors: int = 6):
    """Dense classic detection, (C, T) {0,1} -> (hits bool, err int32),
    both (C, T-71); err is 0 where the prefilter rejects.  The port of
    gr_bluetooth_tpu/ops/detect_pallas.py:classic_detect_pallas, the
    drop-in for detect._classic_detect_impl."""
    g = gated_error(bits)
    return g <= max_ac_errors, torch.where(g >= BIG, 0, g)
