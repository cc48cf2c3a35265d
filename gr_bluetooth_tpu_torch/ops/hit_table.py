"""hit_table: a packed hit plane -> the step's fixed-size hit table.

The port of the step's tail after detection
(gr_bluetooth_tpu/models/frontend.py:750-808, plain jnp in the JAX
package): the packed squelch gate, first-k extraction, the bit-aligned
window gather and the table rows, for the classic access-code hits and
for the LE access-address hits.  For every row r of a packed (R, w) hit
plane (bit t of word j = offset 32 j + t), with `rows` mapping r to its
SNR column and its row of the (C, W) symbol word plane (None: r
itself):

  1. gate: word j of row r keeps the bits of the slots whose SNR is at
     least `squelch` (float32): its low word_mask_a[j] bits sit in slot
     word_s0[j], the rest in the next one, and slot S mirrors S - 1
     (no gate when squelch is None);
  2. count every set bit after the gate (the count may exceed max_hits);
  3. take the first max_hits set bits in row-major order;
  4. gather each hit's symbol window bit-aligned from its word row
     (WIN_SYMBOLS classic, LE_WIN_SYMBOLS LE; words past the row read as
     zero);
  5. write the rows, -1 on rows past the count:
       classic [r, offset, LAP, errors]: the LAP = window bits 38..61,
               the errors the mismatches of the window's 68 bits with
               the access code that the LAP predicts (A68 lap + C68);
       LE      [r, offset, distance]: the LE detector's distance at the
               hit (ops/detect.py's tables).

Returns (count int32 0-d, tab (max_hits, 4 or 3) int32, windows
(max_hits, width // 32 + 1) int32), all of static shape with no host
sync, so the step stays capturable as a CUDA graph.

hit_tables(classic, le) computes a step's two tails, each as hit_table
would, in one launch.

A CPU tensor runs the plain version, hit_table_plain: the torch
composition the step ran before the kernel (_squelch_gate_words,
_extract_hits_packed, _gather_windows, _hit_rows; the LE distance from
le_detect_batch on the window's first 56 symbols).  A CUDA tensor
launches csrc/hit_table.cu, one thread-block cluster of CLUSTER blocks
per tail, which splits the plane as cluster_split says and exchanges
its blocks' counts through distributed shared memory; a tail is counted in hit_table.launches (classic) or hit_table.le_launches
(LE).  A launch the card refuses raises; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import cuda_build
from ..utils.device import fp32_matmul
from .detect import le_detect_batch
from .detect_kernel import popcount, u32_to_i32

__all__ = ["hit_table", "hit_tables", "hit_table_plain", "cluster_split",
           "WIN_SYMBOLS", "LE_WIN_SYMBOLS", "LE_TABLES", "CLUSTER",
           "THREADS"]

WIN_SYMBOLS = 3200       # per-hit symbol window (>= 3125)
LE_WIN_SYMBOLS = 512     # per-LE-hit window (>= 376 + header margin)
LE_TABLES = ("le_pre_dist", "le_aa_dist", "le_acc_dist", "le_dat_dist")
_M32 = 0xFFFFFFFF
THREADS = 1024           # threads per block of csrc/hit_table.cu
CLUSTER = 16             # blocks per tail's cluster (its CLUSTER)


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


def _check(hitw, words, rows, snr_db, word_s0, word_mask_a, squelch,
           max_hits, ac, le):
    if hitw.dtype != torch.int32 or hitw.ndim != 2 or \
            words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError("hit_table: hitw (R, w) and words (C, W) must be "
                        "int32")
    if (ac is None) == (le is None):
        raise ValueError("hit_table: give one epilogue, ac= or le=")
    R, w = hitw.shape
    if w > words.shape[1] or R * w * 32 >= 1 << 31 or max_hits < 1:
        raise ValueError(f"hit_table: a ({R}, {w}) plane over "
                         f"{tuple(words.shape)} words and max_hits "
                         f"{max_hits} are not supported")
    want = dict(word_s0=(word_s0, torch.int64, (w,)),
                word_mask_a=(word_mask_a, torch.int32, (w,)))
    if rows is not None:
        want["rows"] = (rows, torch.int64, (R,))
    if squelch is not None:
        n_cols = R if rows is None else snr_db.shape[1]
        want["snr_db"] = (snr_db, torch.float32, (snr_db.shape[0], n_cols))
        if snr_db.shape[0] < 1:
            raise ValueError("hit_table: snr_db has no slot")
    if ac is not None:
        want["ac_a68t"] = (ac["ac_a68t"], torch.float32, (24, 68))
        want["ac_c68"] = (ac["ac_c68"], torch.float32, (68,))
        want["ac_masks"] = (ac["ac_masks"], torch.int32, (75,))
    else:
        want.update(le_white_word=(le["le_white_word"], torch.int32, (R,)),
                    le_aa_on=(le["le_aa_on"], torch.float32, (R, 1)),
                    le_pre_dist=(le["le_pre_dist"], torch.uint8, (512,)),
                    le_aa_dist=(le["le_aa_dist"], torch.uint8, (4, 256)),
                    le_acc_dist=(le["le_acc_dist"], torch.uint8, (2, 256)),
                    le_dat_dist=(le["le_dat_dist"], torch.uint8, (2, 256)))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or \
                t.device != hitw.device:
            raise ValueError(f"hit_table: {name} must be {dtype} of shape "
                             f"{shape} on the plane's device")
    if words.device != hitw.device:
        raise ValueError("hit_table: words must be on the plane's device")
    if hitw.device.type == "cuda" and (
            hitw.data_ptr() % 16 or not all(
                t.is_contiguous() for t in [hitw, words] +
                [t for k, (t, _, _) in want.items() if k != "snr_db"])):
        raise ValueError("hit_table: a CUDA call takes contiguous tensors "
                         "(snr_db any strides) and a 16-byte aligned plane")


def _ptr(t):
    return None if t is None else t.data_ptr()


class Split(NamedTuple):
    """How the cluster's blocks share an n-word plane: block b takes the
    words [b * per, (b + 1) * per), cut at the plane's end (so a block
    may own none)."""
    blocks: int
    per: int

    def block_range(self, b: int, n: int) -> tuple[int, int]:
        lo = min(b * self.per, n)
        return lo, min(lo + self.per, n)


def cluster_split(n_words: int) -> Split:
    """The split of an n-word plane over a tail's cluster, as
    csrc/hit_table.cu takes it: whole 128-byte lines per block."""
    per = -(-max(n_words, 1) // CLUSTER)
    return Split(CLUSTER, -(-per // 32) * 32)


class _Tail(ctypes.Structure):
    """One tail's arguments: the layout of struct Tail in
    csrc/hit_table.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "hitw", "words", "rows", "snr", "s0", "ma", "masks", "white",
        "aa_on", "pre", "aa", "acc", "dat", "count", "tab", "win")] +
        [(k, ctypes.c_int) for k in (
            "R", "w", "W", "S", "Cs", "st_s", "st_c", "use_gate",
            "max_hits", "ww", "per")] + [("squelch", ctypes.c_float)])


def _lib():
    lib = cuda_build.load("hit_table")
    if lib.hit_table_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hit_table_launch.argtypes = [ctypes.POINTER(_Tail), I, P]
        lib.hit_table_launch.restype = I
        lib.hit_table_floor_launch.argtypes = [I, I, P]
        lib.hit_table_floor_launch.restype = I
    return lib


def _tail_args(t: dict):
    """A tail's struct for the kernel and its outputs, allocated."""
    hitw, words, rows, snr_db = t["hitw"], t["words"], t["rows"], t["snr_db"]
    le, ac = t.get("le"), t.get("ac")
    dev = hitw.device
    R, w = hitw.shape
    ww = (WIN_SYMBOLS if le is None else LE_WIN_SYMBOLS) // 32 + 1
    max_hits = t["max_hits"]
    out = (torch.empty((), dtype=torch.int32, device=dev),
           torch.empty((max_hits, 4 if le is None else 3),
                       dtype=torch.int32, device=dev),
           torch.empty((max_hits, ww), dtype=torch.int32, device=dev))
    split = cluster_split(R * w)
    squelch = t["squelch"]
    epi = dict(masks=_ptr(ac["ac_masks"])) if le is None else dict(
        white=_ptr(le["le_white_word"]), aa_on=_ptr(le["le_aa_on"]),
        **{k: _ptr(le[f"le_{k}_dist"]) for k in ("pre", "aa", "acc", "dat")})
    st_s, st_c = snr_db.stride()
    return _Tail(
        hitw=hitw.data_ptr(), words=words.data_ptr(), rows=_ptr(rows),
        snr=snr_db.data_ptr(), s0=t["word_s0"].data_ptr(),
        ma=t["word_mask_a"].data_ptr(), count=out[0].data_ptr(),
        tab=out[1].data_ptr(), win=out[2].data_ptr(), R=R, w=w,
        W=words.shape[1], S=snr_db.shape[0], Cs=snr_db.shape[1],
        st_s=st_s, st_c=st_c, use_gate=int(squelch is not None),
        max_hits=max_hits, ww=ww, per=split.per,
        squelch=0.0 if squelch is None else float(squelch), **epi), out


def _run(tails):
    """hit_table over one or two tails (dicts of its arguments, on one
    device): the plain version per tail on the CPU, one launch of
    csrc/hit_table.cu, a cluster per tail, on a card."""
    for t in tails:
        _check(t["hitw"], t["words"], t["rows"], t["snr_db"],
               t["word_s0"], t["word_mask_a"], t["squelch"], t["max_hits"],
               t.get("ac"), t.get("le"))
    dev = tails[0]["hitw"].device
    if any(t["hitw"].device != dev for t in tails):
        raise ValueError("hit_table: the tails must be on one device")
    if dev.type == "cpu":
        return tuple(hit_table_plain(**t) for t in tails)
    if dev.type != "cuda":
        raise ValueError(f"hit_table: unsupported device {dev}")
    args, outs = zip(*(_tail_args(t) for t in tails))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().hit_table_launch((_Tail * len(args))(*args), len(args),
                                     stream)
    cuda_build.check(rc, "hit_table")
    for t in tails:
        if t.get("le") is None:
            hit_table.launches += 1
        else:
            hit_table.le_launches += 1
    return outs


def hit_table(hitw, words, rows, snr_db, *, word_s0, word_mask_a, squelch,
              max_hits: int, ac=None, le=None):
    """The hit table of a packed hit plane (see the module's notes).

    hitw (R, w) int32 hit plane; words (C, W) int32 symbol words, w <= W;
    rows (R,) int64 (the SNR column and word row of each plane row) or
    None for r itself; snr_db (S, C') float32 slot SNR (C' = R with rows
    None); word_s0 (w,) int64 and word_mask_a (w,) int32 the squelch
    word constants; squelch a float or None; max_hits the table's rows.
    One epilogue: ac = {ac_a68t, ac_c68, ac_masks} (the classic rows;
    ac_masks the same map as 24 LAP-bit masks and C68, three words each,
    ops/detect_kernel.ac_masks) or le = {le_white_word (R,) int32,
    le_aa_on (R, 1) float32, and the four uint8 distance tables of
    ops/detect.le_table_consts}.  All on hitw's device."""
    return _run((dict(hitw=hitw, words=words, rows=rows, snr_db=snr_db,
                      word_s0=word_s0, word_mask_a=word_mask_a,
                      squelch=squelch, max_hits=max_hits, ac=ac, le=le),))[0]


def hit_tables(classic: dict, le: dict):
    """A step's two tails in one launch: `classic` and `le` are
    hit_table's arguments as dicts (the first with ac=, the second with
    le=).  Returns hit_table's (count, tab, windows) of each; counts one
    launch in hit_table.launches and one in hit_table.le_launches, as
    two hit_table calls would."""
    if classic.get("ac") is None or le.get("le") is None:
        raise ValueError("hit_tables: the classic tail takes ac=, the LE "
                         "tail le=")
    return _run((dict(classic, le=None), dict(le, ac=None)))


def launch_floor(shape: int, n_tails: int = 1):
    """Launch csrc/hit_table.cu's empty kernel on the current card: shape
    0 one block of 32 threads, shape 1 hit_table's grid (n_tails
    clusters of CLUSTER blocks of THREADS threads, its two cluster
    barriers).  For timing the launch floor (chip_smoke.py); counts
    nothing."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rc = _lib().hit_table_floor_launch(
        shape, n_tails, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "hit_table_floor")


hit_table.launches = 0
hit_table.le_launches = 0
