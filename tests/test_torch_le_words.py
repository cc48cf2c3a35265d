"""The step's tail on packed words against the JAX package, exactly.

  * the LE detector on the packed word plane (ops/detect.py:le_detect,
    on the CPU its plain version) against _le_detect_batch_impl on the
    unpacked rows: 40 rows, two small n_sym, LE packets planted at the
    rows' ends and across word edges, bits past n_sym random;
  * the packed LE tail (models/frontend.py:_le_tail: n_le, le_tab,
    le_windows) against the JAX step's LE branch
    (gr_bluetooth_tpu/models/frontend.py:797-808), with more hits than
    max_le_hits and slot boundaries of the squelch inside a word;
  * the LE squelch words against the JAX dense gate for several
    (n, delay_sym), the full-band geometry among them;
  * the classic hit rows in the A68 product form (_hit_rows) against
    the JAX step's lap_raw and err (frontend.py:764-776), with all-ones
    LAP bits and rows that are not valid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import detect as jdetect
from gr_bluetooth_tpu_torch.core import access_code
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.ops import detect, detect_kernel
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

INDICES = list(range(40))        # LE channel index per row; 37-39 adv.
SPAN = detect.LE_SPAN


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _frame(index: int, k: int) -> np.ndarray:
    if index >= 37:
        f = jpackets.encode_le_adv(0x8E89BED6, index, k % 7,
                                   bytes(range(8)), crc=False)
    else:
        f = jpackets.encode_le_data(0x50654A3B + k, index, 1 + k % 3,
                                    bytes(range(5)), crc_init=0x555555)
    return f[:SPAN].astype(np.int64)


def _pack(bits: np.ndarray) -> np.ndarray:
    """(C, 32 W) 0/1 -> (C, W) int32, symbol t at bit t % 32 of word
    t // 32."""
    return np.packbits(bits.astype(np.uint8), axis=1,
                       bitorder="little").view("<u4").view(np.int32)


def _planted_words(seed: int, n_sym: int, C: int = 45, flips=True):
    """A (C, W) word plane of random symbols (random past n_sym too),
    the 40 LE rows a random choice of its rows, and on each LE row an LE
    frame at the last offset (n_sym - 56) and one across a word edge;
    on some rows one or three symbols of the AA flipped."""
    r = np.random.default_rng(seed)
    W = -(-n_sym // 32) + 1
    bits = r.integers(0, 2, (C, 32 * W))
    rows = r.permutation(C)[:len(INDICES)]
    n_le = n_sym - SPAN + 1
    for j, (row, index) in enumerate(zip(rows, INDICES)):
        edge = 32 * (1 + j % 4) + (j % 3) - 1          # 31, 64, 97, ...
        for k, off in enumerate((edge, n_le - 1)):
            f = _frame(index, 2 * j + k)
            if flips and j % 5 == 1:
                f[8 + j % 32] ^= 1
            if flips and j % 5 == 2:
                f[[9, 20, 33]] ^= 1
            bits[row, off: off + SPAN] = f
    return bits, _pack(bits), rows


def _tables():
    return {k: _t(v) for k, v in detect.le_table_consts().items()}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("n_sym", [700, 1283])
def test_le_detect_on_words_matches_jax(n_sym, seed):
    bits, words, rows = _planted_words(seed, n_sym)
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    hj, dj = (np.asarray(a) for a in jdetect._le_detect_batch_impl(
        jnp.asarray(bits[rows, :n_sym].astype(np.float32)),
        jnp.asarray(white), jnp.asarray(aa_on), jnp.asarray(max_dist)))
    hitw, dist = detect.le_detect(
        _t(words), _t(rows.astype(np.int64)), n_sym,
        _t(detect.le_white_words(white)), _t(aa_on), _t(max_dist),
        **_tables())
    n_le = n_sym - SPAN + 1
    assert hitw.dtype == dist.dtype == torch.int32
    assert hitw.shape == (40, -(-n_le // 32)) and dist.shape == (40, n_le)
    assert np.array_equal(dist.numpy(), dj)
    got = detect_kernel.unpack_words(hitw, 32 * hitw.shape[1]).numpy()
    assert np.array_equal(got[:, :n_le], hj)
    assert not got[:, n_le:].any()
    # the planted frames hit, those with three AA flips on data rows not
    assert hj[:, n_le - 1].sum() >= 30 and hj.sum() >= 60


def test_le_detect_reads_no_symbol_past_n_sym():
    """Flipping every bit past n_sym changes nothing."""
    n_sym = 1283
    bits, words, rows = _planted_words(5, n_sym)
    bits2 = bits.copy()
    bits2[:, n_sym:] ^= 1
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    args = (_t(rows.astype(np.int64)), n_sym,
            _t(detect.le_white_words(white)), _t(aa_on), _t(max_dist))
    a = detect.le_detect(_t(words), *args, **_tables())
    b = detect.le_detect(_t(_pack(bits2)), *args, **_tables())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_le_detect_refuses_bad_input():
    _, words, rows = _planted_words(1, 700)
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    ok = dict(words=_t(words), rows=_t(rows.astype(np.int64)),
              white_word=_t(detect.le_white_words(white)), aa_on=_t(aa_on),
              max_dist=_t(max_dist))

    def call(n_sym=700, **kw):
        a = dict(ok, **kw)
        return detect.le_detect(a["words"], a["rows"], n_sym,
                                a["white_word"], a["aa_on"], a["max_dist"],
                                **_tables())
    call()
    with pytest.raises(TypeError):
        call(words=ok["words"].to(torch.int64))
    with pytest.raises(ValueError):
        call(rows=ok["rows"].to(torch.int32))
    with pytest.raises(ValueError):
        call(white_word=_t(white))
    with pytest.raises(ValueError):
        call(n_sym=32 * words.shape[1] + 1)
    with pytest.raises(ValueError):
        call(n_sym=SPAN - 1)


def _jax_le_tail(words, snr_db, le_rows, white, aa_on, max_dist, n_sym,
                 delay_sym, squelch, max_le_hits):
    """The JAX step's LE branch on packed words, as written in
    gr_bluetooth_tpu/models/frontend.py:797-808."""
    words, snr_db, le_rows = (jnp.asarray(a) for a in (words, snr_db,
                                                        le_rows))
    le_bits = jfrontend._unpack_word_rows(words, le_rows, n_sym)
    le_hits, le_dist = jdetect._le_detect_batch_impl(
        le_bits, jnp.asarray(white), jnp.asarray(aa_on),
        jnp.asarray(max_dist))
    if squelch is not None:
        gate = jfrontend._squelch_gate(snr_db, le_hits.shape[1], delay_sym,
                                       squelch)
        le_hits = le_hits & gate[le_rows]
    n_le, le_tab, le_chan, le_off, le_valid = jfrontend._extract_hits(
        le_hits, max_le_hits, [le_dist])
    le_windows = jfrontend._gather_windows(words, le_rows[le_chan], le_off,
                                           le_valid,
                                           jfrontend.LE_WIN_SYMBOLS)
    return int(n_le), np.asarray(le_tab), np.asarray(le_windows)


@pytest.mark.parametrize("n_sym,delay,S,max_le_hits,squelch", [
    (1283, 7, 2, 5, 10.0),        # overflow; slot boundary at bit 10
    (1283, 7, 1, 512, 10.0),      # one slot: the rest mirror it
    (700, 20, 2, 3, None),        # no squelch, overflow
    (1283, 0, 3, 64, 10.0),       # boundary on a word edge
])
def test_packed_le_tail_matches_jax(n_sym, delay, S, max_le_hits, squelch):
    bits, words, rows = _planted_words(n_sym + delay, n_sym)
    # frames across the slot boundary (offset 625 - delay) on some rows
    n_le = n_sym - SPAN + 1
    bound = 625 - delay
    for j in range(0, 40, 3):
        off = min(bound - 5 + j % 11, n_le - 1)
        bits[rows[j], off: off + SPAN] = _frame(INDICES[j], j)
    words = _pack(bits)
    C = words.shape[0]
    r = np.random.default_rng(S)
    snr_db = np.where(r.random((S, C)) < 0.5, 4.0, 16.0).astype(np.float32)
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    want = _jax_le_tail(words, snr_db, rows, white, aa_on, max_dist, n_sym,
                        delay, squelch, max_le_hits)
    consts = frontend.consts_to_device(
        frontend.le_step_consts(white, aa_on, max_dist, n_sym=n_sym,
                                delay_sym=delay), "cpu")
    n, tab, win = frontend._le_tail(
        _t(words), _t(snr_db), _t(rows.astype(np.int64)), n_sym=n_sym,
        squelch=squelch, max_le_hits=max_le_hits, **consts)
    assert n.dtype == tab.dtype == win.dtype == torch.int32
    assert int(n) == want[0]
    assert np.array_equal(tab.numpy(), want[1])
    assert np.array_equal(win.numpy(), want[2])
    assert want[0] > (max_le_hits if max_le_hits < 64 else 10)


@pytest.mark.parametrize("n_sym,delay,S", [
    (1283, 7, 2), (1283, 7, 1), (700, 31, 2), (3180, 4, 5), (1306, 625, 3),
    (43125, 7, 69), (43125, 7, 68)])
def test_le_squelch_words_match_jax_gate(n_sym, delay, S):
    n = n_sym - SPAN + 1
    snr_db = np.random.default_rng(n + S).normal(10, 4, (S, 6)).astype(
        np.float32)
    ref = np.asarray(jfrontend._squelch_gate(jnp.asarray(snr_db), n, delay,
                                             10.0))
    white, aa_on, max_dist = detect.le_row_consts([0])
    c = frontend.consts_to_device(
        frontend.le_step_consts(white, aa_on, max_dist, n_sym=n_sym,
                                delay_sym=delay), "cpu")
    g = frontend._squelch_gate_words(_t(snr_db), c["le_word_s0"],
                                     c["le_word_mask_a"], 10.0)
    assert g.shape == (6, -(-n // 32))
    assert np.array_equal(detect_kernel.unpack_words(g, n).numpy() > 0, ref)


@pytest.mark.parametrize("fs,center,slots,n_le,n_words", [
    (80e6, 2441e6, 64, 43070, 1346), (8e6, 2426e6, 8, 8070, 253)])
def test_le_consts_cover_the_le_offsets(fs, center, slots, n_le, n_words):
    """The LE squelch words are built for the n_sym - 55 LE offsets, not
    for the classic detector's n_sym - 71 (at full band both take 1,346
    words; at 8 Msps and 8-slot blocks 253 against 252)."""
    fe = frontend.FrontEnd(fs, center, block_slots=slots, enable_le=True,
                           device="cpu")
    c = fe.consts
    assert fe.n_sym - SPAN + 1 == n_le
    assert c["le_word_s0"].shape == c["le_word_mask_a"].shape == (n_words,)
    assert c["le_word_s0"].dtype == torch.int64
    s0, ma = jfrontend._word_slot_consts(n_words, fe.delay_sym)
    assert np.array_equal(c["le_word_s0"].numpy(), s0)
    assert np.array_equal(c["le_word_mask_a"].numpy(), ma)
    white, _, _ = detect.le_row_consts([r[2] for r in fe.le_rows])
    assert torch.equal(c["le_white_word"], _t(detect.le_white_words(white)))


def _jax_hit_rows(windows, chan, off, valid):
    """The JAX step's hit table from bit-aligned windows, as written in
    gr_bluetooth_tpu/models/frontend.py:764-776 and :793-796."""
    windows, chan, off, valid = (jnp.asarray(a) for a in (windows, chan,
                                                          off, valid))
    A68, C68v = jnp.asarray(jdetect._A68), jnp.asarray(jdetect._C68v)
    wu = jax.lax.bitcast_convert_type(windows[:, :3], jnp.uint32)
    lap_raw = jax.lax.shift_right_logical(
        wu[:, 1], jnp.uint32(6)).astype(jnp.int32) & 0xFFFFFF
    sh = jnp.arange(32, dtype=jnp.uint32)
    b96 = ((wu[:, :, None] >> sh[None, None, :]) & 1)
    bits68 = b96.reshape(-1, 96)[:, :68].astype(jnp.float32)
    pred = bits68[:, 38:62] @ A68.T.astype(jnp.float32) + C68v[None, :]
    pred = pred - 2.0 * jnp.floor(pred * 0.5)
    err = (bits68 + pred - 2.0 * bits68 * pred).sum(axis=1).astype(jnp.int32)
    lap = jnp.where(valid, lap_raw, -1)
    neg = jnp.int32(-1)
    return np.asarray(jnp.stack([jnp.where(valid, chan, neg),
                                 jnp.where(valid, off, neg), lap,
                                 jnp.where(valid, err, neg)], axis=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a68_hit_rows_match_jax(seed):
    r = np.random.default_rng(seed)
    K, ww = 192, frontend.WIN_SYMBOLS // 32 + 1
    bits = r.integers(0, 2, (K, 32 * ww))
    laps = (0xFFFFFF, 0x24D952, 0x000000, int(r.integers(0, 1 << 24)))
    outside = np.r_[0:38, 62:68]       # symbols that are not LAP bits
    for k in range(0, K, 4):           # true access codes, 0..5 flips
        ac = access_code.ac_bits(laps[k // 4 % 4])[:68].astype(np.int64)
        ac[r.permutation(outside)[:k % 6]] ^= 1
        bits[k, :68] = ac
    bits[1::8, 38:62] = 1              # all-ones LAP bits
    bits[2] = 1                        # all-ones window
    bits[3] = 0
    windows = _pack(bits)
    chan = r.integers(0, 79, K).astype(np.int64)
    off = r.integers(0, 43000, K).astype(np.int64)
    valid = r.random(K) < 0.8
    valid[:4] = True
    want = _jax_hit_rows(windows, chan, off, valid)
    c = frontend.consts_to_device(frontend.ac_product_consts(), "cpu")
    got = frontend._hit_rows(_t(windows), _t(chan), _t(off), _t(valid),
                             c["ac_a68t"], c["ac_c68"])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the form it replaced gives the same LAP and error count
    wu = _t(windows[:, :3]).to(torch.int64) & 0xFFFFFFFF
    lap, err = detect_kernel.ac_errors(
        wu[:, 0], wu[:, 1], wu[:, 2] & 0xF,
        _t(detect_kernel.ac_masks()))
    assert np.array_equal(lap.numpy()[valid], want[valid, 2])
    assert np.array_equal(err.numpy()[valid], want[valid, 3])
    assert (want[0::4, 3][valid[0::4]] <= 5).all()
    assert (want[1::8, 2][valid[1::8]] == 0xFFFFFF).all()
