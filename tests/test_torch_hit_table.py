"""hit_table (ops/hit_table.py) on the CPU against the JAX package, exactly.

On the CPU the wrapper runs its plain version, hit_table_plain.  Both of
its epilogues are held to the JAX step's tail on the same inputs, made
from a seed with numpy:

  * classic: the packed squelch AND (_squelch_gate_words),
    _extract_hits_packed, _gather_windows and the hit rows from the
    windows, as gr_bluetooth_tpu/models/frontend.py:753-792 writes them;
  * LE: the dense LE detector on the unpacked rows, the dense squelch
    gate, _extract_hits(le_hits & gate, max_le_hits, [le_dist]) and
    _gather_windows (frontend.py:797-808), against le_detect's hit plane
    (its step form, hits only) through hit_table.

The cases: zero hits, more hits than max_hits, hits in a row's last word
(the LE rows' last offset; bits past n_sym random), a slot boundary
inside a word, the last slot mirrored past S, and no squelch.  Also:
le_detect_plain's step form against the JAX hits, the classic masks of
the constants against ac_a68t and ac_c68 (FrontEnd's and those of
convert.consts_from_jax), and the inputs the wrapper refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import detect as jdetect
from gr_bluetooth_tpu_torch import convert
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.ops import detect, detect_kernel, hit_table
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SPAN = detect.LE_SPAN
INDICES = list(range(40))        # LE channel index per row; 37-39 adv.

# (n_sym, delay_sym, S, max_hits, squelch, hit density): the edge cases
CASES = {
    "zero hits": (1283, 7, 3, 16, 10.0, 0.0),
    "count > max_hits": (1283, 7, 3, 5, 10.0, 0.02),
    "slot boundary inside a word": (1283, 7, 2, 64, 10.0, 0.004),
    "slot S mirrored": (1283, 7, 1, 64, 10.0, 0.004),
    "boundary on a word edge": (1283, 17, 3, 64, 10.0, 0.004),
    "no squelch": (700, 20, 2, 48, None, 0.004),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pack(bits: np.ndarray) -> np.ndarray:
    """(C, 32 W) 0/1 -> (C, W) int32, symbol t at bit t % 32 of word
    t // 32."""
    return np.packbits(bits.astype(np.uint8), axis=1,
                       bitorder="little").view("<u4").view(np.int32)


def _snr(seed: int, S: int, C: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return np.where(r.random((S, C)) < 0.5, 4.0, 16.0).astype(np.float32)


def _jax_classic_tail(hitw, words, snr_db, s0, ma, squelch, max_hits):
    """The JAX step's classic tail on a packed hit plane, as written in
    gr_bluetooth_tpu/models/frontend.py:753-792."""
    hitw, words = jnp.asarray(hitw), jnp.asarray(words)
    if squelch is not None:
        hitw = hitw & jfrontend._squelch_gate_words(
            jnp.asarray(snr_db), jnp.asarray(s0), jnp.asarray(ma), squelch)
    n_hits, chan, off, valid = jfrontend._extract_hits_packed(hitw, max_hits)
    windows = jfrontend._gather_windows(words, chan, off, valid,
                                        jfrontend.WIN_SYMBOLS)
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
    tab = jnp.stack([jnp.where(valid, chan, neg), jnp.where(valid, off, neg),
                     lap, jnp.where(valid, err, neg)], axis=1)
    return int(n_hits), np.asarray(tab), np.asarray(windows)


def _jax_le_tail(words, snr_db, le_rows, n_sym, delay, squelch, max_hits):
    """The JAX step's LE branch on packed words
    (gr_bluetooth_tpu/models/frontend.py:797-808)."""
    white, aa_on, max_dist = jdetect.le_row_consts(INDICES)
    words, le_rows = jnp.asarray(words), jnp.asarray(le_rows)
    le_bits = jfrontend._unpack_word_rows(words, le_rows, n_sym)
    le_hits, le_dist = jdetect._le_detect_batch_impl(
        le_bits, jnp.asarray(white), jnp.asarray(aa_on),
        jnp.asarray(max_dist))
    if squelch is not None:
        gate = jfrontend._squelch_gate(jnp.asarray(snr_db),
                                       le_hits.shape[1], delay, squelch)
        le_hits = le_hits & gate[le_rows]
    n_le, le_tab, le_chan, le_off, le_valid = jfrontend._extract_hits(
        le_hits, max_hits, [le_dist])
    le_windows = jfrontend._gather_windows(words, le_rows[le_chan], le_off,
                                           le_valid,
                                           jfrontend.LE_WIN_SYMBOLS)
    return int(n_le), np.asarray(le_tab), np.asarray(le_windows)


def _classic_inputs(seed, n_sym, delay, S, density, R=10):
    """A random (R, w) classic hit plane over the n_sym - 71 offsets
    (zero past them, as detect_words leaves it) with hits in every row's
    last word, the words (random past n_sym too) and the SNR."""
    r = np.random.default_rng(seed)
    n_off = n_sym - 72 + 1
    w = -(-n_off // 32)
    W = -(-n_sym // 32)
    hit = r.random((R, 32 * w)) < density
    hit[:, n_off:] = False
    if density > 0:
        hit[::3, n_off - 1] = True               # the row's last offset
        hit[1::4, 32 * (w - 1)] = True           # the last word's first bit
    words = _pack(r.integers(0, 2, (R, 32 * W)))
    s0, ma = frontend._word_slot_consts(w, delay)
    return _pack(hit), words, _snr(seed + 1, S, R), s0, ma


@pytest.mark.parametrize("case", list(CASES))
def test_classic_hit_table_matches_jax(case):
    n_sym, delay, S, max_hits, squelch, density = CASES[case]
    hitw, words, snr_db, s0, ma = _classic_inputs(len(case), n_sym, delay,
                                                  S, density)
    want = _jax_classic_tail(hitw, words, snr_db, s0, ma, squelch, max_hits)
    c = frontend.consts_to_device(dict(
        word_s0=s0, word_mask_a=ma, ac_masks=detect_kernel.ac_masks(),
        **frontend.ac_product_consts()), "cpu")
    n = hit_table.hit_table.launches
    got = hit_table.hit_table(
        _t(hitw), _t(words), None, _t(snr_db), word_s0=c["word_s0"],
        word_mask_a=c["word_mask_a"], squelch=squelch, max_hits=max_hits,
        ac={k: c[k] for k in ("ac_a68t", "ac_c68", "ac_masks")})
    assert hit_table.hit_table.launches == n       # the CPU launches none
    assert all(t.dtype == torch.int32 for t in got)
    assert got[0].shape == () and int(got[0]) == want[0]
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    if case == "zero hits":
        assert want[0] == 0
    elif case == "count > max_hits":
        assert want[0] > max_hits
    else:
        assert 0 < want[0] <= max_hits


def _le_words(seed, n_sym, C=45):
    """A (C, W) word plane of random symbols (random past n_sym too), 40
    LE rows among its rows, on each an LE frame at the last offset
    n_sym - 56 (in the row's last hit word), one across a word edge and
    one across the first slot boundary."""
    r = np.random.default_rng(seed)
    W = -(-n_sym // 32) + 1
    bits = r.integers(0, 2, (C, 32 * W))
    rows = r.permutation(C)[:len(INDICES)]
    n_le = n_sym - SPAN + 1
    for j, (row, index) in enumerate(zip(rows, INDICES)):
        for k, off in enumerate((32 * (1 + j % 4) + j % 3 - 1,
                                 min(610 + j % 11, n_le - 1), n_le - 1)):
            if index >= 37:
                f = jpackets.encode_le_adv(0x8E89BED6, index, k % 7,
                                           bytes(range(8)), crc=False)
            else:
                f = jpackets.encode_le_data(0x50654A3B + k, index,
                                            1 + k % 3, bytes(range(5)),
                                            crc_init=0x555555)
            bits[row, off: off + SPAN] = f[:SPAN]
    return _pack(bits), rows.astype(np.int64)


def _le_call(words, rows, snr_db, n_sym, delay, squelch, max_hits):
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    c = frontend.consts_to_device(frontend.le_step_consts(
        white, aa_on, max_dist, n_sym=n_sym, delay_sym=delay), "cpu")
    hitw, none = detect.le_detect(
        _t(words), _t(rows), n_sym, c["le_white_word"], c["le_aa_on"],
        c["le_max_dist"], with_dist=False,
        **{k: c[k] for k in hit_table.LE_TABLES})
    assert none is None
    return hitw, hit_table.hit_table(
        hitw, _t(words), _t(rows), _t(snr_db), word_s0=c["le_word_s0"],
        word_mask_a=c["le_word_mask_a"], squelch=squelch, max_hits=max_hits,
        le=dict(le_white_word=c["le_white_word"], le_aa_on=c["le_aa_on"],
                **{k: c[k] for k in hit_table.LE_TABLES}))


@pytest.mark.parametrize("case", list(CASES))
def test_le_hit_table_matches_jax(case):
    n_sym, delay, S, max_hits, squelch, _ = CASES[case]
    words, rows = _le_words(len(case), n_sym)
    snr_db = _snr(len(case) + 1, S, words.shape[0])
    if case == "zero hits":
        snr_db[:] = 4.0                            # the squelch gates all
    want = _jax_le_tail(words, snr_db, rows, n_sym, delay, squelch,
                        max_hits)
    hitw, got = _le_call(words, rows, snr_db, n_sym, delay, squelch,
                         max_hits)
    assert all(t.dtype == torch.int32 for t in got)
    assert int(got[0]) == want[0]
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    n_le = n_sym - SPAN + 1
    bits = detect_kernel.unpack_words(hitw, 32 * hitw.shape[1]).numpy()
    assert bits[:, n_le - 1].sum() >= 30 and not bits[:, n_le:].any()
    if case == "zero hits":
        assert want[0] == 0
    elif case == "count > max_hits":
        assert want[0] > max_hits
    elif case == "no squelch":
        assert (want[1][:, 1] == n_le - 1).any()   # a last-offset hit
    else:
        assert want[0] > 0


@pytest.mark.parametrize("n_sym", [700, 1283])
def test_le_detect_step_form_equals_jax_hits(n_sym):
    """le_detect_plain(with_dist=False): the hit plane alone, equal to
    the JAX detector's hits, zero past n_le."""
    words, rows = _le_words(n_sym, n_sym)
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    hj, _ = (np.asarray(a) for a in jdetect._le_detect_batch_impl(
        jfrontend._unpack_word_rows(jnp.asarray(words), jnp.asarray(rows),
                                    n_sym).astype(jnp.float32),
        jnp.asarray(white), jnp.asarray(aa_on), jnp.asarray(max_dist)))
    hitw, dist = detect.le_detect_plain(
        _t(words), _t(rows), n_sym, _t(detect.le_white_words(white)),
        _t(aa_on), _t(max_dist), with_dist=False,
        **{k: _t(v) for k, v in detect.le_table_consts().items()})
    n_le = n_sym - SPAN + 1
    assert dist is None and hitw.dtype == torch.int32
    bits = detect_kernel.unpack_words(hitw, 32 * hitw.shape[1]).numpy()
    assert np.array_equal(bits[:, :n_le], hj) and not bits[:, n_le:].any()
    assert hj[:, n_le - 1].sum() >= 30


def _masks_from_product(a68t, c68):
    """The 24 LAP-bit masks and C68, three 32-bit words each, from the
    float32 product's constants."""
    rows = np.vstack([np.asarray(a68t), np.asarray(c68)[None]]) > 0.5
    words = np.zeros((25, 3), np.uint64)
    for j in range(68):
        words[:, j // 32] |= rows[:, j].astype(np.uint64) << np.uint64(j % 32)
    return words.astype(np.uint32).view(np.int32).reshape(-1)


@pytest.mark.parametrize("fs,center", [(8e6, 2426e6), (80e6, 2441e6)])
def test_classic_masks_equal_the_product_constants(fs, center):
    """hit_table's classic masks (ac_masks, the same constant
    detect_words takes) are the ac_a68t and ac_c68 of the product form,
    in FrontEnd's constants and in convert.consts_from_jax's."""
    fj = jfrontend.FrontEnd(fs, center, block_slots=8, enable_le=True,
                            use_pallas=True)
    ft = frontend.FrontEnd(fs, center, block_slots=8, enable_le=True,
                           device="cpu")
    kw = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in fj._step_kwargs.items()}
    consts, _ = convert.consts_from_jax(kw)
    for c in (ft.consts, consts):
        want = _masks_from_product(c["ac_a68t"].numpy(), c["ac_c68"].numpy())
        assert np.array_equal(c["ac_masks"].numpy(), want)
    assert torch.equal(consts["ac_masks"], ft.consts["ac_masks"])


def test_hit_table_refuses_bad_input():
    hitw, words, snr_db, s0, ma = _classic_inputs(3, 700, 7, 2, 0.01)
    c = frontend.consts_to_device(dict(
        word_s0=s0, word_mask_a=ma, ac_masks=detect_kernel.ac_masks(),
        **frontend.ac_product_consts()), "cpu")
    ac = {k: c[k] for k in ("ac_a68t", "ac_c68", "ac_masks")}
    ok = dict(hitw=_t(hitw), words=_t(words), snr_db=_t(snr_db),
              word_s0=c["word_s0"], word_mask_a=c["word_mask_a"])

    def call(rows=None, max_hits=8, epi=None, **kw):
        a = dict(ok, **kw)
        return hit_table.hit_table(
            a["hitw"], a["words"], rows, a["snr_db"], word_s0=a["word_s0"],
            word_mask_a=a["word_mask_a"], squelch=10.0, max_hits=max_hits,
            **(epi if epi is not None else dict(ac=ac)))
    call()
    with pytest.raises(TypeError):
        call(hitw=ok["hitw"].to(torch.int64))
    with pytest.raises(ValueError):
        call(word_s0=ok["word_s0"].to(torch.int32))
    with pytest.raises(ValueError):
        call(words=ok["words"][:, :3])             # narrower than the plane
    with pytest.raises(ValueError):
        call(max_hits=0)
    with pytest.raises(ValueError):
        call(rows=torch.arange(hitw.shape[0], dtype=torch.int32))
    with pytest.raises(ValueError):
        call(epi=dict(ac=ac, le={}))               # two epilogues
    with pytest.raises(ValueError):
        call(epi={})                               # none
    with pytest.raises(ValueError):
        call(snr_db=ok["snr_db"][:, :3])           # not a column per row
