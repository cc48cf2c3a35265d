"""hit_table's cluster split and its joint entry, on the CPU.

csrc/hit_table.cu runs each tail as one thread-block cluster of
hit_table.CLUSTER blocks: the wrapper splits the flat (R, w) plane with
ops/hit_table.cluster_split (words per block), the kernel's threads read
their block's words as thread_words below models, and the blocks
exchange their counts for their ranks.  Here, without a card:

  * the split covers every plane exactly once, block by block and
    thread by thread (a warp's lanes on consecutive 16-byte groups),
    from planes of fewer words than a cluster has threads up to the
    full band at 128-slot blocks (over one pass of a block);
  * the ranks it exchanges (block_ranks: each block's gated hits and
    their exclusive base) equal the plain extraction's ranks
    (_extract_hits_packed) at hit counts of 0, 1, exactly max_hits,
    above it, and with every hit inside one block's range, and the
    blocks' listed ranks cover [0, min(count, max_hits)) once;
  * hit_tables (both tails in one launch on a card) equals two
    hit_table calls on the CPU and the JAX package's tails
    (_extract_hits_packed, _gather_windows, _extract_hits) on inputs
    made with numpy from a seed, array_equal.
"""
import numpy as np
import pytest
import torch

from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.ops import detect, detect_kernel, hit_table
from gr_bluetooth_tpu_torch.ops.detect_kernel import popcount
from test_torch_hit_table import (INDICES, _jax_classic_tail, _jax_le_tail,
                                  _le_words, _snr, _t)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# (R, w): 8 Msps with 8-slot blocks (fewer words than 16 x 1,024), the
# full band's LE and classic planes at 64-slot blocks, and at 128 (the
# classic one over 16 x 8,192 words: a block's range takes two passes),
# and planes at the edges of a cluster's threads and of a block's pass
PLANES = {"8 Msps, 8 slots": (7, 252), "one word": (1, 1),
          "ragged": (3, 101), "full band LE": (40, 1346),
          "full band": (79, 1346), "full band, 128 slots": (79, 2596),
          "full band LE, 128 slots": (40, 2596),
          "a word per thread": (16, 1024), "one word short": (1, 16383),
          "one pass a block": (16, 8192), "one word over": (16, 8193),
          "one row": (1, 1346)}
MAX_HITS = 192
DENSITIES = ("zero", "one", "exactly max_hits", "above max_hits",
             "one block")
PASS_WORDS = 8 * hit_table.THREADS     # plane words a block reads per pass


def thread_words(split, b: int, t: int, n: int) -> list[int]:
    """The words thread t of block b reads, in every pass, as
    csrc/hit_table.cu reads them: warp k of pass p the 256 words from
    (32 p + k) * 256 on in the block's range, lane l of the warp the
    four from 4 l and the four from 128 + 4 l of them (two 16-byte
    loads)."""
    lo, hi = split.block_range(b, n)
    warp, lane = divmod(t, 32)
    return [i for p0 in range(lo, hi, PASS_WORDS) for q in (0, 128)
            for i in range(p0 + 256 * warp + q + 4 * lane,
                           p0 + 256 * warp + q + 4 * lane + 4)
            if i < hi]


def block_ranks(gated, split):
    """The ranks the cluster exchanges, from a gated (R, w) int32 plane:
    (counts, bases, total), int64: each block's set bits, the set bits
    before its first word (the rank of its first hit in the row-major
    order), and the plane's."""
    flat = popcount(gated.reshape(-1).to(torch.int64) & 0xFFFFFFFF)
    n = flat.numel()
    counts = torch.stack([flat[lo:hi].sum() for lo, hi in
                          (split.block_range(b, n)
                           for b in range(split.blocks))])
    bases = torch.cumsum(counts, 0) - counts
    return counts, bases, counts.sum()


@pytest.mark.parametrize("plane", list(PLANES))
def test_split_covers_the_plane_once(plane):
    R, w = PLANES[plane]
    n = R * w
    s = hit_table.cluster_split(n)
    assert s.blocks == hit_table.CLUSTER and s.per % 32 == 0  # whole lines
    seen = np.zeros(n, np.int64)
    end = 0
    for b in range(s.blocks):
        lo, hi = s.block_range(b, n)
        assert lo == end and lo <= hi            # contiguous, in order
        end = hi
        mine = []
        for t in range(hit_table.THREADS):
            words = thread_words(s, b, t, n)
            # a lane's words in groups of four from a multiple of four
            # (one 16-byte load), lanes side by side in a warp's 256
            assert all(lo <= i < hi for i in words)
            assert all(i % 4 == 0 or i - 1 in words for i in words)
            assert all((i - lo) % 128 // 4 == t % 32 for i in words)
            mine += words
        seen[mine] += 1
        assert len(mine) == hi - lo
    assert end == n and (seen == 1).all()
    # a block's first pass holds up to 32 warps of 256 words
    busy = {t // 32 for t in range(hit_table.THREADS)
            if thread_words(s, 0, t, n)}
    assert len(busy) == min(32, -(-min(s.per, n) // 256))
    assert (s.per > PASS_WORDS) == (n > hit_table.CLUSTER * PASS_WORDS)
    if plane == "full band, 128 slots":
        assert s.per > PASS_WORDS


def _gated_plane(R, w, density, seed, delay=7, S=None):
    """A gated (R, w) hit plane with a chosen number of hits, all at
    positions the squelch passes, and the gate words: random slot SNR,
    the step's squelch word constants."""
    r = np.random.default_rng(seed)
    S = S or max(1, -(-32 * w // 625))
    s0, ma = frontend._word_slot_consts(w, delay)
    gate = frontend._squelch_gate_words(
        _t(_snr(seed, S, R)), _t(s0), _t(ma), 10.0)
    bits = detect_kernel.unpack_words(gate, 32 * w).numpy().reshape(-1)
    on = np.flatnonzero(bits)
    split = hit_table.cluster_split(R * w)
    if density == "one block":
        lo, hi = split.block_range(1 if R * w > split.per else 0, R * w)
        on = on[(on >= 32 * lo) & (on < 32 * hi)]
    k = {"zero": 0, "one": 1, "exactly max_hits": MAX_HITS,
         "above max_hits": MAX_HITS + 57, "one block": 150}[density]
    k = min(k, on.size)
    hit = np.zeros(bits.size, bool)
    hit[r.choice(on, k, replace=False)] = True
    hitw = np.packbits(hit.reshape(R, 32 * w), axis=1, bitorder="little")
    return _t(hitw.view("<u4").view(np.int32)), gate, k


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("plane", ["8 Msps, 8 slots", "full band LE",
                                   "full band", "full band, 128 slots",
                                   "full band LE, 128 slots",
                                   "one word over"])
def test_block_ranks_equal_the_plain_ranks(plane, density):
    R, w = PLANES[plane]
    hitw, gate, k = _gated_plane(R, w, density, len(plane) + 16)
    gated = hitw & gate
    assert torch.equal(gated, hitw)
    split = hit_table.cluster_split(R * w)
    counts, bases, total = block_ranks(gated, split)
    assert int(total) == k and counts.shape == (hit_table.CLUSTER,)
    if density == "one block":
        assert k == 150 and int((counts > 0).sum()) == 1
    if density in ("exactly max_hits", "above max_hits"):
        assert k == MAX_HITS + 57 * (density == "above max_hits")
    # the plain extraction's rank of every hit, and its word
    count, chan, off, valid = hit_table._extract_hits_packed(gated,
                                                             max(k, 1))
    assert int(count) == k
    word = (chan * w + off // 32)[valid].numpy()
    for b in range(split.blocks):
        lo, hi = split.block_range(b, R * w)
        mine = np.flatnonzero((word >= lo) & (word < hi))
        assert int(counts[b]) == mine.size
        assert int(bases[b]) == int((word < lo).sum())
        if mine.size:
            assert mine[0] == int(bases[b]) and \
                mine[-1] == int(bases[b]) + mine.size - 1
    # the ranks the blocks list: [base, min(base + count, max_hits))
    listed = np.zeros(MAX_HITS, np.int64)
    for c, b0 in zip(counts.tolist(), bases.tolist()):
        listed[b0: max(b0, min(b0 + c, MAX_HITS))] += 1
    K = min(k, MAX_HITS)
    assert (listed[:K] == 1).all() and not listed[K:].any()


def _joint_inputs(seed, n_sym=1283, delay=7, S=3, max_hits=16,
                  max_le_hits=24, squelch=10.0, density=0.004):
    """Both tails' arguments over one (C, W) word plane with LE frames
    on 40 of its rows: the classic tail over a random hit plane of every
    row, the LE tail over le_detect's plane of the LE rows."""
    words, rows = _le_words(seed, n_sym)
    C = words.shape[0]
    r = np.random.default_rng(seed)
    n_off = n_sym - 72 + 1
    w = -(-n_off // 32)
    hit = r.random((C, 32 * w)) < density
    hit[:, n_off:] = False
    hit[::5, n_off - 1] = True
    hitw = np.packbits(hit, axis=1, bitorder="little").view("<u4").view(
        np.int32)
    snr_db = _snr(seed + 1, S, C)
    s0, ma = frontend._word_slot_consts(w, delay)
    white, aa_on, max_dist = detect.le_row_consts(INDICES)
    c = frontend.consts_to_device(dict(
        word_s0=s0, word_mask_a=ma, ac_masks=detect_kernel.ac_masks(),
        **frontend.ac_product_consts(),
        **frontend.le_step_consts(white, aa_on, max_dist, n_sym=n_sym,
                                  delay_sym=delay)), "cpu")
    classic = dict(hitw=_t(hitw), words=_t(words), rows=None,
                   snr_db=_t(snr_db), word_s0=c["word_s0"],
                   word_mask_a=c["word_mask_a"], squelch=squelch,
                   max_hits=max_hits,
                   ac={k: c[k] for k in ("ac_a68t", "ac_c68", "ac_masks")})
    le = frontend._le_args(_t(words), _t(snr_db), _t(rows), n_sym=n_sym,
                           squelch=squelch, max_le_hits=max_le_hits,
                           **{k: v for k, v in c.items()
                              if k.startswith("le_")})
    jax_args = dict(hitw=hitw, words=words, snr_db=snr_db, s0=s0, ma=ma,
                    rows=rows, n_sym=n_sym, delay=delay)
    return classic, le, jax_args


@pytest.mark.parametrize("max_hits,max_le_hits,squelch", [
    (16, 24, 10.0),             # both tails within their tables
    (3, 2, 10.0),               # both overflow
    (64, 512, None),            # no squelch
])
def test_joint_entry_equals_two_calls_and_jax(max_hits, max_le_hits,
                                              squelch):
    classic, le, j = _joint_inputs(max_hits + max_le_hits,
                                   max_hits=max_hits,
                                   max_le_hits=max_le_hits, squelch=squelch)
    n, n_le = hit_table.hit_table.launches, hit_table.hit_table.le_launches
    got = hit_table.hit_tables(classic, le)
    assert (hit_table.hit_table.launches,
            hit_table.hit_table.le_launches) == (n, n_le)   # CPU: none
    want = (hit_table.hit_table(**classic), hit_table.hit_table(**le))
    jax_want = (
        _jax_classic_tail(j["hitw"], j["words"], j["snr_db"], j["s0"],
                          j["ma"], squelch, max_hits),
        _jax_le_tail(j["words"], j["snr_db"], j["rows"], j["n_sym"],
                     j["delay"], squelch, max_le_hits))
    for g, w, jw in zip(got, want, jax_want):
        assert all(t.dtype == torch.int32 for t in g)
        assert all(torch.equal(a, b) for a, b in zip(g, w))
        assert int(g[0]) == jw[0]
        assert np.array_equal(g[1].numpy(), jw[1])
        assert np.array_equal(g[2].numpy(), jw[2])
    counts = int(got[0][0]), int(got[1][0])
    assert min(counts) > 0
    if max_hits == 3:
        assert counts[0] > max_hits and counts[1] > max_le_hits


def test_joint_entry_refuses_tails_in_the_wrong_place():
    classic, le, _ = _joint_inputs(5)
    with pytest.raises(ValueError):
        hit_table.hit_tables(le, classic)          # epilogues swapped
    with pytest.raises(ValueError):
        hit_table.hit_tables(classic, dict(le, hitw=le["hitw"][:, :3],
                                           words=le["words"][:, :2]))
