"""Batched steady-state classic packet decode.

The reference decodes inline, one packet at a time
(lib/multi_sniffer_impl.cc:82-166); our per-packet numpy port of that
costs ~300 us/packet in small-array overhead — the host-side bound of a
busy air capture.  For hits whose piconet is already known (clock + UAP
— the steady state), every stage is data-parallel across a block's hits:

    unfec13 header  -> per-row whitening words -> HEC/UAP verify
    -> payload header (FEC2/3 or direct, grouped by header size)
    -> payload FEC2/3 per 15-bit block, ragged lengths via masks
    -> per-byte CRC-16 prefix states, gathered at each row's length

decode_known_rows runs these stages in one native pass over the rows
(native/batch_decode.cc, built with g++ at first use by io/native.py and
called through ctypes without the interpreter lock): the numpy form
costs a fixed ~150 array ops per call, which set the sniffer's host time
per block.  The numpy form stays as _decode_known_rows_numpy, the
reference tests/test_torch_batch_native.py holds the native pass to,
and runs only where the library cannot be built (no g++).  Counters
batch_decode.rows and batch_decode.native_rows (utils/metrics.py) say
how many rows each call took and how many the native pass decoded.

Only the common ACL types run batched — NULL/POLL (0, 1), DM1/3/5 + DV
(3, 10, 14, 8), DH1/3/5 + AUX1 (4, 11, 15, 9); FHS and the
voice/extended-voice types (2, 5, 6, 7, 12, 13) defer to the per-packet
path (`None` rows), as do header-verify failures' piconet state effects.
Decisions and outputs are bit-identical to ClassicPacket.decode() at the
same (clock, uap): tests/test_batch_decode.py checks every type and
failure mode against the scalar path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..io import native
from ..utils.bits import air_to_host
from ..utils.metrics import metrics
from . import crc, fec, whitening

__all__ = ["decode_known_rows"]

_HDR_SKIP = 18

# packet types the batch handles, with (header_bytes, max_length, use_fec,
# voice_skip); others defer to ClassicPacket
_BATCH_TYPES = {
    0: None, 1: None,
    3: (1, 20, True, 0), 8: (1, 12, True, 80),
    10: (2, 125, True, 0), 14: (2, 228, True, 0),
    4: (1, 30, False, 0), 9: (1, 30, False, 0),
    11: (2, 187, False, 0), 15: (2, 343, False, 0),
}
_NO_CRC_TYPES = (9,)                   # AUX1 carries no CRC


def decode_known_rows(bits: np.ndarray, sizes: np.ndarray,
                      clocks: np.ndarray, uaps: np.ndarray) -> list:
    """Decode K symbol windows at known clocks/UAPs in batch.

    bits: (K, L) uint8 air symbols (0 or 1) from the access-code start
    (rows may carry junk beyond sizes[k]); sizes: (K,) valid symbols per
    row; clocks: (K,) CLK1-6(+) values; uaps: (K,).

    Returns a K-list: None where the row must take the per-packet path
    (exotic type), else a dict with ClassicPacket.decode()'s effects:
    ok, packet_type, packet_header, payload (None on failure),
    payload_length, payload_header_length, payload_llid, payload_flow.
    """
    metrics.count("batch_decode.rows", len(bits))
    fn = _load()
    if fn is None:
        return _decode_known_rows_numpy(bits, sizes, clocks, uaps)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    K, L = bits.shape
    cols = np.array((sizes, clocks, uaps), dtype=np.int64)
    if L < 126 or cols.shape != (3, K):
        raise ValueError(f"bits must be (K, >=126) and sizes, clocks and "
                         f"uaps ({K},): got {bits.shape} and {cols.shape}")
    stride = max(L, 236)             # the widest payload a row can take
    meta = np.empty((K, _COLS), np.int32)
    hv = np.empty((K, 98), np.uint8)           # header bits, voice bits
    payload = np.empty((K, stride), np.uint8)
    rc = fn(bits.ctypes.data, K, L, cols.ctypes.data, meta.ctypes.data,
            hv.ctypes.data, payload.ctypes.data, stride)
    if rc:
        raise RuntimeError(f"bt_decode_known_rows returned {rc}")
    metrics.count("batch_decode.native_rows", K)

    out: list = [None] * K
    headers = list(hv[:, :18])
    for k, (st, t, length, hlen, llid, flow, crc_ok, n, has_voice) in \
            enumerate(meta.tolist()):
        if st == _DEFERRED:
            continue
        if st == _HEADER_FAILED:
            out[k] = {"ok": False, "header_failed": True}
            continue
        o = out[k] = {"ok": False, "header_failed": False,
                      "packet_type": t, "packet_header": headers[k],
                      "payload": None, "payload_length": length,
                      "payload_header_length": hlen, "payload_llid": llid,
                      "payload_flow": flow}
        if has_voice:
            o["voice"] = hv[k, 18:]
        if st == _OK:
            # a copy (np.array's is cheaper than .copy()'s): a view would
            # pin the whole (K, stride) payload matrix
            o["payload"] = np.array(payload[k, :n])
            o["ok"] = True
            o["crc_ok"] = None if crc_ok < 0 else bool(crc_ok)
        elif st == _OK_EMPTY:
            o["ok"] = True
            o["payload"] = np.zeros(0, dtype=np.uint8)
        else:
            o["fail"] = _FAIL[st]
    return out


# native/batch_decode.cc's row status codes and meta columns
_DEFERRED, _HEADER_FAILED, _OK, _OK_EMPTY = 0, 1, 5, 6
_FAIL = {2: "hdr", 3: "range", 4: "payload_fec"}
_COLS = 9
_SOURCE = Path(__file__).resolve().parent.parent / "native" / \
    "batch_decode.cc"
_FN = None
_TRIED = False


def _load():
    """bt_decode_known_rows, built at first use; None without g++."""
    global _FN, _TRIED
    if _FN is None and not _TRIED:
        _TRIED = True
        so = native.build(_SOURCE)
        if so is not None:
            fn = ctypes.CDLL(str(so)).bt_decode_known_rows
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            fn.argtypes = [vp, i64, i64, vp, vp, vp, vp, i64]
            fn.restype = ctypes.c_int
            _FN = fn
    return _FN


def _decode_known_rows_numpy(bits: np.ndarray, sizes: np.ndarray,
                              clocks: np.ndarray,
                              uaps: np.ndarray) -> list:
    """decode_known_rows in numpy array ops: the native pass's reference.

    bits: (K, L) uint8 air symbols from the access-code start (rows may
    carry junk beyond sizes[k]); sizes: (K,) valid symbols per row;
    clocks: (K,) CLK1-6(+) values; uaps: (K,).

    Returns a K-list: None where the row must take the per-packet path
    (exotic type), else a dict with ClassicPacket.decode()'s effects:
    ok, packet_type, packet_header, payload (None on failure),
    payload_length, payload_header_length, payload_llid, payload_flow.
    """
    K, L = bits.shape
    sizes = np.asarray(sizes, dtype=np.int64)
    clocks = np.asarray(clocks, dtype=np.int64)
    uaps = np.asarray(uaps, dtype=np.int64)
    out: list = [None] * K

    usable = sizes >= 126
    hdr_raw, fec_ok = fec.unfec13(bits[:, 72:126])             # (K, 18)
    unw = hdr_raw ^ whitening.whitening_word(clocks, 18, 0)
    hdr_data = air_to_host(unw[:, :10])
    hec = air_to_host(unw[:, 10:18])
    hdr_ok = usable & fec_ok & (crc.uap_from_hec(hdr_data, hec) == uaps)
    ptypes = air_to_host(unw[:, 3:7])

    # row dispatch in pure python (tolist first: numpy scalar indexing in
    # a K-loop was the single largest host-decode cost at the hostile
    # load, round-5 profile) — header-fail rows report so the caller can
    # run its clock-lost path; exotic types defer to the scalar path
    hdr_ok_l = hdr_ok.tolist()
    ptypes_l = ptypes.tolist()
    _FAIL = dict(ok=False, header_failed=True)
    for k, (ho, t) in enumerate(zip(hdr_ok_l, ptypes_l)):
        if not ho:
            out[k] = _FAIL.copy()
        elif t in _BATCH_TYPES:
            out[k] = dict(ok=False, header_failed=False,
                          packet_type=t, packet_header=unw[k],
                          payload=None, payload_length=0,
                          payload_header_length=0, payload_llid=0,
                          payload_flow=0)

    rows = np.array([k for k, o in enumerate(out)
                     if o is not None and not o["header_failed"]],
                    dtype=np.int64)
    if not rows.size:
        return out

    rt = ptypes[rows]
    # NULL / POLL: empty payload, decode succeeds
    for k in rows[np.isin(rt, (0, 1))].tolist():
        out[k]["ok"] = True
        out[k]["payload"] = np.zeros(0, dtype=np.uint8)

    acl = rows[np.isin(rt, (3, 8, 10, 14, 4, 9, 11, 15))]
    if acl.size:
        _decode_acl_all(bits, sizes, clocks, uaps, ptypes, acl, out)
    return out


# per-type parameter tables indexed by packet type (ACL types only)
_T_HB2 = np.zeros(16, bool)
_T_FEC = np.zeros(16, bool)
_T_VOICE = np.zeros(16, np.int64)
_T_MAX = np.zeros(16, np.int64)
for _t, _v in _BATCH_TYPES.items():
    if _v is not None:
        _T_HB2[_t] = _v[0] == 2
        _T_MAX[_t] = _v[1]
        _T_FEC[_t] = _v[2]
        _T_VOICE[_t] = _v[3]


def _decode_acl_all(bits, sizes, clocks, uaps, ptypes, g, out):
    """All ACL rows (DM1/3/5, DV, DH1/3/5, AUX1) in ONE batched pass:
    per-row type parameters come from lookup tables, the FEC and direct
    payload-header variants are both computed and selected per row, and
    ragged payload lengths ride masks — one fixed numpy cost per block
    instead of four per-(header size, FEC) group calls."""
    Kg = g.size
    t = ptypes[g]
    hb2 = _T_HB2[t]
    use_fec = _T_FEC[t]
    voice = _T_VOICE[t]
    maxlen = _T_MAX[t]
    off = 126 + voice
    size = sizes[g] - off
    # the payload-header and FEC-block gathers below index up to
    # off.max()+30 columns regardless of the rows' true sizes (out-of-size
    # reads are masked by hdr_parse_ok / in_range) — zero-pad narrow bit
    # matrices so a block whose hits all sit near the tail (size 126..235
    # with an ACL/DV type) cannot raise IndexError (ADVICE r4 #1)
    need = int(off.max()) + 30
    if bits.shape[1] < need:
        bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))

    # payload header: both variants on a 30-bit window, selected per row
    span30 = np.arange(30)
    hs = bits[g[:, None], off[:, None] + span30[None, :]]
    dblk, okb = fec.fec23_decode_blocks(hs.reshape(Kg, 2, 15))
    fec16 = dblk.reshape(Kg, 20)[:, :16]
    hdr_fec_ok = okb[:, 0] & (okb[:, 1] | ~hb2)
    hdr16 = np.where(use_fec[:, None], fec16, hs[:, :16])
    hdr16u = hdr16 ^ whitening.whitening_word(clocks[g], 16, _HDR_SKIP)
    length = np.where(hb2, air_to_host(hdr16u[:, 3:13]) + 4,
                      air_to_host(hdr16u[:, 3:8]) + 3)
    llid = air_to_host(hdr16u[:, 0:2])
    flow = hdr16u[:, 2].astype(np.int64)
    need_hdr = np.where(use_fec, np.where(hb2, 30, 15),
                        np.where(hb2, 16, 8))
    hdr_parse_ok = (size >= need_hdr) & (hdr_fec_ok | ~use_fec)
    in_range = hdr_parse_ok & (length <= maxlen) & (length * 8 <= size)

    # payload bits: FEC blocks + direct stream, ragged lengths via masks.
    # Only the in-range rows run the payload stage — out-of-range rows
    # exit at "hdr"/"range" before touching it, and at the 64-candidate
    # UAP attack ~3/4 of the rows are out-of-range garbage whose W-wide
    # (up to ~2700-bit) gathers/FEC/whitening dominated the first-packet
    # discovery cost (round-5 profile)
    s = np.nonzero(in_range)[0]
    Ks = s.size
    gs = g[s]
    offs = off[s]
    Lbits = length[s] * 8
    # FEC-block span: only FEC rows consume codeword blocks — a DH-heavy
    # group must not pay a (K, nb, 15) FEC decode sized by DH lengths
    need_blocks = np.where(use_fec[s], (Lbits + 9) // 10, 0)
    nb_max = max(int(need_blocks.max(initial=0)), 1)
    nb_max = min(nb_max, int((bits.shape[1] - offs.max()) // 15)) \
        if Ks else 1
    span = np.arange(nb_max * 15)
    cw = bits[gs[:, None], offs[:, None] + span[None, :]]
    data, okb2 = fec.fec23_decode_blocks(cw.reshape(Ks, nb_max, 15))
    blk = np.arange(nb_max)[None, :]
    fec_ok_s = (okb2 | (blk >= need_blocks[:, None]) |
                ~use_fec[s][:, None]).all(axis=1)
    fec_all_ok = np.zeros(Kg, bool)
    fec_all_ok[s] = fec_ok_s
    W = max(nb_max * 10, min(int(Lbits.max(initial=16)),
                             int(bits.shape[1] - offs.max())
                             if Ks else 16), 16)
    fec_flat = data.reshape(Ks, nb_max * 10)
    if fec_flat.shape[1] < W:
        fec_flat = np.pad(fec_flat, ((0, 0), (0, W - fec_flat.shape[1])))
    direct = cw[:, :W] if W <= cw.shape[1] else \
        bits[gs[:, None], offs[:, None] + np.arange(W)[None, :]]
    raw = np.where(use_fec[s][:, None], fec_flat[:, :W], direct)
    unw = raw ^ whitening.whitening_word(clocks[gs], W, _HDR_SKIP)
    nbytes_max = W // 8
    data_bits = np.clip((length[s] - 2) * 8, 0, nbytes_max * 8)
    crcs = crc.crc16_ragged(unw[:, : nbytes_max * 8], data_bits, uaps[gs])
    w16 = (1 << np.arange(16, dtype=np.int64))

    # DV voice field: 80 raw air bits at payload start, whitened like the
    # payload (skip 18), no FEC/CRC — decoded whenever the scalar path
    # would (packets.ClassicPacket._dm), i.e. for every hdr-ok DV row
    # whose stream covers 80 bits
    dv = np.nonzero((t == 8) & (sizes[g] - 126 >= 80))[0]
    if dv.size:
        vg = g[dv]
        vbits = bits[vg[:, None], 126 + np.arange(80)[None, :]]
        vunw = vbits ^ whitening.whitening_word(clocks[vg], 80, _HDR_SKIP)
        for j, i in enumerate(dv.tolist()):
            out[g[i]]["voice"] = vunw[j]

    # received CRC-16 per row, batched: gather each row's trailing 16
    # payload bits at its own length (clipped in-bounds; rows where the
    # CRC does not apply are masked off below)
    cpos = np.clip((length[s] - 2) * 8, 0, max(unw.shape[1] - 16, 0))
    cidx = cpos[:, None] + np.arange(16)[None, :]
    crc_rx = (np.take_along_axis(unw, cidx, axis=1).astype(np.int64)
              * w16).sum(axis=1)
    has_crc = ~np.isin(t[s], _NO_CRC_TYPES) & (length[s] >= 2) & \
        (length[s] <= nbytes_max)
    crc_match = crcs == crc_rx

    # per-row assembly in pure python over tolist'd columns (numpy scalar
    # indexing here was ~46 us/pkt at the hostile load, round-5 profile);
    # srow maps a group row to its position in the in-range subset
    srow = np.full(Kg, -1, np.int64)
    srow[s] = np.arange(Ks)
    length_l = length.tolist()
    llid_l = llid.tolist()
    flow_l = flow.tolist()
    hb2_l = hb2.tolist()
    hp_l = hdr_parse_ok.tolist()
    ir_l = in_range.tolist()
    fok_l = fec_all_ok.tolist()
    hc_l = has_crc.tolist()
    cm_l = crc_match.tolist()
    g_l = g.tolist()
    srow_l = srow.tolist()
    for i in range(Kg):
        o = out[g_l[i]]
        if not hp_l[i]:
            o["ok"] = False
            o["fail"] = "hdr"
            continue
        o["payload_header_length"] = 2 if hb2_l[i] else 1
        o["payload_length"] = length_l[i]
        o["payload_llid"] = llid_l[i]
        o["payload_flow"] = flow_l[i]
        if not ir_l[i]:
            o["ok"] = False
            o["fail"] = "range"
            continue
        if not fok_l[i]:
            o["ok"] = False
            o["fail"] = "payload_fec"
            continue
        j = srow_l[i]
        # copy: a view would pin the whole (Ks, W) unwhitened matrix in
        # memory for as long as any decoded packet from the block lives
        o["payload"] = unw[j, : length_l[i] * 8].copy()
        o["ok"] = True
        o["crc_ok"] = cm_l[j] if hc_l[j] else None
