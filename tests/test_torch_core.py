"""The port's copies of the NumPy host modules against the JAX package's:
fec, crc, whitening (classic and LE), hop, le_ll, packets (encoders and
the decode of every BR type, FHS fields, LE PDUs) and batch_decode, on
inputs made from a seed with numpy.  Results must be equal, array for
array and field for field."""
import dataclasses

import numpy as np
import pytest

from gr_bluetooth_tpu.core import batch_decode as jbatch
from gr_bluetooth_tpu.core import crc as jcrc
from gr_bluetooth_tpu.core import fec as jfec
from gr_bluetooth_tpu.core import hop as jhop
from gr_bluetooth_tpu.core import le_ll as jle_ll
from gr_bluetooth_tpu.core import le_tables as jle_tables
from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu.core import whitening as jwhitening
from gr_bluetooth_tpu_torch.core import (batch_decode, crc, fec, hop, le_ll,
                                         le_tables, packets, whitening)

LAP, UAP = 0x24D952, 0x47
R = np.random.default_rng(2024)
B54 = R.integers(0, 2, 54).astype(np.uint8)
B100 = R.integers(0, 2, 100).astype(np.uint8)
B160 = R.integers(0, 2, (3, 160)).astype(np.uint8)
NOISY13 = np.where(R.random(162) < 0.05, 1, 0).astype(np.uint8) ^ \
    np.repeat(B54, 3)
NOISY23 = R.integers(0, 2, (4, 150)).astype(np.uint8)
HDR = R.integers(0, 1 << 10, 64)
HEC = R.integers(0, 256, 64)
HDR_BITS = R.integers(0, 2, (5, 10)).astype(np.uint8)
CLOCKS = R.integers(0, 1 << 27, 1000)


def _same(a, b):
    """Recursive equality of the values the modules return."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and \
            _same(dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


ADDR = 0x4724D952 & 0xFFFFFFF
CASES = {
    "fec13_encode": (jfec, fec, "fec13_encode", lambda m: (B54,)),
    "unfec13": (jfec, fec, "unfec13", lambda m: (NOISY13,)),
    "fec23_encode": (jfec, fec, "fec23_encode", lambda m: (B100,)),
    "fec23_decode": (jfec, fec, "fec23_decode", lambda m: (NOISY23, 100)),
    "fec23_decode_blocks": (jfec, fec, "fec23_decode_blocks",
                            lambda m: (NOISY23.reshape(4, 10, 15),)),
    "crc16": (jcrc, crc, "crc16", lambda m: (B160, UAP)),
    "crc16_ragged": (jcrc, crc, "crc16_ragged",
                     lambda m: (B160, np.array([16, 80, 160]),
                                np.array([1, UAP, 0xFF]))),
    "crc16_states": (jcrc, crc, "crc16_states", lambda m: (B160, UAP)),
    "payload_crc_ok": (jcrc, crc, "payload_crc_ok", lambda m: (
        np.concatenate([B100[:96], np.asarray(
            jpackets.host_to_air(int(jcrc.crc16(B100[:96], UAP)), 16))]),
        UAP)),
    "hec_forward": (jcrc, crc, "hec_forward",
                    lambda m: (HDR_BITS, UAP)),
    "uap_from_hec": (jcrc, crc, "uap_from_hec", lambda m: (HDR, HEC)),
    "whitening_word": (jwhitening, whitening, "whitening_word",
                       lambda m: (np.arange(64), 100, 18)),
    "unwhiten": (jwhitening, whitening, "unwhiten", lambda m: (B100, 37, 18)),
    "unwhiten_many": (jwhitening, whitening, "unwhiten_many",
                      lambda m: (B100, np.arange(64), 5)),
    "le_whitening_word": (jwhitening, whitening, "le_whitening_word",
                          lambda m: (38, 200, 3)),
    "whitening_tables": (jwhitening, whitening, None, lambda m: (
        m.SEQUENCE, m.CLASSIC_INDEX, m.LE_INDEX)),
    "le_tables": (jle_tables, le_tables, None, lambda m: (
        m.LE_INDEX2CHAN, m.LE_CHAN2INDEX, m.AA_DISTANCE,
        m.DATA_HEADER_DISTANCE, [m.index2freq(i) for i in range(40)])),
    "crc24": (jle_ll, le_ll, "crc24", lambda m: (B160, 0x5A6B7C)),
    "crc24_bits": (jle_ll, le_ll, "crc24_bits", lambda m: (B160[0], 0x555555)),
    "crc24_ok": (jle_ll, le_ll, "crc24_ok", lambda m: (
        np.concatenate([B100, jle_ll.crc24_bits(B100, 0x123456)]),
        0x123456)),
    "used_channels": (jle_ll, le_ll, "used_channels",
                      lambda m: (0x1F0F00FF3C,)),
    "csa1_sequence": (jle_ll, le_ll, "csa1_sequence",
                      lambda m: (3, 7, 0x1F0F00FF3C, 50)),
    "csa2_sequence": (jle_ll, le_ll, "csa2_sequence",
                      lambda m: (0x50655F3A, 0x1F0F00FF3C, 50, 3)),
    "csa2_channel_identifier": (jle_ll, le_ll, "csa2_channel_identifier",
                                lambda m: (0x8E89BED6,)),
    "address_precalc": (jhop, hop, "address_precalc",
                        lambda m: (((UAP << 24) | LAP) & 0xFFFFFFF,)),
    "perm5": (jhop, hop, "perm5", lambda m: (np.arange(32), 0x15,
                                             np.arange(0, 512, 17)[:, None])),
    "hop_afh": (jhop, hop, "hop",
                lambda m: (CLOCKS, m.address_precalc(ADDR), True)),
    "hop_sequence_block": (jhop, hop, "hop_sequence_block",
                           lambda m: (0x12780, 300, m.address_precalc(ADDR))),
    "init_candidates_aliased": (jhop, hop, "init_candidates", lambda m: (
        40, 0x12, m.address_precalc(ADDR), True)),
    "winnow": (jhop, hop, "winnow", lambda m: (
        np.arange(0x12, 1 << 27, 64 * 997), 33, 40,
        m.address_precalc(ADDR))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax(case):
    jmod, tmod, name, args = CASES[case]
    if name is None:                       # module tables
        assert _same(args(tmod), args(jmod))
        return
    got = getattr(tmod, name)(*args(tmod))
    ref = getattr(jmod, name)(*args(jmod))
    assert _same(got, ref), case


# type code -> user payload for the encoders (HV1/HV2 fixed length, DV
# with 10 voice bytes)
BR_TYPES = {0: b"", 1: b"", 3: b"\x01\x02\x03\x04\x05", 4: bytes(range(20)),
            5: bytes(range(10)), 6: bytes(range(20)), 7: bytes(range(25)),
            8: b"dv-data", 9: b"AUX1-payload", 10: bytes(range(100)),
            11: bytes(range(150)), 12: bytes(range(90)),
            13: bytes(range(160)), 14: bytes(range(200)),
            15: bytes(range(250))}


def _decoded(mod, bits, clock, clkn=5, channel=40):
    pkt = mod.ClassicPacket(symbols=bits, clkn=clkn, channel=channel,
                            snr=12.5)
    pkt.set_clock(clock, True)
    pkt.set_uap(UAP)
    ok = pkt.decode()
    fhs = (pkt.lap_from_fhs(), pkt.uap_from_fhs(), pkt.nap_from_fhs(),
           pkt.clock_from_fhs()) if pkt.packet_type == 2 and ok else None
    out = dict(ok=ok, fhs=fhs, lap=pkt.lap,
               header_present=pkt.header_present(),
               type=pkt.packet_type, name=pkt.type_name(),
               length=pkt.payload_length, llid=pkt.payload_llid,
               flow=pkt.payload_flow,
               payload=None if pkt.payload is None else pkt.payload.copy(),
               voice=pkt.voice_bytes(), summary=pkt.summary(),
               tun=pkt.tun_format(), scores=[pkt.crc_check(c)
                                             for c in range(0, 64, 7)])
    base = mod.ClassicPacket(symbols=bits, clkn=clkn, channel=channel)
    out["try_clocks"] = base.try_clocks(np.arange(64))
    return out


@pytest.mark.parametrize("type_code", sorted(BR_TYPES) + [2])
def test_br_type_encode_and_decode_match_jax(type_code):
    """Every BR type (FHS through its own encoder): the encoders' bits are
    equal, and the port decodes both packages' bits as the JAX package
    does, at the true clock and in the 64-clock candidate scoring."""
    clock = 0x12780 + type_code
    if type_code == 2:
        enc = [m.encode_fhs_packet(LAP, UAP, 0xBEEF, clock=clock,
                                   clk27_value=clock)
               for m in (packets, jpackets)]
    else:
        voice = bytes(range(10, 20)) if type_code == 8 else b""
        enc = [m.encode_classic_packet(LAP, UAP, clock, type_code,
                                       BR_TYPES[type_code],
                                       voice_bytes=voice)
               for m in (packets, jpackets)]
    assert _same(enc[0], enc[1])
    bits = np.concatenate([enc[0], R.integers(0, 2, 40).astype(np.uint8)])
    got, ref = _decoded(packets, bits, clock), _decoded(jpackets, bits, clock)
    assert _same(got, ref)
    assert got["ok"] or type_code in (0, 1)
    assert got["type"] == type_code
    if type_code == 2:
        assert got["fhs"][:3] == (LAP, UAP, 0xBEEF)


def test_crc_check_clocks_matches_jax():
    for t in (3, 10, 12, 5, 2):
        clock = 0x2A
        if t == 2:
            bits = packets.encode_fhs_packet(LAP, UAP, 1, clock, 0x123456)
        else:
            bits = packets.encode_classic_packet(LAP, UAP, clock, t,
                                                 BR_TYPES[t])
        res = []
        for m in (packets, jpackets):
            pkt = m.ClassicPacket(symbols=bits.copy())
            uaps, types, fec_ok = pkt.try_clocks(np.arange(64))
            res.append(m.crc_check_clocks(pkt, list(range(64)),
                                          uaps.tolist(), types.tolist()))
        assert res[0] == res[1], t


def _le(mod, bits, freq):
    p = mod.LePacket(symbols=bits, freq=freq, clkn=9, snr=20.0)
    return dict(fields={f.name: getattr(p, f.name)
                        for f in dataclasses.fields(p)},
                crc_ok=p.crc_ok(), crc_conn=p.crc_ok(0x5A6B7C),
                connect=p.connect_req_fields(), adv=p.adv_addr(),
                summary=p.summary(), name=p.pdu_name())


def test_le_pdus_match_jax():
    """Advertising PDUs (incl. a CONNECT_REQ's LLData) and data PDUs:
    equal encoder bits and equal parsed fields."""
    lldata = (0x50655F3A).to_bytes(4, "little") + \
        (0x5A6B7C).to_bytes(3, "little") + bytes([2, 1, 0, 6, 0, 0, 0, 100,
                                                  0]) + \
        (0x1FFFFFFFFF).to_bytes(5, "little") + bytes([7])
    frames = [
        ("adv", dict(aa=0x8E89BED6, index=38, pdu_type=5,
                     payload=b"\xaa" * 6 + b"\x11" * 6 + lldata), 2426e6),
        ("adv", dict(aa=0x8E89BED6, index=37, pdu_type=0,
                     payload=b"\x11\x22\x33\x44\x55\x66\x02\x01\x06",
                     ch_sel=1), 2402e6),
        ("adv", dict(aa=0x8E89BED6, index=39, pdu_type=2,
                     payload=bytes(range(9)), crc=False), 2480e6),
        ("data", dict(aa=0x50655F3A, index=10, llid=2,
                      payload=bytes(range(8)), crc_init=0x5A6B7C, sn=1),
         2426e6 - 2e6),
    ]
    for kind, kw, freq in frames:
        enc = [getattr(m, f"encode_le_{kind}")(**kw)
               for m in (packets, jpackets)]
        assert _same(enc[0], enc[1]), kw
        bits = np.concatenate([enc[0], np.zeros(16, np.uint8)])
        got, ref = _le(packets, bits, freq), _le(jpackets, bits, freq)
        assert _same(got, ref), kw
    assert got["crc_conn"]


def test_batch_decode_matches_jax():
    """decode_known_rows over every batched type, a deferred type and a
    corrupted row: the same row dicts."""
    rows, sizes = [], []
    for t in (0, 1, 3, 4, 8, 9, 10, 11, 14, 15, 7, 3):
        voice = bytes(range(10)) if t == 8 else b""
        b = packets.encode_classic_packet(LAP, UAP, 0x2A, t, BR_TYPES[t],
                                          voice_bytes=voice)
        row = np.zeros(3200, np.uint8)
        row[:len(b)] = b
        rows.append(row)
        sizes.append(len(b))
    rows[-1][150:160] ^= 1                   # a payload FEC failure
    sym = np.stack(rows)
    args = (sym, np.array(sizes), np.full(len(rows), 0x2A),
            np.full(len(rows), UAP))
    got = batch_decode.decode_known_rows(*args)
    ref = jbatch.decode_known_rows(*args)
    assert _same(got, ref)
    assert sum(r is None for r in got) == 1       # EV3 defers
