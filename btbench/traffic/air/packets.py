"""Classic packet encoders: the synthesizer's side of core/packets.py.

A frozen copy, for the benchmark's yardstick, of the encoders of core/packets.py
(gr_bluetooth_tpu_torch).  It imports nothing of the port; later
changes to the port leave it as it is.
"""
from __future__ import annotations

import numpy as np

from .bits import host_to_air
from . import access_code, crc, fec, whitening


_HDR_SKIP = 18  # payload whitening starts 18 bits after the header's


def _encode_header_bits(lt_addr: int, type_code: int, flow: int, arqn: int,
                        seqn: int, uap: int) -> np.ndarray:
    hdr = np.zeros(10, dtype=np.uint8)
    hdr[0:3] = host_to_air(lt_addr, 3)
    hdr[3:7] = host_to_air(type_code, 4)
    hdr[7], hdr[8], hdr[9] = flow & 1, arqn & 1, seqn & 1
    hec = crc.hec_forward(hdr, uap)
    return np.concatenate([hdr, host_to_air(int(hec), 8)])


def _payload_header_bits(nbody: int, llid: int, flow: int,
                         header_bytes: int) -> np.ndarray:
    if header_bytes == 1:
        h = np.zeros(8, dtype=np.uint8)
        h[0:2] = host_to_air(llid, 2)
        h[2] = flow & 1
        h[3:8] = host_to_air(nbody, 5)
    else:
        h = np.zeros(16, dtype=np.uint8)
        h[0:2] = host_to_air(llid, 2)
        h[2] = flow & 1
        h[3:13] = host_to_air(nbody, 10)
    return h


def encode_classic_packet(lap: int, uap: int, clock: int, type_code: int,
                          payload_bytes: bytes = b"", lt_addr: int = 1,
                          llid: int = 2, flow: int = 0,
                          whiten: bool = True,
                          voice_bytes: bytes = b"") -> np.ndarray:
    """Air symbols for a classic packet: AC + FEC1/3 header [+ payload].

    Supported payload types: NULL/POLL (no payload), DM1/DM3/DM5 (FEC2/3 +
    CRC), DH1/DH3/DH5/AUX1 (no FEC), HV1/HV2/HV3 (fixed length, no CRC),
    EV3/EV5 (CRC, no FEC), EV4 (CRC, FEC2/3), DV (80-bit voice field +
    DM1-style data field, voice_bytes must be 10 bytes).  FHS: use
    encode_fhs_packet.  `clock` is the piconet CLK1-6 (or CLK1-27; low 6
    bits whiten).

    DV framing matches the reference decoder (lib/packet_impl.cc:783-793):
    the voice ("synchronous data") field is 80 raw air bits with no FEC
    and no CRC, and the data field's whitening index starts at 18 — the
    same as every other payload — not 18+80."""
    ac = access_code.ac_bits(lap)
    hdr18 = _encode_header_bits(lt_addr, type_code, flow, 0, 0, uap)
    if whiten:
        hdr18 = whitening.unwhiten(hdr18, clock, 0)  # XOR is its own inverse
    out = [ac, fec.fec13_encode(hdr18)]

    if type_code in (0, 1):
        return np.concatenate(out)

    if type_code == 8:               # DV voice field precedes the data field
        if len(voice_bytes) != 10:
            raise ValueError("DV needs exactly 10 voice bytes (80 bits)")
        vbits = host_to_air(np.frombuffer(bytes(voice_bytes), np.uint8),
                            8).reshape(-1)
        if whiten:
            vbits = whitening.unwhiten(vbits, clock, _HDR_SKIP)
        out.append(vbits)
    elif voice_bytes:
        raise ValueError("voice_bytes only applies to DV (type 8)")

    body = np.frombuffer(bytes(payload_bytes), dtype=np.uint8)
    body_bits = host_to_air(body, 8).reshape(-1) if len(body) else \
        np.zeros(0, dtype=np.uint8)
    if type_code in (3, 8):          # DM1 / DV data field
        hdr_bits = _payload_header_bits(len(body), llid, flow, 1)
        use_fec23, use_fec13, crc_needed = True, False, True
    elif type_code in (10, 14):      # DM3 / DM5
        hdr_bits = _payload_header_bits(len(body), llid, flow, 2)
        use_fec23, use_fec13, crc_needed = True, False, True
    elif type_code in (4, 9):        # DH1 / AUX1
        hdr_bits = _payload_header_bits(len(body), llid, flow, 1)
        use_fec23, use_fec13, crc_needed = False, False, (type_code != 9)
    elif type_code in (11, 15):      # DH3 / DH5
        hdr_bits = _payload_header_bits(len(body), llid, flow, 2)
        use_fec23, use_fec13, crc_needed = False, False, True
    elif type_code in (7, 13):       # EV3 / EV5
        hdr_bits = np.zeros(0, dtype=np.uint8)
        use_fec23, use_fec13, crc_needed = False, False, True
    elif type_code == 12:            # EV4: CRC, FEC 2/3, no payload header
        hdr_bits = np.zeros(0, dtype=np.uint8)
        use_fec23, use_fec13, crc_needed = True, False, True
    elif type_code == 5:             # HV1: 10 bytes, FEC 1/3, no CRC
        hdr_bits = np.zeros(0, dtype=np.uint8)
        use_fec23, use_fec13, crc_needed = False, True, False
    elif type_code == 6:             # HV2: 20 bytes, FEC 2/3, no CRC
        hdr_bits = np.zeros(0, dtype=np.uint8)
        use_fec23, use_fec13, crc_needed = True, False, False
    else:
        raise ValueError(f"unsupported encode type {type_code}")

    bits = np.concatenate([hdr_bits, body_bits])
    if crc_needed:
        c = crc.crc16(bits, uap)
        bits = np.concatenate([bits, host_to_air(int(c), 16)])
    if whiten:
        bits = whitening.unwhiten(bits, clock, _HDR_SKIP)
    if use_fec13:
        bits = fec.fec13_encode(bits)
    elif use_fec23:
        pad = (-len(bits)) % 10
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
        bits = fec.fec23_encode(bits)
    out.append(bits)
    return np.concatenate(out)


def encode_fhs_payload(lap: int, uap: int, nap: int, clk27: int,
                       device_class: int = 0, lt_addr: int = 1) -> np.ndarray:
    """FHS payload bits (pre-whitening/FEC), 20 bytes with CRC.

    Field layout per spec §6.5.1.4 as read by the reference's extractors
    (lap_from_fhs :1244-1275): parity[0:34] LAP[34:58] ...
    UAP[64:72] NAP[72:88] ... CLK2-27[115:141]."""
    bits = np.zeros(144, dtype=np.uint8)
    bits[34:58] = host_to_air(lap, 24)
    bits[58:60] = 0                     # undefined
    bits[60:62] = host_to_air(1, 2)     # SR
    bits[62:64] = host_to_air(2, 2)     # SP
    bits[64:72] = host_to_air(uap, 8)
    bits[72:88] = host_to_air(nap, 16)
    bits[88:112] = host_to_air(device_class, 24)
    bits[112:115] = host_to_air(lt_addr, 3)
    bits[115:141] = host_to_air((clk27 >> 1) & 0x3FFFFFF, 26)
    bits[141:144] = 0                   # page scan mode
    c = crc.crc16(bits, uap)
    return np.concatenate([bits, host_to_air(int(c), 16)])


def encode_fhs_packet(lap: int, uap: int, nap: int, clock: int,
                      clk27_value: int) -> np.ndarray:
    """Complete FHS packet symbols (AC + header + FEC2/3 whitened payload)."""
    payload = encode_fhs_payload(lap, uap, nap, clk27_value)
    whitened = whitening.unwhiten(payload, clock, _HDR_SKIP)
    ac = access_code.ac_bits(lap)
    hdr18 = whitening.unwhiten(
        _encode_header_bits(1, 2, 0, 0, 0, uap), clock, 0)
    return np.concatenate([ac, fec.fec13_encode(hdr18),
                           fec.fec23_encode(whitened)])
