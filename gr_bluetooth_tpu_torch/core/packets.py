"""Classic BR and LE packet codecs: decode (sniffer side) + encode (synth side).

Decode mirrors the reference's classic_packet/le_packet semantics
(lib/packet_impl.cc) including the crc_check candidate-scoring contract used
by the piconet CLK1-6 attack:

    0   definite failure (only trusted for FHS/DM1/HV1)
    1   inconclusive
    >1  CRC-verified success (EV3/EV5 demoted to 1: high false-positive rate)

Documented intentional divergences from the reference (spec-correct here):
  * FEC 2/3 single-bit correction actually fires (see core/fec.py docstring).
  * decode_payload type 13 (EV5) does not fall through into the DM5 parser
    (reference has a missing `break`, lib/packet_impl.cc:1147-1150).

Encode is new capability (the reference has no transmitter); it exists so the
framework can synthesize golden captures with exact ground truth (SURVEY §4).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import ID_THRESHOLD, TYPE_NAMES
from ..utils.bits import air_to_host, host_to_air
from . import access_code, crc, fec, le_ll, whitening
from .le_tables import freq2index

__all__ = ["ClassicPacket", "LePacket", "encode_classic_packet",
           "encode_fhs_payload", "encode_le_adv", "encode_le_data"]

_HDR_SKIP = 18  # payload whitening starts 18 bits after the header's


# ======================================================================
# decode
# ======================================================================

@dataclass
class ClassicPacket:
    """A classic BR packet candidate: symbols start at the access code."""
    symbols: np.ndarray                  # air symbols, uint8
    clkn: int = 0                        # native slot clock at detection
    channel: int = -1
    freq: float = 0.0
    snr: float = 0.0

    whitened: bool = True
    uap: int = 0
    clock: int = 0                       # CLK1-6 or CLK1-27
    have_uap: bool = False
    have_nap: bool = False
    nap: int = 0
    have_clk6: bool = False
    have_clk27: bool = False
    have_payload: bool = False
    packet_type: int = -1
    packet_header: np.ndarray | None = None
    payload: np.ndarray | None = None    # unwhitened payload bits
    payload_length: int = 0              # bytes, incl. payload hdr + CRC
    payload_header_length: int = 0
    payload_llid: int = 0
    payload_flow: int = 0
    voice: np.ndarray | None = None      # DV: unwhitened 80-bit voice field

    def __post_init__(self):
        self.symbols = np.asarray(self.symbols, dtype=np.uint8)
        self._lap: int | None = None

    # ------------------------------------------------------------ basics

    @property
    def lap(self) -> int:
        if self._lap is None:
            self._lap = int(air_to_host(self.symbols[38:62]))
        return self._lap

    def header_present(self) -> bool:
        """Trailer + triple-agreement test (lib/packet_impl.cc:1205-1242)."""
        s = self.symbols
        if len(s) < 126:
            return False
        msb = int(s[67])
        be = ((int(s[68]) ^ (1 - msb)) + (int(s[69]) ^ msb) +
              (int(s[70]) ^ (1 - msb)) + (int(s[71]) ^ msb))
        t = s[72:126].reshape(18, 3).astype(np.int64)
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        be += int((((a ^ b) | (b ^ c)) | (c ^ a)).sum())
        return be < ID_THRESHOLD

    def _unwhiten(self, bits, clock, skip):
        if not self.whitened:
            return np.asarray(bits, dtype=np.uint8)
        return whitening.unwhiten(bits, clock, skip)

    # ------------------------------------------------------------ header

    def try_clock(self, clock: int) -> int:
        """Trial-unwhiten the header at a CLK1-6 value; sets uap/type.
        Mirrors lib/packet_impl.cc:1046-1063 (returns 0 on FEC failure)."""
        hdr, ok = fec.unfec13(self.symbols[72:126])
        if not ok:
            return 0
        unw = self._unwhiten(hdr, clock, 0)
        hdr_data = int(air_to_host(unw[:10]))
        hec = int(air_to_host(unw[10:18]))
        self.uap = int(crc.uap_from_hec(hdr_data, hec))
        self.packet_type = int(air_to_host(unw[3:7]))
        return self.uap

    def try_clocks(self, clocks: np.ndarray):
        """Vectorized try_clock over candidate clocks.
        Returns (uaps, types, fec_ok) without mutating state."""
        hdr, ok = fec.unfec13(self.symbols[72:126])
        if not ok:
            z = np.zeros(len(clocks), dtype=np.int64)
            return z, z, False
        if self.whitened:
            unw = whitening.unwhiten_many(hdr, np.asarray(clocks), 0)
        else:
            unw = np.broadcast_to(hdr, (len(clocks), 18))
        hdr_data = air_to_host(unw[:, :10])
        hec = air_to_host(unw[:, 10:18])
        uaps = crc.uap_from_hec(hdr_data, hec).astype(np.int64)
        types = air_to_host(unw[:, 3:7])
        return uaps, types, True

    def decode_header(self) -> bool:
        """Verify header at the known clock/UAP (lib/packet_impl.cc:1066-1089)."""
        if not self.have_clk6:
            return False
        hdr, ok = fec.unfec13(self.symbols[72:126])
        if not ok:
            return False
        unw = self._unwhiten(hdr, self.clock, 0)
        hdr_data = int(air_to_host(unw[:10]))
        hec = int(air_to_host(unw[10:18]))
        if int(crc.uap_from_hec(hdr_data, hec)) != self.uap:
            return False
        self.packet_header = unw
        self.packet_type = int(air_to_host(unw[3:7]))
        return True

    # ------------------------------------------------------------ payload

    def _payload_stream(self):
        return self.symbols[126:]

    def _payload_crc_ok(self) -> bool:
        if self.payload is None or self.payload_length < 2:
            return False
        n = self.payload_length * 8
        return bool(crc.payload_crc_ok(self.payload[:n], self.uap))

    def _decode_payload_header(self, stream, clock, header_bytes, size,
                               use_fec) -> bool:
        nbits = 8 * header_bytes
        need = 30 if (use_fec and header_bytes == 2) else \
               15 if use_fec else nbits
        if size < need:
            return False
        if use_fec:
            data, ok = fec.fec23_decode(stream, nbits)
            if not ok:
                return False
            hdr = self._unwhiten(data[:nbits], clock, _HDR_SKIP)
        else:
            hdr = self._unwhiten(stream[:nbits], clock, _HDR_SKIP)
        if header_bytes == 2:
            self.payload_length = int(air_to_host(hdr[3:13])) + 4
        else:
            self.payload_length = int(air_to_host(hdr[3:8])) + 3
        self.payload_llid = int(air_to_host(hdr[0:2]))
        self.payload_flow = int(hdr[2])
        self.payload_header_length = header_bytes
        return True

    def _fhs(self, clock: int) -> int:
        """FHS payload: FEC2/3, fixed 20 bytes, 32-way X-input retry
        (lib/packet_impl.cc:688-723)."""
        stream = self._payload_stream()
        size = len(stream)
        self.payload_length = 20
        if size < self.payload_length * 12:
            return 1
        corrected, ok = fec.fec23_decode(stream, self.payload_length * 8)
        if not ok:
            return 0
        corrected = corrected[: self.payload_length * 8]
        for clk in [clock, *range(32, 64)]:
            self.payload = self._unwhiten(corrected, clk, _HDR_SKIP)
            if self._payload_crc_ok():
                return 1000
        self.payload = None
        return 0

    def _dm(self, clock: int) -> int:
        stream = self._payload_stream()
        size = len(stream)
        header_bytes, max_length = {
            8: (1, 12), 3: (1, 20), 10: (2, 125), 14: (2, 228),
        }.get(self.packet_type, (None, None))
        if header_bytes is None:
            return 0
        if self.packet_type == 8:      # DV: 80-bit voice field first
            if size >= 80:
                # the reference only skips these bits
                # (lib/packet_impl.cc:783-785); we also decode them —
                # raw air bits, no FEC/CRC, whitened like the payload
                self.voice = self._unwhiten(stream[:80], clock, _HDR_SKIP)
            stream = stream[80:]
            size -= 80
        if not self._decode_payload_header(stream, clock, header_bytes, size, True):
            return 0
        if self.payload_length > max_length:
            return 1                   # could be encrypted
        bitlength = self.payload_length * 8
        if bitlength > size:
            return 1
        data, ok = fec.fec23_decode(stream, bitlength)
        if not ok:
            return 0
        self.payload = self._unwhiten(data[:bitlength], clock, _HDR_SKIP)
        return 10 if self._payload_crc_ok() else 1

    def _dh(self, clock: int) -> int:
        stream = self._payload_stream()
        size = len(stream)
        header_bytes, max_length = {
            9: (1, 30), 4: (1, 30), 11: (2, 187), 15: (2, 343),
        }.get(self.packet_type, (None, None))
        if header_bytes is None:
            return 0
        if not self._decode_payload_header(stream, clock, header_bytes, size, False):
            return 0
        if self.payload_length > max_length:
            return 1
        bitlength = self.payload_length * 8
        if bitlength > size:
            return 1
        self.payload = self._unwhiten(stream[:bitlength], clock, _HDR_SKIP)
        if self.packet_type == 9:      # AUX1 has no CRC
            return 1
        return 10 if self._payload_crc_ok() else 1

    def _ev_scan(self, clock: int, max_bytes: int) -> int:
        """EV3/EV5: unwhiten once, scan CRC over byte lengths
        (lib/packet_impl.cc:884-913, 970-999) via incremental CRC states."""
        stream = self._payload_stream()
        nbytes = min(max_bytes, len(stream) // 8)
        if nbytes < 3:
            return 1
        bits = self._unwhiten(stream[:nbytes * 8], clock, _HDR_SKIP)
        states = crc.crc16_states(bits, self.uap)
        # the reference scans payload lengths 3..maxlength-1
        for ln in range(3, min(nbytes, max_bytes - 1) + 1):
            check = int(air_to_host(bits[(ln - 2) * 8: ln * 8]))
            if int(states[ln - 2]) == check:
                self.payload = bits
                self.payload_length = ln
                return 10
        return 1

    def _ev4(self, clock: int) -> int:
        """EV4: blockwise FEC2/3 until failure, CRC per byte
        (lib/packet_impl.cc:915-968)."""
        stream = self._payload_stream()
        size = len(stream)
        maxlength, minlength = 1470, 45
        nblocks = min(maxlength, size) // 15
        if nblocks == 0:
            return 1
        blocks = stream[: nblocks * 15].reshape(nblocks, 15)
        data, ok = fec.fec23_decode_blocks(blocks)
        fails = np.nonzero(~ok)[0]
        good_blocks = int(fails[0]) if len(fails) else nblocks
        bits_avail = good_blocks * 10
        if bits_avail > 0:
            raw = data[:good_blocks].reshape(-1)
            unw = self._unwhiten(raw, clock, _HDR_SKIP)
            nbytes = bits_avail // 8
            states = crc.crc16_states(unw[: nbytes * 8], self.uap)
            for ln in range(3, nbytes + 1):
                check = int(air_to_host(unw[(ln - 2) * 8: ln * 8]))
                if int(states[ln - 2]) == check:
                    self.payload = unw
                    self.payload_length = ln
                    return 10
        if len(fails) and good_blocks * 15 < minlength:
            return 0
        return 1

    def _hv(self, clock: int) -> int:
        stream = self._payload_stream()
        if len(stream) < 240:
            self.payload_length = 0
            return 1
        if self.packet_type == 5:      # HV1
            data, ok = fec.unfec13(stream[:240])
            if not ok:
                return 0
            self.payload_length = 10
            self.payload = self._unwhiten(data, clock, _HDR_SKIP)
        elif self.packet_type == 6:    # HV2
            data, ok = fec.fec23_decode(stream[:240], 160)
            if not ok:
                return 0
            self.payload_length = 20
            self.payload = self._unwhiten(data[:160], clock, _HDR_SKIP)
        elif self.packet_type == 7:    # HV3
            self.payload_length = 30
            self.payload = self._unwhiten(stream[:240], clock, _HDR_SKIP)
        return 1

    def crc_check(self, clock: int) -> int:
        """Candidate-elimination score for a trial clock
        (lib/packet_impl.cc:612-673); call try_clock first."""
        t = self.packet_type
        if t == 2:
            r = self._fhs(clock)
        elif t in (8, 3, 10, 14):
            r = self._dm(clock)
        elif t in (4, 11, 15):
            r = self._dh(clock)
        elif t == 7:
            r = self._ev_scan(clock, 32)
        elif t == 12:
            r = self._ev4(clock)
        elif t == 13:
            r = self._ev_scan(clock, 182)
        elif t == 5:
            r = self._hv(clock)
        else:
            r = 1
        if r == 0 and t not in (2, 3, 5):
            return 1                   # other logical transports possible
        if r > 1 and t in (7, 13):
            return 1                   # EV3/EV5 false-positive guard
        return r

    def decode_payload(self):
        """Full payload decode at the known clock (lib/packet_impl.cc:1091-1160)."""
        self.payload_header_length = 0
        t, clk = self.packet_type, self.clock
        if t in (0, 1):                # NULL / POLL
            self.payload_length = 0
            self.payload = np.zeros(0, dtype=np.uint8)
        elif t == 2:
            self._fhs(clk)
        elif t in (3, 8, 10, 14):
            self._dm(clk)
        elif t in (4, 9, 11, 15):
            self._dh(clk)
        elif t in (5, 6):
            self._hv(clk)
        elif t == 7:                   # EV3 if CRC checks out, else HV3
            if self._ev_scan(clk, 32) <= 1:
                self._hv(clk)
        elif t == 12:
            self._ev4(clk)
        elif t == 13:
            self._ev_scan(clk, 182)    # EV5 (no reference fall-through bug)
        self.have_payload = True

    def decode(self) -> bool:
        self.have_payload = False
        if self.decode_header():
            self.decode_payload()
        return self.have_payload and self.payload is not None

    def set_clock(self, clock: int, have27: bool):
        self.clock = clock & (0x7FFFFFF if have27 else 0x3F)
        self.have_clk6 = True
        self.have_clk27 = have27

    def set_uap(self, uap: int):
        self.uap = uap
        self.have_uap = True

    def voice_bytes(self) -> bytes | None:
        """DV voice-field bytes (10), or None if absent/undecoded."""
        if self.voice is None:
            return None
        return bytes(int(air_to_host(self.voice[8 * i: 8 * i + 8]))
                     for i in range(10))

    # ------------------------------------------------------------ FHS fields

    def lap_from_fhs(self) -> int:
        return int(air_to_host(self.payload[34:58]))

    def uap_from_fhs(self) -> int:
        return int(air_to_host(self.payload[64:72]))

    def nap_from_fhs(self) -> int:
        return int(air_to_host(self.payload[72:88]))

    def clock_from_fhs(self) -> int:
        """CLK2-27 in 1.25 ms units (caller shifts <<1 for slots)."""
        return int(air_to_host(self.payload[115:141]))

    # ------------------------------------------------------------ output

    def type_name(self) -> str:
        return TYPE_NAMES[self.packet_type] if 0 <= self.packet_type < 16 else "?"

    def summary(self) -> str:
        lines = [self.type_name()]
        if self.payload_header_length > 0:
            lines.append(f"  LLID: {self.payload_llid}")
            lines.append(f"  flow: {self.payload_flow}")
            lines.append(f"  payload length: {self.payload_length}")
        return "\n".join(lines)

    def tun_format(self) -> bytes:
        """9-byte meta+header framing + payload bytes (lib/packet_impl.cc:1175-1202)."""
        out = bytearray(9 + self.payload_length)
        out[0:4] = int(self.clock).to_bytes(4, "little")
        out[4] = self.channel & 0xFF
        out[5] = int(self.have_clk27) | (int(self.have_nap) << 1)
        hdr = self.packet_header if self.packet_header is not None else \
            np.zeros(18, dtype=np.uint8)
        out[6] = int(air_to_host(hdr[0:7]))
        out[7] = int(air_to_host(hdr[7:10]))
        out[8] = int(air_to_host(hdr[10:18]))
        for i in range(self.payload_length):
            out[9 + i] = int(air_to_host(self.payload[8 * i: 8 * i + 8]))
        return bytes(out)


# ======================================================================
# LE decode
# ======================================================================

_ADV_PDU_NAMES = {0: "ADV_IND", 1: "ADV_DIRECT_IND", 2: "ADV_NONCONN_IND",
                  3: "SCAN_REQ", 4: "SCAN_RSP", 5: "CONNECT_REQ",
                  6: "ADV_SCAN_IND"}


@dataclass
class LePacket:
    """LE packet from symbols starting at the preamble (lib/packet_impl.cc:1529-1565)."""
    symbols: np.ndarray
    freq: float
    clkn: int = 0
    snr: float = 0.0

    index: int = -1
    aa: int = 0
    pdu_type: int = 0
    ch_sel: int = 0
    tx_add: int = 0
    rx_add: int = 0
    llid: int = 0
    nesn: int = 0
    sn: int = 0
    md: int = 0
    length: int = 0
    pdu: np.ndarray = field(default_factory=lambda: np.zeros(39, dtype=np.int64))

    def __post_init__(self):
        self.symbols = np.asarray(self.symbols, dtype=np.uint8)
        self.index = freq2index(self.freq)
        s = self.symbols.copy()
        n = len(s)
        if n > 40 and self.index >= 0:
            w = whitening.le_whitening_word(self.index, n - 40)
            s[40:] ^= w
        self.link = s
        self.aa = int(air_to_host(s[8:40]))
        if n >= 56:
            header = int(air_to_host(s[40:56]))
            if self.index >= 37:
                self.pdu_type = header & 0xF
                self.ch_sel = (header >> 5) & 1
                self.tx_add = (header >> 6) & 1
                self.rx_add = (header >> 7) & 1
                self.length = (header >> 8) & 0x3F
            else:
                self.llid = header & 3
                self.nesn = (header >> 2) & 1
                self.sn = (header >> 3) & 1
                self.md = (header >> 4) & 1
                self.length = (header >> 8) & 0x1F
        nbytes = max(0, (n - 56) // 8)
        pdu = air_to_host(s[56:56 + nbytes * 8].reshape(nbytes, 8))
        self.pdu = np.zeros(39, dtype=np.int64)
        self.pdu[:min(39, nbytes)] = pdu[:39]
        # received CRC-24, if the window covers it (bits follow the payload)
        crc_end = 56 + self.length * 8 + 24
        self.crc_rx: int | None = None
        if 0 < self.length and crc_end <= n:
            bits = s[56 + self.length * 8: crc_end].astype(np.int64)
            self.crc_rx = int((bits << np.arange(23, -1, -1)).sum())

    def crc_ok(self, crc_init: int | None = None) -> bool:
        """Validate the CRC-24 (new capability; reference checks none).

        crc_init defaults to the advertising value; pass a connection's
        CRCInit for data-channel packets.
        """
        if self.crc_rx is None:
            return False
        init = le_ll.ADV_CRC_INIT if crc_init is None else crc_init
        data = self.link[40: 56 + self.length * 8]
        return int(le_ll.crc24(data, init)) == self.crc_rx

    # --------------------------------------------------- CONNECT_REQ fields

    def connect_req_fields(self) -> dict | None:
        """Parsed LLData of a CONNECT_REQ (the fields the reference only
        prints, lib/packet_impl.cc:1619-1665) — the inputs to connection
        following (core/le_ll.py)."""
        if self.index < 37 or self.pdu_type != 5 or self.length < 34:
            return None
        p = self.pdu
        return dict(
            init_a=self._mac(0), adv_a=self._mac(6),
            aa=int(p[12] | p[13] << 8 | p[14] << 16 | p[15] << 24),
            crc_init=int(p[16] | p[17] << 8 | p[18] << 16),
            win_size=int(p[19]),
            win_offset=int(p[20] | p[21] << 8),
            interval=int(p[22] | p[23] << 8),
            latency=int(p[24] | p[25] << 8),
            timeout=int(p[26] | p[27] << 8),
            ch_map=int(p[28] | p[29] << 8 | p[30] << 16 | p[31] << 24 |
                       p[32] << 32),
            hop=int(p[33]) & 0x1F,
            sca=(int(p[33]) >> 5) & 7,
            # ChSel header bit: 1 -> the connection uses CSA#2 (BT 5.0
            # §4.5.8.3; the reference predates BT5 entirely)
            ch_sel=self.ch_sel,
        )

    def _mac(self, off: int) -> str:
        return "".join(f"{int(b):02x}" for b in self.pdu[off:off + 6])

    def adv_addr(self) -> str | None:
        """AdvA of an advertising-channel PDU that carries one at the PDU
        start (ADV_IND/ADV_DIRECT_IND/ADV_NONCONN_IND/ADV_SCAN_IND), else
        None.  Used to pair a CONNECT_IND with its advertiser's ChSel bit
        (BT 5.0 Vol 6 Part B §4.5.8: CSA#2 needs BOTH ends to set it)."""
        if self.index < 37 or self.pdu_type not in (0, 1, 2, 6) or \
                self.length < 6:
            return None
        return self._mac(0)

    def summary(self) -> str:
        """Dissection text mirroring le_packet_impl::print
        (lib/packet_impl.cc:1581-1665)."""
        if self.index < 37:
            return (f"BTLE index={self.index:02d}, AA={self.aa:08x}, "
                    f"LLID={self.llid}, NESN={self.nesn}, SN={self.sn}, "
                    f"MD={self.md}, Length={self.length}")
        lines = [f"BTLE index={self.index:02d}, AA={self.aa:08x}, "
                 f"PDUType={self.pdu_type}, TxAdd={self.tx_add}, "
                 f"RxAdd={self.rx_add}, Length={self.length}"]
        t = self.pdu_type
        if t in (0, 2, 4, 6):
            lines.append(f"  AdvA={self._mac(0)}")
            tag = "ScanRspData" if t == 4 else "AdvData"
            data = bytes(int(b) for b in self.pdu[6:self.length])
            txt = "".join(ch if " " <= ch <= "~" else "." for ch in data.decode("latin1"))
            lines.append(f"  (char) {tag}= {txt}")
            lines.append(f"  (byte) {tag}=" + data.hex())
        elif t == 1:
            lines += [f"  AdvA={self._mac(0)}", f"  InitA={self._mac(6)}"]
        elif t == 3:
            lines += [f"  ScanA={self._mac(0)}", f"  AdvA={self._mac(6)}"]
        elif t == 5:
            lines += [f"  InitA={self._mac(0)}", f"  AdvA={self._mac(6)}"]
            p = self.pdu
            aa = int(p[12] | p[13] << 8 | p[14] << 16 | p[15] << 24)
            crc_init = int(p[16] | p[17] << 8 | p[18] << 16)
            win_size = int(p[19])
            win_off = int(p[20] | p[21] << 8)
            interval = int(p[22] | p[23] << 8)
            latency = int(p[24] | p[25] << 8)
            timeout = int(p[26] | p[27] << 8)
            chm = int(p[28] | p[29] << 8 | p[30] << 16 | p[31] << 24 | p[32] << 32)
            hop_v = int(p[33]) & 0x1F
            sca = (int(p[33]) >> 5) & 7
            lines.append(f"  AA={aa:08x}, CRCInit={crc_init:06x}, "
                         f"WinSize={win_size}, WinOffset={win_off}")
            lines.append(f"  Interval={interval}, Latency={latency}, "
                         f"Timeout={timeout}, ChM={chm:010x}, Hop={hop_v}, SCA={sca}")
        return "\n".join(lines)

    def pdu_name(self) -> str:
        if self.index >= 37:
            return _ADV_PDU_NAMES.get(self.pdu_type, f"ADV_{self.pdu_type}")
        return "DATA"


# ======================================================================
# encode (synthesizer side — new capability)
# ======================================================================

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


def _le_assemble(aa: int, index: int, header: np.ndarray, payload: bytes,
                 crc_init: int | None) -> np.ndarray:
    """Common LE framing: preamble + AA + whitened (header+payload[+CRC24])."""
    aa_bits = host_to_air(aa, 32)
    pre9 = 0x155 if aa_bits[0] == 1 else 0x0AA
    preamble = host_to_air(pre9, 9)[:8]
    body = np.frombuffer(bytes(payload), dtype=np.uint8)
    body_bits = host_to_air(body, 8).reshape(-1) if len(body) else \
        np.zeros(0, dtype=np.uint8)
    frame = np.concatenate([header, body_bits])
    if crc_init is not None:
        frame = np.concatenate([frame, le_ll.crc24_bits(frame, crc_init)])
    frame = frame ^ whitening.le_whitening_word(index, len(frame))
    return np.concatenate([preamble, aa_bits, frame]).astype(np.uint8)


def encode_le_adv(aa: int, index: int, pdu_type: int, payload: bytes,
                  crc: bool = True, ch_sel: int = 0) -> np.ndarray:
    """LE advertising-channel packet symbols (preamble+AA+whitened
    hdr+payload+CRC24).  The reference's LE path neither generates nor
    checks the CRC; ours does (core/le_ll.py) — pass crc=False for
    reference-shaped frames.  ch_sel sets the BT5 ChSel header bit
    (CSA#2 support advertised/selected)."""
    header = np.zeros(16, dtype=np.uint8)
    header[0:4] = host_to_air(pdu_type, 4)
    header[5] = ch_sel & 1
    header[8:14] = host_to_air(len(payload), 6)
    return _le_assemble(aa, index, header, payload,
                        le_ll.ADV_CRC_INIT if crc else None)


def encode_le_data(aa: int, index: int, llid: int, payload: bytes,
                   crc_init: int, nesn: int = 0, sn: int = 0,
                   md: int = 0) -> np.ndarray:
    """LE data-channel packet symbols for connection following tests
    (new capability; the reference cannot synthesize LE traffic at all)."""
    header = np.zeros(16, dtype=np.uint8)
    header[0:2] = host_to_air(llid, 2)
    header[2], header[3], header[4] = nesn & 1, sn & 1, md & 1
    header[8:13] = host_to_air(len(payload), 5)
    return _le_assemble(aa, index, header, payload, crc_init)


def _fhs_scores_batch(pkt: ClassicPacket, clocks, uaps) -> list:
    """crc_check scores for FHS-typed candidates, batched.

    Same decision tree as ClassicPacket._fhs (short -> 1, FEC fail -> 0,
    any of the [clock, 32..63] whitening retries CRC-ok -> 1000, else 0),
    but the 33-retry CRC loop per candidate collapses: crc16 is
    GF(2)-affine, so CRC(row_u, uap_k) = data_term[u] ^ seed[k] — one
    XOR-broadcast over (candidates x unique retry clocks) instead of
    |F| x 33 scalar payload_crc_ok calls (the dominant first-packet
    discovery cost, round-5 profile)."""
    stream = pkt.symbols[126:]
    if len(stream) < 240:
        return [1] * len(clocks)
    corrected, ok = fec.fec23_decode(stream, 160)
    if not ok:
        return [0] * len(clocks)
    corrected = corrected[:160]
    cl = np.asarray(clocks, np.int64)
    if pkt.whitened:
        uniq = np.unique(np.concatenate([cl, np.arange(32, 64)]))
        unw = whitening.unwhiten_many(corrected, uniq, _HDR_SKIP)  # (U,160)
        pos = {int(c): i for i, c in enumerate(uniq)}
        shared = uniq >= 32                                        # (U,)
    else:
        uniq = np.zeros(1, np.int64)
        unw = np.asarray(corrected, np.uint8)[None]
        pos = None
        shared = np.ones(1, bool)
    data_term = crc.crc16(unw[:, :144], 0).astype(np.int64)        # (U,)
    check = air_to_host(unw[:, 144:160])                           # (U,)
    seeds = crc.crc16(np.zeros((1, 144), np.uint8),
                      np.asarray(uaps)).astype(np.int64)           # (F,)
    hit = (data_term[None, :] ^ seeds[:, None]) == check[None, :]  # (F, U)
    any_shared = (hit & shared[None, :]).any(axis=1)
    out = []
    for k in range(len(clocks)):
        own = hit[k, pos[int(cl[k])]] if pos is not None else hit[k, 0]
        out.append(1000 if (own or any_shared[k]) else 0)
    return out


def _ev4_scores_batch(pkt: ClassicPacket, clocks, uaps) -> list:
    """crc_check scores for EV4-typed candidates, batched: 10 on a CRC
    scan hit, else 1 (every 0 branch of ClassicPacket._ev4 is converted
    to 1 by crc_check for type 12).  Blockwise FEC runs once (clock-
    independent); unwhiten + byte-length CRC scan vectorize over
    candidates (lib/packet_impl.cc:915-968)."""
    E = len(clocks)
    stream = pkt.symbols[126:]
    nblocks = min(1470, len(stream)) // 15
    if nblocks == 0:
        return [1] * E
    data, okb = fec.fec23_decode_blocks(
        stream[: nblocks * 15].reshape(nblocks, 15))
    fails = np.nonzero(~okb)[0]
    good = int(fails[0]) if len(fails) else nblocks
    nbytes = good * 10 // 8
    if nbytes < 3:
        return [1] * E
    raw = data[:good].reshape(-1)
    if pkt.whitened:
        unw = whitening.unwhiten_many(raw, np.asarray(clocks), _HDR_SKIP)
    else:
        unw = np.broadcast_to(raw, (E, raw.size))
    states = crc.crc16_states(unw[:, : nbytes * 8],
                              np.asarray(uaps)).astype(np.int64)
    w8 = (1 << np.arange(8, dtype=np.int64))
    b = (unw[:, : nbytes * 8].reshape(E, nbytes, 8).astype(np.int64)
         * w8).sum(-1)                                             # (E, nbytes)
    rx16 = b[:, :-1] | (b[:, 1:] << 8)         # rx16[:, ln-2] for ln>=2
    # scan ln = 3..nbytes  <->  j = ln-2 in 1..nbytes-2
    hit = (states[:, 1:nbytes - 1] == rx16[:, 1:nbytes - 1]).any(axis=1)
    return [10 if h else 1 for h in hit.tolist()]


def _hv1_score(pkt: ClassicPacket) -> int:
    """crc_check score for HV1 — candidate-independent: FEC1/3 of the
    fixed 240-bit voice field either corrects (1) or kills (0)."""
    stream = pkt.symbols[126:]
    if len(stream) < 240:
        return 1
    _, ok = fec.unfec13(stream[:240])
    return 1 if ok else 0


def crc_check_clocks(pkt: ClassicPacket, clocks, uaps, types) -> list:
    """Vectorized crc_check over candidate CLK1-6 values — the inner loop
    of the UAP attack (lib/piconet_impl.cc:457-496) scored in one batched
    pass instead of up to 64 python payload decodes per packet.

    clocks/uaps/types: per-candidate values from try_clocks.  Returns the
    per-candidate crc_check retvals (0 / 1 / >=10), identical to calling
    pkt.crc_check(clock) after try_clock (tests/test_batch_decode.py).
    ACL types score from core/batch_decode rows; FHS and voice/extended
    types fall back to the scalar path per candidate."""
    from . import batch_decode

    K = len(clocks)
    n = len(pkt.symbols)
    # pad so the GROUP-wide FEC block gather can never clip the true
    # clock's CRC: in_range mirrors the scalar path's `bitlength > size`
    # cutoff (ClassicPacket._dm), so no candidate decodes more than
    # size_i data bits whose 2/3-FEC codewords span 1.5*size_i + one
    # block — 1.5n + 16 covers every row (the round-4 fixed 4406-wide
    # zero matrix cost ~7x this in alloc+gather for 1-slot packets)
    sym = np.zeros((K, max(n + (n + 1) // 2 + 16, 236)), np.uint8)
    sym[:, :n] = pkt.symbols[None, :]
    rows = batch_decode.decode_known_rows(
        sym, np.full(K, n), np.asarray(clocks, np.int64),
        np.asarray(uaps, np.int64))
    # batch the remaining exotic types over their candidate groups: FHS
    # (whitening-retry CRC), EV4 (byte-length CRC scan), HV1 (candidate-
    # independent FEC verdict)
    fhs_ks = [k for k in range(K) if int(types[k]) == 2]
    ev4_ks = [k for k in range(K) if int(types[k]) == 12]
    pre: dict[int, int] = {}
    if fhs_ks:
        s = _fhs_scores_batch(pkt, [int(clocks[k]) for k in fhs_ks],
                              [int(uaps[k]) for k in fhs_ks])
        pre.update(zip(fhs_ks, s))
    if ev4_ks:
        s = _ev4_scores_batch(pkt, [int(clocks[k]) for k in ev4_ks],
                              [int(uaps[k]) for k in ev4_ks])
        pre.update(zip(ev4_ks, s))
    hv1 = None

    out = []
    for k in range(K):
        t = int(types[k])
        row = rows[k]
        if row is None or row.get("header_failed"):
            if t in (6, 7, 13):
                # crc_check is CONSTANT 1 for these: HV2's 0/1 collapses
                # to 1 (0 only kills for FHS/DM1/HV1) and EV3/EV5 winners
                # are demoted by the false-positive guard
                # (lib/packet_impl.cc:612-673) — skip the payload decode
                # entirely (the dominant discovery-mode cost, round-5
                # profile: _ev_scan over up to 182 bytes per candidate)
                out.append(1)
                continue
            if k in pre:                       # FHS / EV4, batched above
                out.append(pre[k])
                continue
            if t == 5:
                if hv1 is None:
                    hv1 = _hv1_score(pkt)
                out.append(hv1)
                continue
            # unexpected exotic type -> scalar semantics, per candidate
            pkt.uap = int(uaps[k])
            pkt.packet_type = t
            out.append(pkt.crc_check(int(clocks[k])))
            continue
        if row["ok"] and row.get("crc_ok"):
            r = 10
        elif t == 3 and row.get("fail") in ("hdr", "payload_fec"):
            r = 0
        else:
            r = 1
        out.append(r)
    return out
