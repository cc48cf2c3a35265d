// Batched steady-state decode of classic BR packets at known clocks and
// UAPs: core/batch_decode.decode_known_rows in one pass over the rows.
//
// For each row (a packet's air symbols from the access code on, one byte
// per bit), in scalar code:
//   * the header's FEC 1/3 majority, whitening from the 127-bit sequence
//     at the row's CLK1-6, the HEC -> UAP check (spec Vol 2 Part B 7.1.1;
//     UAP_from_hec, lib/packet_impl.cc:596-609);
//   * the payload header, FEC 2/3 or direct, and its length checks;
//   * the payload: FEC 2/3 blocks through a table over the 15-bit codeword
//     (32,768 entries), or the bits as they came, then whitening;
//   * the UAP-seeded CRC-16 through a byte table, and the received CRC.
//
// The batch-wide quantities of the numpy reference (core/batch_decode.py:
// _decode_acl_all) are computed the same way, once, before the payload
// pass: the zero pad to the ACL rows' largest payload offset + 30, the
// FEC block count nb_max and its clip by the matrix width, the payload
// width W, and W // 8, which sets whether a row reports a CRC.  A row's
// result depends on its neighbours only through these.
//
// Exposed as a plain C ABI for ctypes; the call touches no Python object,
// so ctypes runs it without the interpreter lock.
//
// Build: core/batch_decode.py compiles it at first use with io/native.py's
//   build (g++ -O2 -fPIC -shared -pthread -std=c++17) into the package's
//   _build/, named by a digest of this file.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

// Row status, meta column kStatus.
enum Status : int32_t {
  kDeferred = 0,      // not a batched type: the per-packet path decodes it
  kHeaderFailed = 1,  // short row, header FEC or HEC failed
  kFailHdr = 2,       // payload header unreadable
  kFailRange = 3,     // length beyond the type's maximum or the row
  kFailFec = 4,       // a payload FEC 2/3 block uncorrectable
  kOk = 5,            // ACL payload decoded
  kOkEmpty = 6,       // NULL / POLL
};

// Meta columns, one int32 row of kCols per packet.
enum Col : int {
  kStatus, kType, kLength, kHdrLen, kLlid, kFlow, kCrc, kNbits, kVoice, kCols
};

constexpr int kHdrSkip = 18;   // whitening bits spent on the packet header

// Batched types: 0 = deferred, 1 = NULL / POLL, 2 = ACL.
constexpr int kKind[16] = {1, 1, 0, 2, 2, 0, 0, 0, 2, 2, 2, 2, 0, 0, 2, 2};
constexpr bool kHb2[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1};
constexpr bool kFec[16] = {0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0};
constexpr int kMaxLen[16] = {0, 0, 0, 20, 30, 0, 0, 0,
                             12, 30, 125, 187, 0, 0, 228, 343};
constexpr int kNoCrcType = 9;  // AUX1
// the whitening sequence repeated far enough for the longest payload
// (DH5, 343 bytes) after the header's bits, from any phase
constexpr int kSeqTiled = 127 * 24;
static_assert(kSeqTiled >= 126 + kHdrSkip + 343 * 8, "sequence too short");

// 8 symbols (bytes 0 or 1) -> one byte, symbol i at bit i
inline int pack8(const uint8_t* q) {
  uint64_t x;
  std::memcpy(&x, q, 8);
  return static_cast<int>((x * 0x0102040810204080ULL) >> 56);
}

// n symbols of a ^= b, eight at a time
inline void xor_bytes(uint8_t* a, const uint8_t* b, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t x, y;
    std::memcpy(&x, a + i, 8);
    std::memcpy(&y, b + i, 8);
    x ^= y;
    std::memcpy(a + i, &x, 8);
  }
  for (; i < n; ++i) a[i] ^= b[i];
}

int crc_step(int reg, int b) {
  reg = (reg >> 1) | (((reg & 1) ^ (b & 1)) << 15);
  reg ^= (reg & 0x8000) >> 5;
  reg ^= (reg & 0x8000) >> 12;
  return reg;
}

int parity5(int data10) {
  // remainder of data(D) * D^5 mod g(D), g = D^5 + D^3 + D + 1
  int c = data10 << 5;
  for (int k = 14; k >= 5; --k)
    if ((c >> k) & 1) c ^= 0b101011 << (k - 5);
  return c & 31;
}

struct Tables {
  uint8_t seq[kSeqTiled];  // whitening m-sequence from the all-ones
                           // state, repeated
  int idx[64];           // CLK1-6 -> phase of its first whitening bit
  uint64_t spread[256];  // byte -> its 8 bits as symbols
  uint16_t fec23[1 << 15];   // codeword -> corrected data10 | ok << 10
  uint16_t crc[256];     // CRC-16 byte step
  uint8_t rev8[256];

  Tables() {
    auto galois = [](int s, int n, uint8_t* out) {
      for (int i = 0; i < n; ++i) {
        int o = (s >> 6) & 1;
        s = ((s << 1) & 0x7F) ^ (o ? 0x11 : 0);
        out[i] = static_cast<uint8_t>(o);
      }
    };
    galois(0x7F, 127, seq);
    for (int i = 127; i < kSeqTiled; ++i) seq[i] = seq[i - 127];
    int pos[128] = {};
    for (int p = 0; p < 127; ++p) {
      int w = 0;
      for (int j = 0; j < 7; ++j) w |= seq[(p + j) % 127] << j;
      pos[w] = p;
    }
    for (int clk = 0; clk < 64; ++clk) {
      uint8_t win[7];
      galois(0x40 | clk, 7, win);
      int w = 0;
      for (int j = 0; j < 7; ++j) w |= win[j] << j;
      idx[clk] = pos[w];
    }

    int syn_map[32];
    std::fill(syn_map, syn_map + 32, -1);
    for (int i = 0; i < 10; ++i) syn_map[parity5(1 << i)] = i;
    for (int cw = 0; cw < (1 << 15); ++cw) {
      int data = cw & 0x3FF;
      int syn = parity5(data) ^ (cw >> 10);
      int wt = __builtin_popcount(syn);
      int flip = syn_map[syn];
      bool ok = wt <= 1 || flip >= 0;
      if (wt >= 2 && flip >= 0) data ^= 1 << flip;
      fec23[cw] = static_cast<uint16_t>(data | (ok ? 1 << 10 : 0));
    }

    for (int v = 0; v < 256; ++v) {
      int reg = 0;
      for (int i = 0; i < 8; ++i) reg = crc_step(reg, v >> i);
      crc[v] = static_cast<uint16_t>(reg);
      int r = 0;
      for (int i = 0; i < 8; ++i) r |= ((v >> i) & 1) << (7 - i);
      rev8[v] = static_cast<uint8_t>(r);
      uint8_t b[8];
      for (int i = 0; i < 8; ++i) b[i] = static_cast<uint8_t>((v >> i) & 1);
      std::memcpy(&spread[v], b, 8);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int uap_from_hec(const Tables& T, int hdr_data, int hec) {
  for (int i = 9; i >= 0; --i) {
    if (hec & 0x80) hec ^= 0x65;
    hec = ((hec << 1) & 0xFF) | (((hec >> 7) ^ (hdr_data >> i)) & 1);
  }
  return T.rev8[hec];
}

// One row's air symbols; columns past the matrix read 0, as the numpy
// reference's zero pad does.
struct Row {
  const uint8_t* r;
  int64_t L;
  int bit(int64_t c) const { return c < L ? r[c] : 0; }
  int word15(int64_t c) const {
    if (c + 16 <= L) return (pack8(r + c) | pack8(r + c + 8) << 8) & 0x7FFF;
    int w = 0;
    for (int j = 0; j < 15; ++j) w |= bit(c + j) << j;
    return w;
  }
};

int64_t payload_offset(int t) { return 126 + (t == 8 ? 80 : 0); }

}  // namespace

extern "C" {

// bits: (K, L) uint8 air symbols, 0 or 1; cols: (3, K) int64, the rows'
// sizes, clocks and UAPs.  Fills meta (K, kCols) int32; hv (K, 98) uint8,
// each row's 18 unwhitened header bits then, where meta[k][kVoice], its
// 80 DV voice bits; and payload (K, pay_stride) uint8, row k's first
// meta[k][kNbits] unwhitened payload bits where its status is kOk.
// meta[k][kCrc] is -1 where the row reports no CRC, else whether it
// matched.  Returns 0, or -1 for arguments it cannot take (L < 126, a
// payload row narrower than max(L, 236)).
int bt_decode_known_rows(const uint8_t* bits, int64_t K, int64_t L,
                         const int64_t* cols, int32_t* meta, uint8_t* hv,
                         uint8_t* payload, int64_t pay_stride) {
  if (K < 0 || L < 126 || pay_stride < std::max<int64_t>(L, 236)) return -1;
  const Tables& T = tables();
  const int64_t* sizes = cols;
  const int64_t* clocks = cols + K;
  const int64_t* uaps = cols + 2 * K;

  // header of every row; the ACL rows' largest payload offset
  int64_t off_max = -1;
  for (int64_t k = 0; k < K; ++k) {
    const uint8_t* r = bits + k * L;
    int32_t* m = meta + k * kCols;
    std::fill(m, m + kCols, 0);
    uint8_t* h = hv + k * 98;
    const uint8_t* w = T.seq + T.idx[clocks[k] & 0x3F];
    int nerr = 0, word = 0;
    for (int i = 0; i < 18; ++i) {
      int a = r[72 + 3 * i], b = r[73 + 3 * i], c = r[74 + 3 * i];
      nerr += (a ^ b) | (b ^ c) | (c ^ a);
      h[i] = static_cast<uint8_t>(((a & b) | (b & c) | (c & a)) ^ w[i]);
      word |= h[i] << i;
    }
    bool ok = sizes[k] >= 126 && nerr < 4 &&
              uap_from_hec(T, word & 0x3FF, word >> 10) == uaps[k];
    int t = (word >> 3) & 0xF;
    m[kType] = t;
    if (!ok) {
      m[kStatus] = kHeaderFailed;
    } else if (kKind[t] == 1) {
      m[kStatus] = kOkEmpty;
    } else if (kKind[t] == 2) {
      m[kStatus] = kOk;            // pending: settled below
      off_max = std::max(off_max, payload_offset(t));
    }
  }
  if (off_max < 0) return 0;
  const int64_t Lp = std::max(L, off_max + 30);   // the padded width

  // payload headers; the in-range rows' batch-wide extents
  int64_t need_blocks_max = 0, offs_max = -1, lbits_max = 16;
  for (int64_t k = 0; k < K; ++k) {
    int32_t* m = meta + k * kCols;
    if (m[kStatus] != kOk) continue;
    const Row row{bits + k * L, L};
    const int t = m[kType];
    const bool hb2 = kHb2[t], use_fec = kFec[t];
    const int64_t off = payload_offset(t);
    const int64_t size = sizes[k] - off;
    const uint8_t* w = T.seq + T.idx[clocks[k] & 0x3F] + kHdrSkip;

    if (t == 8 && sizes[k] - 126 >= 80) {
      uint8_t* v = hv + k * 98 + 18;
      for (int i = 0; i < 80; ++i)
        v[i] = static_cast<uint8_t>(row.bit(126 + i) ^ w[i]);
      m[kVoice] = 1;
    }

    const int d0 = T.fec23[row.word15(off)];
    const int d1 = T.fec23[row.word15(off + 15)];
    const bool hdr_fec_ok = (d0 >> 10) && ((d1 >> 10) || !hb2);
    int hdr16 = use_fec ? (d0 & 0x3FF) | ((d1 & 0x3F) << 10)
                        : row.word15(off) | (row.bit(off + 15) << 15);
    hdr16 ^= pack8(w) | pack8(w + 8) << 8;
    const int64_t need_hdr = use_fec ? (hb2 ? 30 : 15) : (hb2 ? 16 : 8);
    if (size < need_hdr || !(hdr_fec_ok || !use_fec)) {
      m[kStatus] = kFailHdr;
      continue;
    }
    const int64_t length = hb2 ? ((hdr16 >> 3) & 0x3FF) + 4
                               : ((hdr16 >> 3) & 0x1F) + 3;
    m[kHdrLen] = hb2 ? 2 : 1;
    m[kLength] = static_cast<int32_t>(length);
    m[kLlid] = hdr16 & 3;
    m[kFlow] = (hdr16 >> 2) & 1;
    if (length > kMaxLen[t] || length * 8 > size) {
      m[kStatus] = kFailRange;
      continue;
    }
    if (use_fec)
      need_blocks_max = std::max(need_blocks_max, (length * 8 + 9) / 10);
    offs_max = std::max(offs_max, off);
    lbits_max = std::max(lbits_max, length * 8);
  }

  int64_t nb_max = std::max<int64_t>(need_blocks_max, 1);
  int64_t W = 16;
  if (offs_max >= 0) {
    nb_max = std::min(nb_max, (Lp - offs_max) / 15);
    W = std::min(lbits_max, Lp - offs_max);
  } else {
    nb_max = 1;
  }
  W = std::max({nb_max * 10, W, int64_t{16}});
  const int64_t nbytes_max = W / 8;

  // payloads of the in-range rows
  for (int64_t k = 0; k < K; ++k) {
    int32_t* m = meta + k * kCols;
    if (m[kStatus] != kOk) continue;
    const Row row{bits + k * L, L};
    const int t = m[kType];
    const int64_t off = payload_offset(t);
    const int64_t length = m[kLength];
    const int64_t n = std::min(length * 8, W);
    uint8_t* p = payload + k * pay_stride;
    if (kFec[t]) {
      // every block's 10 bits are written: 10 * nb <= 10 * nb_max < Lp,
      // within the row's pay_stride
      const int64_t nb = std::min((length * 8 + 9) / 10, nb_max);
      bool ok = true;
      for (int64_t b = 0; b < nb && ok; ++b) {
        const int d = T.fec23[row.word15(off + 15 * b)];
        ok = d >> 10;
        std::memcpy(p + 10 * b, &T.spread[d & 0xFF], 8);
        p[10 * b + 8] = static_cast<uint8_t>((d >> 8) & 1);
        p[10 * b + 9] = static_cast<uint8_t>((d >> 9) & 1);
      }
      if (!ok) {
        m[kStatus] = kFailFec;
        continue;
      }
      if (10 * nb < n) std::memset(p + 10 * nb, 0, n - 10 * nb);  // clipped
    } else {
      const int64_t avail = std::clamp<int64_t>(L - off, 0, n);
      if (avail) std::memcpy(p, row.r + off, avail);
      std::memset(p + avail, 0, n - avail);
    }
    xor_bytes(p, T.seq + T.idx[clocks[k] & 0x3F] + kHdrSkip, n);
    m[kNbits] = static_cast<int32_t>(n);

    m[kCrc] = -1;
    if (t != kNoCrcType && length >= 2 && length <= nbytes_max) {
      int reg = T.rev8[uaps[k] & 0xFF] << 8;
      const uint8_t* q = p;
      for (int64_t j = 0; j < length - 2; ++j, q += 8)
        reg = (reg >> 8) ^ T.crc[(reg ^ pack8(q)) & 0xFF];
      m[kCrc] = reg == (pack8(q) | pack8(q + 8) << 8);
    }
  }
  return 0;
}

}  // extern "C"
