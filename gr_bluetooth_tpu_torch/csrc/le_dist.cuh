// le_dist.cuh: the LE detector's distance at one offset, shared by
// le_detect.cu (every offset of every LE row) and hit_table.cu (each LE
// hit's bit-aligned window), so that both compute a hit's distance with
// the same code.
//
// b0, b1, b2 are three consecutive words of a row (symbol t at bit
// t % 32); the offset is `shift` bits into b0.  With v_j the symbol at
// offset + j and F(a, k) = sum_{j<k} v_{a+j} 2^j:
//   dist = pre[F(0, 9)]
//        + hdr[F(40, 8) ^ white_lo] + hdr[256 + F(48, 8) ^ white_hi]
//        + (adv ? sum_k aa[256 k + F(8 + 8k, 8)] : 0)
// (gr_bluetooth_tpu/ops/detect.py:205 _le_detect_batch_impl).  The
// tables are the generated uint8 distance tables (core/le_tables.py):
// pre (512), aa (4 x 256), and hdr the access-header (advertising rows)
// or data-header table (2 x 256).
#pragma once

#include <stdint.h>

namespace le {

constexpr int N_PRE = 512, N_AA = 4 * 256, N_HDR = 2 * 256;
constexpr int N_TABLES = N_PRE + N_AA + 2 * N_HDR;   // 2,560 bytes

__device__ __forceinline__ int dist(uint32_t b0, uint32_t b1, uint32_t b2,
                                    int shift, uint32_t white, bool adv,
                                    const uint8_t* pre, const uint8_t* aa,
                                    const uint8_t* hdr)
{
    // bit j of lo / hi = symbol offset + j / offset + 32 + j
    const uint32_t lo = __funnelshift_r(b0, b1, shift);
    const uint32_t hi = __funnelshift_r(b1, b2, shift);
    const uint32_t h = ((hi >> 8) ^ white) & 0xFFFFu;
    int d = pre[lo & 0x1FFu] + hdr[h & 0xFFu] + hdr[256 + (h >> 8)];
    if (adv)
        d += aa[(lo >> 8) & 0xFFu] + aa[256 + ((lo >> 16) & 0xFFu)] +
             aa[512 + (lo >> 24)] + aa[768 + (hi & 0xFFu)];
    return d;
}

// Word i (i < N_TABLES / 4) of the four tables (global, uint8, as the
// wrappers pass them) laid out as one array pre | aa | acc | dat: its
// address.
__device__ __forceinline__ const uint32_t* table_word(int i,
                                                      const uint8_t* pre,
                                                      const uint8_t* aa,
                                                      const uint8_t* acc,
                                                      const uint8_t* dat)
{
    const int b = 4 * i;
    const uint8_t* src = b < N_PRE ? pre + b
                       : b < N_PRE + N_AA ? aa + (b - N_PRE)
                       : b < N_PRE + N_AA + N_HDR
                           ? acc + (b - N_PRE - N_AA)
                           : dat + (b - N_PRE - N_AA - N_HDR);
    return reinterpret_cast<const uint32_t*>(src);
}

// The four tables into one shared array laid out as table_word lays
// them out, by all threads of a block in 32-bit words; the caller
// synchronises.
__device__ __forceinline__ void load_tables(uint8_t* s, const uint8_t* pre,
                                            const uint8_t* aa,
                                            const uint8_t* acc,
                                            const uint8_t* dat)
{
    uint32_t* s32 = reinterpret_cast<uint32_t*>(s);
    for (int i = threadIdx.x; i < N_TABLES / 4; i += blockDim.x)
        s32[i] = __ldg(table_word(i, pre, aa, acc, dat));
}

}  // namespace le
