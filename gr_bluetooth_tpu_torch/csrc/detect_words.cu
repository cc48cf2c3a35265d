// detect_words: bit-packed classic access-code detection, bit-sliced.
//
// Replaces gr_bluetooth_tpu/ops/detect_pallas.py:_planes_padded (reached
// through detect_words): the same hit and gate planes and, with emit_err,
// the same 7 bit-sliced error-count planes w1 ... w64 (LSB first),
// integer arithmetic only, bit-exact.  Output: planes (2 or 9, C, n_words)
// int32 = [hit, gate, w1, w2, ..., w64], the JAX kernel's (N_PLANES, C, W').
//
// For every candidate offset o < n, with v_j the symbol at o + j (zero
// past the words):
//   err  = #{j < 68 : v_j != pred_j},  pred = A68 v[38:62] + C68 (GF(2))
//   pre  = min(d, 5 - d), d = mismatches of v[0:5] with 10101
//   bark = min(d, 7 - d), d = mismatches of v[61:68] with 1110010
//   gate = pre + bark <= 2,  hit = gate & (err <= max_ac_errors)
// and offsets >= n are zero in the hit and gate planes.  The error planes
// are not masked at offsets >= n (nor are the JAX kernel's): there they
// hold the count of the window read with zeros past the words' end.
//
// Design: the TPU kernel's bit-sliced formulation, one thread per output
// word, so that each 32-bit operation serves that word's 32 offsets.  The
// thread loads words q .. q+3 of its row (neighbouring threads on
// neighbouring words); the view v_j (bit b = symbol 32q + b + j) is one
// funnel shift (SHF) of two of them, or a word itself.  The map A68/C68
// is compiled in (ac_table.cuh) and every loop over symbols and LAP bits
// is unrolled at compile time, so each error plane v_j ^ pred_j is an XOR
// chain of exactly the LAP views its row names, which ptxas merges into
// three-input LOP3s; the 24 planes of the LAP symbols, zero for every
// window, are left out.  The 44 others are counted by carry-save adders
// (a full adder is two LOP3s: XOR3 and majority) into the counter
// planes, the 5 preamble and 7 Barker mismatch planes likewise into 3
// each, and the gate and err <= max_ac_errors are bitwise functions of
// those planes (max_ac_errors is a kernel argument: one uniform branch
// per counter bit).
//
// Bound on an H100 SXM (79 rows x 1,346 output words): 1.3 MB of words
// and planes move in 0.4 us; the instructions (LOP3 and SHF, 64 lanes per
// SM and clock, 16.75 T/s), 407 per word at max_ac_errors = 1 as
// chip_smoke.py:detect_instr_per_word counts them, take 2.6 us: bound by
// operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "ac_table.cuh"

namespace {

constexpr int N_ERR = 7;                 // counter planes: counts 0..127
constexpr int NE = ac::n_planes();       // error planes that can be set
constexpr int THREADS = 128;

// bit b = symbol 32q + b + J of the thread's word q (B = words q .. q+3)
template <int J>
__device__ __forceinline__ uint32_t view(const uint32_t (&B)[4])
{
    if constexpr (J % 32 == 0)
        return B[J / 32];
    else
        return __funnelshift_r(B[J / 32], B[J / 32 + 1], J % 32);
}

// v_J ^ pred_J: the LAP views of row J first, so that rows with equal
// masks (0-4, 62-67) share their chain
template <int J>
__device__ __forceinline__ uint32_t err_plane(const uint32_t (&B)[4],
                                              const uint32_t (&lap)[24])
{
    constexpr uint32_t row = ac::a68_row(J);
    uint32_t x = 0u;
#pragma unroll
    for (int k = 0; k < 24; ++k)
        if ((row >> k) & 1u) x ^= lap[k];
    x ^= view<J>(B);
    return ac::c68(J) ? ~x : x;
}

template <int... K>
__device__ __forceinline__ void lap_views(std::integer_sequence<int, K...>,
                                          const uint32_t (&B)[4],
                                          uint32_t (&lap)[24])
{
    ((lap[K] = view<38 + K>(B)), ...);
}

template <int... I>
__device__ __forceinline__ void err_planes(std::integer_sequence<int, I...>,
                                           const uint32_t (&B)[4],
                                           const uint32_t (&lap)[24],
                                           uint32_t (&e)[NE])
{
    ((e[I] = err_plane<ac::plane_symbol(I)>(B, lap)), ...);
}

// n planes of one weight -> their sum plane (returned) and n / 2 carry
// planes of the next weight: full adders taken breadth first (a Wallace
// tree; q is the queue of planes), then a half adder where two remain
template <int N>
__device__ __forceinline__ uint32_t add_weight(const uint32_t (&p)[N],
                                               uint32_t (&cy)[N / 2])
{
    constexpr int NF = N >= 3 ? (N - 1) / 2 : 0;
    uint32_t q[N + NF];
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = p[i];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
        const uint32_t a = q[3 * i], b = q[3 * i + 1], c = q[3 * i + 2];
        q[N + i] = a ^ b ^ c;
        cy[i] = (a & b) | (c & (a ^ b));
    }
    if constexpr (N - 2 * NF == 2) {
        cy[NF] = q[3 * NF] & q[3 * NF + 1];
        return q[3 * NF] ^ q[3 * NF + 1];
    } else {
        return q[3 * NF];
    }
}

// The popcount of N one-bit planes as counter planes w[W ...] (weight
// 2^W first), zero above the highest
template <int N, int W, int NB>
__device__ __forceinline__ void count(const uint32_t (&p)[N],
                                      uint32_t (&w)[NB])
{
    static_assert(N >= 1 && W < NB, "the counter planes hold the count");
    if constexpr (N == 1) {
        w[W] = p[0];
#pragma unroll
        for (int b = W + 1; b < NB; ++b) w[b] = 0u;
    } else {
        uint32_t cy[N / 2];
        w[W] = add_weight<N>(p, cy);
        count<N / 2, W + 1, NB>(cy, w);
    }
}

// The hit, gate and error-count planes of the 32 offsets of one word
__device__ __forceinline__ void detect_word(const uint32_t (&B)[4],
                                            int max_err, uint32_t& hit,
                                            uint32_t& gate,
                                            uint32_t (&err)[N_ERR])
{
    uint32_t lap[24], e[NE];
    lap_views(std::make_integer_sequence<int, 24>{}, B, lap);
    err_planes(std::make_integer_sequence<int, NE>{}, B, lap, e);
    count<NE, 0, N_ERR>(e, err);

    // preamble and Barker mismatches; pre = min(dp, 5 - dp) is 2 where
    // dp in {2, 3} (bit 1), else 1 where dp in {1, 4} (bit 0 != bit 2);
    // bark <= 2 unless db in {3, 4}, <= 1 where db in {0, 1, 6, 7}
    // (bit 1 == bit 2), 0 where db in {0, 7} (all bits equal)
    // (a symbol's mismatch is its view, complemented where the pattern
    // has a 1: preamble 1,0,1,0,1; Barker 1,1,1,0,0,1,0)
    const uint32_t pm[5] = {
        ~view<0>(B), view<1>(B), ~view<2>(B), view<3>(B), ~view<4>(B)};
    const uint32_t bm[7] = {~view<61>(B), ~view<62>(B), ~view<63>(B),
                            view<64>(B), view<65>(B), ~view<66>(B),
                            view<67>(B)};
    uint32_t dp[3], db[3];
    count<5, 0, 3>(pm, dp);
    count<7, 0, 3>(bm, db);
    const uint32_t pre1 = dp[0] ^ dp[2];
    const uint32_t b12 = ~(db[1] ^ db[2]);
    const uint32_t bark0 = b12 & ~(db[0] ^ db[1]);
    const uint32_t bark_le2 = (db[0] ^ db[1]) | b12;
    gate = (dp[1] & bark0) | (~dp[1] & ((pre1 & b12) | (~pre1 & bark_le2)));

    // err <= max_err over the counter planes, most significant first
    uint32_t le = 0u;
    if (max_err >= 0) {
        const int k = max_err < (1 << N_ERR) ? max_err : (1 << N_ERR) - 1;
        uint32_t lt = 0u, eq = ~0u;
#pragma unroll
        for (int b = N_ERR - 1; b >= 0; --b) {
            if ((k >> b) & 1) {
                lt |= eq & ~err[b];
                eq &= err[b];
            } else {
                eq &= ~err[b];
            }
        }
        le = lt | eq;
    }
    hit = gate & le;
}

}  // namespace

template <bool EMIT_ERR>
__global__ void __launch_bounds__(THREADS)
detect_words_kernel(const uint32_t* __restrict__ words, int C, int W, int n,
                    int max_err, int n_words, int* __restrict__ planes)
{
    const int g = blockIdx.x * THREADS + threadIdx.x;
    if (g >= C * n_words) return;
    const int c = g / n_words, q = g - c * n_words;
    const uint32_t* row = words + (long long)c * W;
    uint32_t B[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) B[i] = q + i < W ? __ldg(row + q + i) : 0u;

    uint32_t hit, gate, err[N_ERR];
    detect_word(B, max_err, hit, gate, err);
    // offsets >= n: none in the hit and gate planes
    const int left = n - 32 * q;
    if (left < 32) {
        const uint32_t tail = (1u << left) - 1u;
        hit &= tail;
        gate &= tail;
    }
    const long long plane = (long long)C * n_words;
    int* out = planes + g;
    out[0] = (int)hit;
    out[plane] = (int)gate;
    if constexpr (EMIT_ERR) {
#pragma unroll
        for (int b = 0; b < N_ERR; ++b) out[(2 + b) * plane] = (int)err[b];
    }
}

extern "C" int detect_words_launch(const int* words, int C, int W, int n,
                                   int max_err, int* planes, int n_words,
                                   int emit_err, void* stream)
{
    const unsigned grid = (unsigned)((C * n_words + THREADS - 1) / THREADS);
    if (emit_err)
        detect_words_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, C, W, n, max_err, n_words, planes);
    else
        detect_words_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, C, W, n, max_err, n_words, planes);
    return (int)cudaGetLastError();
}
