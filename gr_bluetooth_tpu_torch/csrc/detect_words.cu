// detect_words: bit-packed classic access-code detection.
//
// Replaces gr_bluetooth_tpu/ops/detect_pallas.py:_planes_padded (reached
// through detect_words): the same hit and gate planes and, with emit_err,
// the same 7 bit-sliced error-count planes w1 ... w64 (LSB first),
// integer arithmetic only, bit-exact.  Output: planes (2 or 9, C, n_words)
// int32 = [hit, gate, w1, w2, ..., w64], the JAX kernel's (N_PLANES, C, W').
//
// One thread per candidate offset o (one warp per 32-offset output word).
// The thread funnel-shifts the 68-symbol window out of words q..q+3
// (q = o / 32; words past W read as zero), predicts the access code from
// the window's 24 LAP bits (symbols 38..61) with the affine GF(2) map
// A68/C68 (24 conditional XORs of 68-bit column masks), and counts
//   err  = popcount(window ^ prediction) over the 68 symbols
//   pre  = min(d, 5 - d), d = mismatches of symbols 0..4 with 10101
//   bark = min(d, 7 - d), d = mismatches of symbols 61..67 with 1110010
// hit = (pre + bark <= 2) & (err <= max_ac_errors); gate = pre + bark <= 2.
// The warp's ballots are the hit and gate words; offsets >= n are zero.
// With emit_err the warp ballots bit b of err, b = 0..6, into plane 2 + b.
// Those planes are not masked at offsets >= n (nor are the JAX kernel's):
// there they hold the error count of the window read with zeros past the
// words' end, as the JAX planes do.  Callers read them at offsets < n.
//
// Bound on an H100 SXM (79 rows x 1,346 output words = 43,054 offsets
// per row): 1.3 MB of words and planes move in 0.4 us.  The function
// needs the operations of the TPU kernel's bit-sliced form, where one
// uint32 operation serves 32 offsets: 1,022 two-input integer operations
// per 32-offset word at max_ac_errors = 1 (65 funnel shifts, 532 XORs
// and complements of the affine prediction and error planes, 347 in the
// carry-save popcounts, 78 for the gate, err <= 1, hit and tail mask;
// counted by chip_smoke.py:detect_ops_per_word), 0.109 G operations,
// 6.5 us at the 16.75 T/s int32/logical rate: bound by operations.  This first version
// does one offset per thread and nothing more; it spends several times
// that (about 9 operations per LAP bit for the prediction alone).  The
// bit-sliced form is work for a later PR.

#include <cuda_runtime.h>

template <bool EMIT_ERR>
__global__ void detect_words_kernel(const unsigned* __restrict__ words,
                                    int W, int n, int max_err,
                                    const unsigned* __restrict__ masks,
                                    int n_words,
                                    int* __restrict__ planes)
{
    __shared__ unsigned am[75];          // A68 columns (24 x 3), C68 (3)
    for (int i = threadIdx.x; i < 75; i += blockDim.x) am[i] = masks[i];
    __syncthreads();

    const int c = blockIdx.y;
    const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int q = (int)(o >> 5), r = (int)(o & 31);
    const unsigned* row = words + (long long)c * W;
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = (q + i < W) ? row[q + i] : 0u;
    unsigned v0 = __funnelshift_r(w[0], w[1], r);
    unsigned v1 = __funnelshift_r(w[1], w[2], r);
    unsigned v2 = __funnelshift_r(w[2], w[3], r) & 0xFu;

    unsigned lap = (v1 >> 6) & 0xFFFFFFu;
    unsigned p0 = am[72], p1 = am[73], p2 = am[74];
#pragma unroll
    for (int k = 0; k < 24; ++k) {
        unsigned sel = 0u - ((lap >> k) & 1u);
        p0 ^= am[3 * k] & sel;
        p1 ^= am[3 * k + 1] & sel;
        p2 ^= am[3 * k + 2] & sel;
    }
    int err = __popc(v0 ^ p0) + __popc(v1 ^ p1) + __popc((v2 ^ p2) & 0xFu);
    int dp = __popc((v0 ^ 0x15u) & 0x1Fu);
    int pm = min(dp, 5 - dp);
    unsigned bark = ((v1 >> 29) | (v2 << 3)) & 0x7Fu;
    int db = __popc(bark ^ 0x27u);
    int bm = min(db, 7 - db);
    bool in_range = o < n;
    bool g = in_range && (pm + bm <= 2);
    bool h = g && (err <= max_err);
    unsigned hw = __ballot_sync(0xffffffffu, h);
    unsigned gw = __ballot_sync(0xffffffffu, g);
    const long long plane = (long long)gridDim.y * n_words;
    int* out = planes + (long long)c * n_words + q;
    if ((threadIdx.x & 31) == 0 && q < n_words) {
        out[0] = (int)hw;
        out[plane] = (int)gw;
    }
    if (EMIT_ERR) {
#pragma unroll
        for (int b = 0; b < 7; ++b) {
            unsigned ew = __ballot_sync(0xffffffffu, (err >> b) & 1);
            if ((threadIdx.x & 31) == 0 && q < n_words)
                out[(2 + b) * plane] = (int)ew;
        }
    }
}

extern "C" int detect_words_launch(const int* words, int C, int W, int n,
                                   int max_err, const int* masks,
                                   int* planes, int n_words, int emit_err,
                                   void* stream)
{
    const int threads = 256;
    long long offsets = (long long)n_words * 32;
    dim3 grid((unsigned)((offsets + threads - 1) / threads), C);
    if (emit_err)
        detect_words_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const unsigned*)words, W, n, max_err, (const unsigned*)masks,
            n_words, planes);
    else
        detect_words_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const unsigned*)words, W, n, max_err, (const unsigned*)masks,
            n_words, planes);
    return (int)cudaGetLastError();
}
