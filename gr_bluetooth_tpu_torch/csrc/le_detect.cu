// le_detect: LE access-address detection over the packed symbol words.
//
// A port kernel with no TPU counterpart: the JAX package computes this
// function as plain jnp outside any Pallas kernel
// (gr_bluetooth_tpu/ops/detect.py:205 _le_detect_batch_impl, reached
// from the step's LE branch, gr_bluetooth_tpu/models/frontend.py:793-808),
// which XLA fuses on the TPU.  Same function, integer arithmetic only,
// bit-exact.
//
// For LE row r (word row rows[r] of the (C, W) plane; symbol t at bit
// t % 32 of word t / 32) and every offset o < n_le = n_sym - 55, with
// v_j the symbol at o + j and F(a, k) = sum_{j<k} v_{a+j} 2^j:
//   dist = pre[F(0, 9)]
//        + hdr[0][F(40, 8) ^ white_lo] + hdr[1][F(48, 8) ^ white_hi]
//        + (aa_on ? sum_k aa[k][F(8 + 8k, 8)] : 0)
// with hdr the access-header tables on advertising rows (aa_on) and the
// data-header tables elsewhere, and hit = dist <= max_dist[r].  Outputs:
// the dense dist (R, n_le) int32 and the packed hit plane (R, w_le)
// int32, bit t of word w = offset 32w + t, zero past n_le.
//
// Design: a warp per (row, 32-offset output word), a lane per offset;
// a block holds 8 warps of 16 consecutive words each of one row (the
// grid's y), so the row's constants are uniform.  The warp loads the
// three words that cover its offsets' symbols (o .. o + 63, one
// broadcast load each); each lane takes its 64-symbol view with two
// funnel shifts, so every field is a shift and a mask.  The four
// distance tables (2,560 int32, 10 KB) sit in shared memory, loaded once
// per block.  The hit word is one ballot; the lanes' dist stores are 32
// consecutive int32 (coalesced).  Data rows (aa_on 0, a uniform branch)
// skip the four AA lookups.
//
// Bound on an H100 SXM (40 LE rows, 3 of them advertising, n_le =
// 43,070 at full band): the dist plane (6.9 MB) dominates 7.3 MB moved,
// 2.2 us at 3.35 TB/s; the arithmetic, 13 integer operations per offset
// on a data row and 27 on an advertising row (the table lookups counted
// as one each; gr_bluetooth_tpu_torch/bench.py:le_detect_cost), takes
// 1.5 us at 16.75 T/s: bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORDS_PER_WARP = 16;
constexpr int WORDS_PER_BLOCK = WARPS * WORDS_PER_WARP;
constexpr int N_PRE = 512, N_AA = 4 * 256, N_HDR = 2 * 256;

}  // namespace

__global__ void __launch_bounds__(THREADS)
le_detect_kernel(const uint32_t* __restrict__ words, int W,
                 const long long* __restrict__ rows,
                 const int* __restrict__ white,
                 const float* __restrict__ aa_on,
                 const int* __restrict__ max_dist,
                 const int* __restrict__ pre_dist,
                 const int* __restrict__ aa_dist,
                 const int* __restrict__ acc_dist,
                 const int* __restrict__ dat_dist, int n_le, int w_le,
                 uint32_t* __restrict__ hitw, int* __restrict__ dist)
{
    __shared__ int s_pre[N_PRE];
    __shared__ int s_aa[N_AA];
    __shared__ int s_acc[N_HDR];
    __shared__ int s_dat[N_HDR];
    for (int i = threadIdx.x; i < N_PRE; i += THREADS) s_pre[i] = pre_dist[i];
    for (int i = threadIdx.x; i < N_AA; i += THREADS) s_aa[i] = aa_dist[i];
    for (int i = threadIdx.x; i < N_HDR; i += THREADS) {
        s_acc[i] = acc_dist[i];
        s_dat[i] = dat_dist[i];
    }
    __syncthreads();

    // blockIdx.y = the LE row, its per-row constants warp-uniform
    const int r = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t* row = words + rows[r] * W;
    const bool adv = __ldg(aa_on + r) > 0.5f;
    const uint32_t wh = (uint32_t)__ldg(white + r);
    const int md = __ldg(max_dist + r);
    const int* hdr = adv ? s_acc : s_dat;
    int* drow = dist + (long long)r * n_le;
    const int q0 = blockIdx.x * WORDS_PER_BLOCK + warp * WORDS_PER_WARP;
    for (int q = q0; q < q0 + WORDS_PER_WARP && q < w_le; ++q) {
        const uint32_t b0 = q < W ? __ldg(row + q) : 0u;
        const uint32_t b1 = q + 1 < W ? __ldg(row + q + 1) : 0u;
        const uint32_t b2 = q + 2 < W ? __ldg(row + q + 2) : 0u;
        // bit j of lo / hi = symbol o + j / o + 32 + j, o = 32q + lane
        const uint32_t lo = __funnelshift_r(b0, b1, lane);
        const uint32_t hi = __funnelshift_r(b1, b2, lane);
        const uint32_t h = ((hi >> 8) ^ wh) & 0xFFFFu;
        int d = s_pre[lo & 0x1FFu] + hdr[h & 0xFFu] + hdr[256 + (h >> 8)];
        if (adv)
            d += s_aa[(lo >> 8) & 0xFFu] + s_aa[256 + ((lo >> 16) & 0xFFu)] +
                 s_aa[512 + (lo >> 24)] + s_aa[768 + (hi & 0xFFu)];
        const int o = 32 * q + lane;
        const bool in = o < n_le;
        if (in) drow[o] = d;
        const uint32_t bits = __ballot_sync(0xFFFFFFFFu, in && d <= md);
        if (lane == 0) hitw[(long long)r * w_le + q] = bits;
    }
}

extern "C" int le_detect_launch(const int* words, int W,
                                const long long* rows, int R,
                                const int* white, const float* aa_on,
                                const int* max_dist, const int* pre_dist,
                                const int* aa_dist, const int* acc_dist,
                                const int* dat_dist, int n_le, int w_le,
                                int* hitw, int* dist, void* stream)
{
    if (R <= 0 || R > 65535 || n_le <= 0 || w_le <= 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((w_le + WORDS_PER_BLOCK - 1) / WORDS_PER_BLOCK),
                    (unsigned)R);
    le_detect_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, rows, white, aa_on, max_dist, pre_dist,
        aa_dist, acc_dist, dat_dist, n_le, w_le, (uint32_t*)hitw, dist);
    return (int)cudaGetLastError();
}
