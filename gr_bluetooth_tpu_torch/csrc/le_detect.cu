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
// t % 32 of word t / 32) and every offset o < n_le = n_sym - 55: the
// distance of le_dist.cuh, and hit = dist <= max_dist[r].  Outputs: the
// packed hit plane (R, w_le) int32, bit t of word w = offset 32w + t,
// zero past n_le; and, when `dist` is not null (a uniform branch), the
// dense distances (R, n_le) int32.  The step passes no dist: it reads
// only the hits (hit_table.cu recomputes a hit's distance from its
// window with the same code).
//
// Design: persistent blocks of 8 warps, at most two per SM, striding
// over warp items; an item is 30 output words of one row, and a warp's
// first item is loaded while the block stages the tables.  An item's
// lanes load the 32 row words that cover those words' offsets with one
// coalesced load, and word q's three words (q, q + 1, q + 2) come from
// broadcast shuffles (one new one per word), so no lane waits on a
// dependent global load inside the loop.  A lane takes one offset per word: its 64-symbol view is two
// funnel shifts, every field a shift and a mask, the tables (uint8,
// 2,560 bytes) in shared memory, loaded once per block; the loop over
// the item's words is unrolled so that several words' lookups are in
// flight.  The hit word is one ballot; lane j keeps word j of the item,
// and the item's hit words leave in one coalesced store.  Data rows
// (aa_on 0, uniform per item) skip the four AA lookups.
//
// Bound on an H100 SXM (40 LE rows, 3 of them advertising, n_le =
// 43,070 at full band; gr_bluetooth_tpu_torch/bench.py:le_detect_cost):
// the step form moves 0.43 MB (0.2 MB of words in, 0.2 MB of hits out),
// 0.13 us at 3.35 TB/s; its arithmetic, 13 integer operations per offset
// on a data row and 27 on an advertising row (the table lookups counted
// as one each), 24.2 M operations, takes 1.45 us at 16.75 T/s: bound by
// operations.  With the dense distances (6.9 MB more) it is bound by
// bytes, 2.2 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include "le_dist.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORDS_PER_ITEM = 30;    // lanes hold 32 words: q .. q + 31
constexpr int BLOCKS_PER_SM = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

int sm_count()
{
    static int n[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64)
        return 132;
    if (n[dev] == 0 &&
        cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
        n[dev] = 132;
    return n[dev];
}

}  // namespace

// A warp item's row constants and its lane's row word (q0 + lane, zero
// past the row); all warp-uniform but the word.
struct Item {
    int r, q0;
    uint32_t mine, white;
    int max_dist;
    bool adv;
};

__device__ __forceinline__ Item load_item(int item, int n_tiles, int lane,
                                          const uint32_t* words, int W,
                                          const long long* rows,
                                          const int* white,
                                          const float* aa_on,
                                          const int* max_dist)
{
    Item it;
    it.r = item / n_tiles;
    it.q0 = (item - it.r * n_tiles) * WORDS_PER_ITEM;
    const uint32_t* row = words + __ldg(rows + it.r) * W;
    it.mine = it.q0 + lane < W ? __ldg(row + it.q0 + lane) : 0u;
    it.white = (uint32_t)__ldg(white + it.r);
    it.max_dist = __ldg(max_dist + it.r);
    it.adv = __ldg(aa_on + it.r) > 0.5f;
    return it;
}

__global__ void __launch_bounds__(THREADS)
le_detect_kernel(const uint32_t* __restrict__ words, int W,
                 const long long* __restrict__ rows, int R,
                 const int* __restrict__ white,
                 const float* __restrict__ aa_on,
                 const int* __restrict__ max_dist, const uint8_t* pre,
                 const uint8_t* aa, const uint8_t* acc, const uint8_t* dat,
                 int n_le, int w_le, int n_tiles,
                 uint32_t* __restrict__ hitw, int* __restrict__ dist)
{
    __shared__ __align__(16) uint8_t s_tab[le::N_TABLES];
    const int lane = threadIdx.x & 31;
    const int n_items = R * n_tiles, stride = gridDim.x * WARPS;
    int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
    // the first item's loads start before the tables' barrier, so
    // that the two latencies overlap
    Item it{};
    if (item < n_items)
        it = load_item(item, n_tiles, lane, words, W, rows, white, aa_on,
                       max_dist);
    le::load_tables(s_tab, pre, aa, acc, dat);
    __syncthreads();
    const uint8_t* s_pre = s_tab;
    const uint8_t* s_aa = s_tab + le::N_PRE;
    const uint8_t* s_acc = s_aa + le::N_AA;
    const uint8_t* s_dat = s_acc + le::N_HDR;

    for (; item < n_items; item += stride) {
        if (item != blockIdx.x * WARPS + (threadIdx.x >> 5))
            it = load_item(item, n_tiles, lane, words, W, rows, white,
                           aa_on, max_dist);
        const uint8_t* hdr = it.adv ? s_acc : s_dat;
        int* drow = dist != nullptr ? dist + (long long)it.r * n_le
                                    : nullptr;
        uint32_t out = 0u;
        // word q0 + j reads words j, j + 1, j + 2 of the item: one new
        // broadcast per word, the other two carried over
        uint32_t b0 = __shfl_sync(FULL, it.mine, 0);
        uint32_t b1 = __shfl_sync(FULL, it.mine, 1);
        // a fixed count, unrolled: independent words in flight (words
        // past w_le have no offset below n_le and store nothing)
#pragma unroll 6
        for (int j = 0; j < WORDS_PER_ITEM; ++j) {
            const uint32_t b2 = __shfl_sync(FULL, it.mine, j + 2);
            const int d = le::dist(b0, b1, b2, lane, it.white, it.adv,
                                   s_pre, s_aa, hdr);
            b0 = b1;
            b1 = b2;
            const int o = 32 * (it.q0 + j) + lane;
            const bool in = o < n_le;
            if (drow != nullptr && in)
                drow[o] = d;
            const uint32_t bits = __ballot_sync(FULL,
                                                in && d <= it.max_dist);
            if (lane == j)
                out = bits;
        }
        if (lane < min(WORDS_PER_ITEM, w_le - it.q0))
            hitw[(long long)it.r * w_le + it.q0 + lane] = out;
    }
}

extern "C" int le_detect_launch(const int* words, int W,
                                const long long* rows, int R,
                                const int* white, const float* aa_on,
                                const int* max_dist,
                                const unsigned char* pre,
                                const unsigned char* aa,
                                const unsigned char* acc,
                                const unsigned char* dat, int n_le, int w_le,
                                int* hitw, int* dist, void* stream)
{
    if (R <= 0 || n_le <= 0 || w_le <= 0)
        return (int)cudaErrorInvalidValue;
    const int n_tiles = (w_le + WORDS_PER_ITEM - 1) / WORDS_PER_ITEM;
    const long long n_items = (long long)R * n_tiles;
    const long long need = (n_items + WARPS - 1) / WARPS;
    const int grid = (int)(need < BLOCKS_PER_SM * sm_count()
                               ? need : BLOCKS_PER_SM * sm_count());
    le_detect_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, rows, R, white, aa_on, max_dist, pre, aa,
        acc, dat, n_le, w_le, n_tiles, (uint32_t*)hitw, dist);
    return (int)cudaGetLastError();
}
