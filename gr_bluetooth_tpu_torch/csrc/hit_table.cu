// hit_table: a packed hit plane -> the step's fixed-size hit table.
//
// A port kernel with no TPU counterpart: the JAX package computes this
// tail as plain jnp outside any Pallas kernel
// (gr_bluetooth_tpu/models/frontend.py:750-808: the packed squelch AND,
// _extract_hits_packed, _gather_windows, the classic rows' A68 product
// and, for LE, _extract_hits with the distance payload).  Same function,
// integer arithmetic only, bit-exact (gr_bluetooth_tpu_torch/ops/
// hit_table.py states it):
//   1. gate every word of the (R, w) hit plane with the packed squelch
//      (snr >= squelch in float32; word j's low mask_a[j] bits in slot
//      s0[j], the rest in s0[j] + 1, slot S mirroring S - 1);
//   2. count every set bit (the count may exceed max_hits);
//   3. take the first max_hits set bits in row-major order;
//   4. gather each hit's window bit-aligned from its word row (rows[r]);
//   5. write the rows, -1 past the count: classic [r, off, LAP, errors],
//      the errors the popcount of the window's 68 bits XOR the access
//      code the LAP predicts (24 LAP-bit masks and C68, three words
//      each: ops/detect_kernel.ac_masks; integer parity, which equals the
//      plain version's float32 product because every value is 0/1 and
//      every sum at most 25); LE [r, off, dist], dist from le_dist.cuh,
//      the code le_detect.cu runs at every offset.
//
// Design: a single pass of a grid, one block per 1,024-word tile of the
// flat plane, with a decoupled look-back for the ranks.  A block takes
// its tile in launch order (a ticket), so it waits only on blocks that
// already run.  Its threads load four words each (one 16-byte load),
// gate them (the gate's per-(row, slot) bits of the tile's rows staged
// in shared memory), popcount them and scan the block; warp 0 publishes
// the tile's count, looks back over the preceding tiles' published
// counts 32 at a time until an inclusive prefix, and publishes the
// tile's own.  A block whose ranks start below max_hits lists its hits'
// bit indices and fills their rows, a warp per hit: the window's words
// from the word row (one funnel shift each, coalesced), then the
// epilogue from its first three words.  The last tile knows the total:
// it writes the count and the rows past it (-1, zero windows; one
// contiguous range each).  The look-back's ticket and tile states are
// the wrapper's zeroed scratch, one per call.
//
// Bound on an H100 SXM (full band: the 79 x 1,346-word classic plane,
// 425 KB, or the 40 x 1,346-word LE plane; max_hits 192 rows of 101
// window words, 512 of 17 for LE): bytes, about 0.6 MB classic
// (gr_bluetooth_tpu_torch/bench.py:hit_table_cost), 0.17 us at
// 3.35 TB/s.  The tiles' gating and popcounts spread over the card (104
// blocks classic, 53 LE); what is left is latency: the ticket, the
// look-back's chain of L2 round trips and a hit's dependent window
// loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "le_dist.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4 * THREADS;     // plane words per block
constexpr unsigned FULL = 0xFFFFFFFFu;
// a tile's published state: flag in the high word, count in the low
constexpr unsigned long long AGGREGATE = 1ull << 32, INCLUSIVE = 2ull << 32;

struct Plane {
    const uint32_t* hitw;
    int n, w;                         // R * w words, w per row
    const uint8_t* gate;              // (rows r0.., S + 1) shared, or null
    int r0, s1;                       // first gate row; S + 1
    const long long* s0;
    const int* ma;
};

// The squelch word of (row r, column col).
__device__ __forceinline__ uint32_t gate_word(const Plane& P, int r,
                                              int col)
{
    const long long s = __ldg(P.s0 + col);
    const int S = P.s1 - 1;
    const int a = (int)(s < S ? s : S);
    const int b = (int)(s + 1 < S ? s + 1 : S);
    const uint32_t ma = (uint32_t)__ldg(P.ma + col);
    const uint8_t* g = P.gate + (r - P.r0) * P.s1;
    return (g[a] ? ma : 0u) | (g[b] ? ~ma : 0u);
}

// The four words of flat index i0 (a multiple of 4), zero past n, gated.
__device__ __forceinline__ void load4(const Plane& P, int i0, uint32_t v[4])
{
    if (i0 + 3 < P.n) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(P.hitw + i0));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = i0 + j < P.n ? __ldg(P.hitw + i0 + j) : 0u;
    }
    if (P.gate == nullptr || i0 >= P.n)
        return;
    int r = i0 / P.w, col = i0 - r * P.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (col == P.w) {
            col = 0;
            ++r;
        }
        if (i0 + j < P.n)
            v[j] &= gate_word(P, r, col);
        ++col;
    }
}

// Exclusive scan of x over the warp; *total gets the warp's sum.
__device__ __forceinline__ int warp_exclusive(int x, int lane, int* total)
{
    int s = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, s, d);
        if (lane >= d)
            s += t;
    }
    *total = __shfl_sync(FULL, s, 31);
    return s - x;
}

__device__ __forceinline__ void publish(unsigned long long* status, int t,
                                        unsigned long long flag, int count)
{
    atomicExch(status + t, flag | (unsigned)count);
}

// The exclusive prefix of tile t (t > 0): warp 0 reads the states of the
// 32 tiles before a window end, waiting for each to be published, and
// sums them back to the nearest inclusive one.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int t, int lane)
{
    int prefix = 0;
    for (int end = t - 1;; end -= 32) {
        const int p = end - lane;
        unsigned long long s = INCLUSIVE;         // before tile 0: 0
        if (p >= 0) {
            do {
                s = *reinterpret_cast<const volatile unsigned long long*>(
                    status + p);
            } while ((s >> 32) == 0);
        }
        const unsigned incl = __ballot_sync(FULL, s >= INCLUSIVE);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        prefix += __reduce_add_sync(FULL, lane <= stop ? (int)(unsigned)s
                                                       : 0);
        if (incl)
            return prefix;
    }
}

}  // namespace

template <bool LE>
__global__ void __launch_bounds__(THREADS)
hit_table_kernel(const uint32_t* __restrict__ hitw, int R, int w,
                 const uint32_t* __restrict__ words, int W,
                 const long long* __restrict__ rows,
                 const float* __restrict__ snr, int S, int st_s, int st_c,
                 const long long* __restrict__ s0,
                 const int* __restrict__ ma, float squelch, int use_gate,
                 int max_hits, int ww, const int* __restrict__ masks,
                 const int* __restrict__ white,
                 const float* __restrict__ aa_on, const uint8_t* pre,
                 const uint8_t* aa, const uint8_t* acc, const uint8_t* dat,
                 unsigned long long* __restrict__ state, int n_tiles,
                 int* __restrict__ count, int* __restrict__ tab,
                 uint32_t* __restrict__ win)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(16) uint8_t s_tab[LE ? le::N_TABLES : 4];
    __shared__ uint32_t s_mask[75];
    __shared__ int s_warp[WARPS];
    __shared__ int s_t, s_agg, s_prefix;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* list = reinterpret_cast<int*>(smem);          // max_hits
    uint8_t* gsh = reinterpret_cast<uint8_t*>(list + max_hits);
    unsigned long long* status = state + 1;

    // the tile, in launch order
    if (tid == 0)
        s_t = (int)atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
    __syncthreads();
    const int t = s_t;
    const int n = R * w;
    const int i_first = t * TILE;
    Plane P{hitw, n, w, nullptr, i_first / w, S + 1, s0, ma};
    if (use_gate) {
        // the gate bits of the tile's rows
        const int r_end = (min(i_first + TILE, n) - 1) / w + 1;
        for (int i = tid; i < (r_end - P.r0) * (S + 1); i += THREADS) {
            const int dr = i / (S + 1), s = i - dr * (S + 1);
            const long long r = P.r0 + dr;
            const long long c = rows != nullptr ? rows[r] : r;
            const long long slot = s < S ? s : S - 1;
            gsh[i] = snr[slot * st_s + c * st_c] >= squelch;
        }
        P.gate = gsh;
        __syncthreads();
    }

    // ---- the tile's gated words and their ranks within it
    const int i0 = i_first + 4 * tid;
    uint32_t v[4];
    load4(P, i0, v);
    const int c = __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
    int wsum;
    int ex = warp_exclusive(c, lane, &wsum);
    if (lane == 0)
        s_warp[warp] = wsum;
    __syncthreads();
    if (warp == 0) {
        int agg;
        const int x = lane < WARPS ? s_warp[lane] : 0;
        const int e = warp_exclusive(x, lane, &agg);
        if (lane < WARPS)
            s_warp[lane] = e;
        // ---- the tile's first rank: decoupled look-back
        int prefix = 0;
        if (t == 0) {
            if (lane == 0)
                publish(status, 0, INCLUSIVE, agg);
        } else {
            if (lane == 0)
                publish(status, t, AGGREGATE, agg);
            prefix = look_back(status, t, lane);
            if (lane == 0)
                publish(status, t, INCLUSIVE, prefix + agg);
        }
        if (lane == 0) {
            s_agg = agg;
            s_prefix = prefix;
        }
    }
    __syncthreads();
    ex += s_warp[warp];
    const int first = s_prefix, agg = s_agg;

    // ---- the tile's hits of rank < max_hits: their rows
    const int n_mine = min(agg, max(0, max_hits - first));
    if (n_mine > 0) {                                  // block-uniform
        int rank = first + ex;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            uint32_t x = v[j];
            while (x != 0u && rank < max_hits) {
                list[rank - first] = (i0 + j) * 32 + (__ffs(x) - 1);
                x &= x - 1u;
                ++rank;
            }
        }
        if constexpr (LE)
            le::load_tables(s_tab, pre, aa, acc, dat);
        else if (tid < 75)
            s_mask[tid] = (uint32_t)masks[tid];
        __syncthreads();
        for (int k = warp; k < n_mine; k += WARPS) {
            const int idx = list[k];
            const int i = idx >> 5, sh = idx & 31;
            const int r = i / w, col = i - r * w;
            const int off = 32 * col + sh;
            const uint32_t* src = words +
                (rows != nullptr ? rows[r] : (long long)r) * W;
            uint32_t* wrow = win + (long long)(first + k) * ww;
            uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
            for (int j0 = 0; j0 < ww; j0 += 32) {
                const int j = j0 + lane;
                const uint32_t u = j < ww && col + j < W
                                       ? __ldg(src + col + j) : 0u;
                const uint32_t nx = j + 1 < ww && col + j + 1 < W
                                        ? __ldg(src + col + j + 1) : 0u;
                const uint32_t o = __funnelshift_r(u, nx, sh);
                if (j < ww)
                    wrow[j] = o;
                if (j0 == 0) {
                    w0 = __shfl_sync(FULL, o, 0);
                    w1 = __shfl_sync(FULL, o, 1);
                    w2 = __shfl_sync(FULL, o, 2);
                }
            }
            if constexpr (LE) {
                int* trow = tab + (long long)(first + k) * 3;
                const bool adv = __ldg(aa_on + r) > 0.5f;
                const int d = le::dist(
                    w0, w1, w2, 0, (uint32_t)__ldg(white + r), adv, s_tab,
                    s_tab + le::N_PRE,
                    s_tab + le::N_PRE + le::N_AA + (adv ? 0 : le::N_HDR));
                if (lane == 0) {
                    trow[0] = r;
                    trow[1] = off;
                    trow[2] = d;
                }
            } else {
                int* trow = tab + (long long)(first + k) * 4;
                const uint32_t lap = (w1 >> 6) & 0xFFFFFFu;
                const bool on = lane < 24 && ((lap >> lane) & 1u);
                const uint32_t p0 = __reduce_xor_sync(
                    FULL, on ? s_mask[3 * lane] : 0u);
                const uint32_t p1 = __reduce_xor_sync(
                    FULL, on ? s_mask[3 * lane + 1] : 0u);
                const uint32_t p2 = __reduce_xor_sync(
                    FULL, on ? s_mask[3 * lane + 2] : 0u);
                const int err = __popc(w0 ^ p0 ^ s_mask[72]) +
                                __popc(w1 ^ p1 ^ s_mask[73]) +
                                __popc((w2 ^ p2 ^ s_mask[74]) & 0xFu);
                if (lane == 0) {
                    trow[0] = r;
                    trow[1] = off;
                    trow[2] = (int)lap;
                    trow[3] = err;
                }
            }
        }
    }

    // ---- the last tile: the count, and the rows past it
    if (t == n_tiles - 1) {
        const int total = first + agg;
        const int K = min(total, max_hits);
        const int cols = LE ? 3 : 4;
        if (tid == 0)
            *count = total;
        for (long long i = (long long)K * ww + tid;
             i < (long long)max_hits * ww; i += THREADS)
            win[i] = 0u;
        for (int i = K * cols + tid; i < max_hits * cols; i += THREADS)
            tab[i] = -1;
    }
}

extern "C" int hit_table_launch(
    const int* hitw, int R, int w, const int* words, int W,
    const long long* rows, const float* snr, int S, int st_s, int st_c,
    const long long* s0, const int* ma, float squelch, int use_gate,
    int max_hits, int ww, const int* masks, const int* white,
    const float* aa_on, const unsigned char* pre, const unsigned char* aa,
    const unsigned char* acc, const unsigned char* dat, long long* state,
    int* count, int* tab, int* win, void* stream)
{
    const bool le = masks == nullptr;
    if (R <= 0 || w <= 0 || w > W || max_hits <= 0 || ww < 3 ||
        (use_gate && S <= 0) || (le && (white == nullptr ||
                                       aa_on == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int n_tiles = (int)(((long long)R * w + TILE - 1) / TILE);
    const int gate_rows = (TILE - 1) / w + 2 < R ? (TILE - 1) / w + 2 : R;
    const size_t smem = (size_t)max_hits * sizeof(int) +
                        (use_gate ? (size_t)gate_rows * (S + 1) : 0);
    auto kernel = le ? hit_table_kernel<true> : hit_table_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    kernel<<<n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)hitw, R, w, (const uint32_t*)words, W, rows, snr, S,
        st_s, st_c, s0, ma, squelch, use_gate, max_hits, ww, masks, white,
        aa_on, pre, aa, acc, dat, (unsigned long long*)state, n_tiles, count,
        tab, (uint32_t*)win);
    return (int)cudaGetLastError();
}
