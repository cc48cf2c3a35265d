// hit_table: packed hit planes -> the step's fixed-size hit tables.
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
// Bound on an H100 SXM (full band: the 79 x 1,346-word classic plane,
// 425 KB, or the 40 x 1,346-word LE plane; max_hits 192 rows of 101
// window words, 512 of 17 for LE): bytes, about 0.6 MB classic
// (gr_bluetooth_tpu_torch/bench.py:hit_table_cost), 0.17 us at
// 3.35 TB/s.  In practice it is latency: the plane's ranks are a prefix
// sum over the whole plane, and each listed hit then needs dependent
// loads of its window.
//
// Design: one thread-block cluster per tail, no scratch.  The cluster's
// CLUSTER = 16 blocks of 1,024 threads (the non-portable size, which
// beat the portable 8 on an H100 SXM) each take a contiguous 1/16 of the
// flat plane (ops/hit_table.py:cluster_split).  Within a block a warp
// takes 256 consecutive words, lane l the four from 4 l and the four from
// 128 + 4 l of them, each one 16-byte load, so every load of the plane
// is coalesced (one pass of the block covers 8,192 words; a longer
// range loops).
//   Prologue, one round of loads (LE: two, its SNR columns through the
// row map): the thread's words, and into shared memory each column's
// squelch slot and mask, the squelch bit of each (row, slot) of the
// block's rows, their row map and, for LE, their constants and the
// distance tables (classic: the masks).
//   Ranks: the gated words' popcounts are scanned within the lane, over
// the lanes (one shuffle scan, the two halves' counts packed) and over
// the warps (one shuffle scan), which gives each word its rank within
// the block and the block's count (a warp with no set bit skips its
// scan, and a zero word its gate).  The blocks' counts then go through
// distributed shared memory: once every block of the cluster has
// started (a first cluster barrier, arrived at on entry, its wait hidden
// behind the prologue and the scan), each block writes its count into
// every block's shared memory (map_shared_rank) and arrives at a second
// one; while that is pending it lists its hits of block rank below
// max_hits and each warp gathers its first hit's window and row into
// registers; after the wait, every warp reads the 16 counts locally
// for the block's base and the total.  That replaces a grid-wide
// look-back (its ticket, its published tile states, the per-call zeroed
// scratch and the memset that cleared it).
//   Code size is time here: the step runs this kernel after the
// channelizer, whose code has displaced this one's from the SMs'
// instruction caches, so the body is one copy for both tails (the
// cluster's index picks the tail's parameters) and not one per tail.
//   Epilogue: the hits of rank base + k < max_hits are written, a warp
// per hit: the window's words in one round of loads (a lane per word,
// the next word by a shuffle, one funnel shift), the row from its first
// three words.  Every block knows the total, so the count and the rows
// past it (-1, zero windows) are split over the cluster's blocks.  A
// block may own no word (a plane of fewer than 16 x 1,024 words): it
// still writes its count and joins the barriers, so no block leaves
// before every count has reached it.
//
// One launch serves one tail or two: the grid is one cluster per tail,
// and the cluster's index selects the tail's plane and epilogue, so the
// classic and the LE tail of a step run side by side on different SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "le_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int REG = 8;                // words per lane and pass
constexpr int WARP_WORDS = 32 * REG;  // 256
constexpr int PASS = WARPS * WARP_WORDS;  // 8,192 words per block pass
constexpr int WMAX = 4;               // window words per lane (ww <= 128)
constexpr int MAX_TAILS = 2;
constexpr int CLUSTER = 16;           // blocks per tail
constexpr unsigned FULL = 0xFFFFFFFFu;

}  // namespace

// One tail's arguments (ops/hit_table.py:_Tail mirrors this layout).
struct Tail {
    const uint32_t* hitw;             // (R, w) hit plane
    const uint32_t* words;            // (C, W) symbol words
    const long long* rows;            // (R,) word row and SNR column, or null
    const float* snr;                 // (S, Cs) slot SNR, strides st_s, st_c
    const long long* s0;              // (w,) squelch slot of each column
    const int* ma;                    // (w,) its mask
    const int* masks;                 // classic: 75 words; null for LE
    const int* white;                 // LE: (R,) whitening words
    const float* aa_on;               // LE: (R,) advertising rows
    const uint8_t* pre;               // LE: the distance tables
    const uint8_t* aa;
    const uint8_t* acc;
    const uint8_t* dat;
    int* count;                       // () int32
    int* tab;                         // (max_hits, 4 or 3) int32
    uint32_t* win;                    // (max_hits, ww) int32
    int R, w, W, S, Cs, st_s, st_c, use_gate, max_hits, ww;
    int per;                          // words per block
    float squelch;
};

struct Tails {
    Tail t[MAX_TAILS];
};

namespace {

// A tail's dynamic shared memory, in this order: the listed hits' bit
// indices (int, max_hits); for the nr rows a block's range can touch
// (block_rows), the row map (int; with rows) and, for LE, each row's
// whitening word (uint32); with the gate each column's mask (uint32, w)
// and slot (uint16, w) and the squelch bit of each (slot, row) (uint8,
// (S + 1) x nr); for LE each row's advertising flag (uint8).
struct Smem {
    int* list;
    int* rows;
    uint32_t* white;
    uint32_t* ma;
    uint16_t* a;
    uint8_t* bits;
    uint8_t* adv;
};

__host__ __device__ inline int block_rows(const Tail& t)
{
    const int r = (t.per - 1) / t.w + 2;
    return r < t.R ? r : t.R;
}

__host__ __device__ inline size_t smem_layout(const Tail& t, char* base,
                                              Smem* m)
{
    const bool le = t.masks == nullptr;
    const size_t nr = (size_t)block_rows(t);
    size_t o = 0;
    auto take = [&](size_t bytes) {
        char* p = base != nullptr ? base + o : nullptr;
        o += (bytes + 3) / 4 * 4;
        return p;
    };
    Smem s;
    s.list = reinterpret_cast<int*>(take((size_t)t.max_hits * 4));
    s.rows = reinterpret_cast<int*>(take(t.rows != nullptr ? nr * 4 : 0));
    s.white = reinterpret_cast<uint32_t*>(take(le ? nr * 4 : 0));
    s.ma = reinterpret_cast<uint32_t*>(take(t.use_gate ? (size_t)t.w * 4
                                                       : 0));
    s.a = reinterpret_cast<uint16_t*>(take(t.use_gate ? (size_t)t.w * 2
                                                      : 0));
    s.bits = reinterpret_cast<uint8_t*>(
        take(t.use_gate ? nr * (t.S + 1) : 0));
    s.adv = reinterpret_cast<uint8_t*>(take(le ? nr : 0));
    if (m != nullptr)
        *m = s;
    return o;
}

// Word m of a lane in a pass: half m / 4 of the warp's 256 words, four
// words per lane (one 16-byte load), lanes side by side.
__device__ __forceinline__ int word_of(int first, int m)
{
    return first + 128 * (m >> 2) + (m & 3);
}

// The thread's words of one pass (its first word `first`, a multiple of
// four), zero from `end` on.
__device__ __forceinline__ void load_pass(const uint32_t* hitw, int first,
                                          int end, uint32_t v[REG])
{
#pragma unroll
    for (int q = 0; q < REG / 4; ++q) {
        const int i = first + 128 * q;
        if (i + 3 < end) {
            const uint4 t = *reinterpret_cast<const uint4*>(hitw + i);
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                v[4 * q + j] = i + j < end ? hitw[i + j] : 0u;
        }
    }
}

// Gate the words of load_pass in place (the block's nr rows from r0);
// a zero word (past end, and most of them) needs no gate.
__device__ __forceinline__ void gate_pass(const Tail& T, const Smem& M,
                                          int r0, int nr, int first,
                                          uint32_t v[REG])
{
    if (!T.use_gate)
        return;
#pragma unroll
    for (int q = 0; q < REG / 4; ++q) {
        const uint32_t any = v[4 * q] | v[4 * q + 1] | v[4 * q + 2] |
                             v[4 * q + 3];
        if (any == 0u)
            continue;
        const int i = first + 128 * q;
        int r = i / T.w, col = i - r * T.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            uint32_t& x = v[4 * q + j];
            if (x != 0u) {
                const uint8_t* g = M.bits + (r - r0);
                const int a = M.a[col];
                const int b = a + 1 < T.S ? a + 1 : T.S;
                const uint32_t k = M.ma[col];
                x &= (g[a * nr] ? k : 0u) | (g[b * nr] ? ~k : 0u);
            }
            if (++col == T.w) {
                col = 0;
                ++r;
            }
        }
    }
}

// Inclusive scan of x over the warp.
__device__ __forceinline__ unsigned warp_inclusive(unsigned x, int lane)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, x, d);
        if (lane >= d)
            x += t;
    }
    return x;
}

// The ranks of a pass within its warp: ex[m] = the set bits of the
// warp's words before word m of this lane (word_of); returns the warp's
// total.  The two halves' lane counts share one scan (16 bits each: a
// half's warp total is at most 4,096).
__device__ __forceinline__ int warp_ranks(const uint32_t v[REG], int lane,
                                          int ex[REG])
{
    unsigned c[REG / 4];
    uint32_t any = 0u;
#pragma unroll
    for (int q = 0; q < REG / 4; ++q) {
        int run = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            ex[4 * q + j] = run;
            run += __popc(v[4 * q + j]);
            any |= v[4 * q + j];
        }
        c[q] = (unsigned)run;
    }
    if (!__any_sync(FULL, any != 0u))     // the common case: no hit
        return 0;
    static_assert(REG == 8, "two halves per pass");
    const unsigned inc = warp_inclusive(c[0] | c[1] << 16, lane);
    const unsigned tot = __shfl_sync(FULL, inc, 31);
    const int e0 = (int)(inc & 0xFFFFu) - (int)c[0];
    const int e1 = (int)(tot & 0xFFFFu) + (int)(inc >> 16) - (int)c[1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        ex[j] += e0;
        ex[4 + j] += e1;
    }
    return (int)(tot & 0xFFFFu) + (int)(tot >> 16);
}

// The block's exclusive scan of the warps' totals: returns the warp's
// base; *total gets the block's sum.  Two barriers.
__device__ __forceinline__ int block_scan(int x, int lane, int warp,
                                          int* s_warp, int* total)
{
    __syncwarp();               // the warp has read the last scan's base
    if (lane == 0)
        s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int v = s_warp[lane];
        const int inc = (int)warp_inclusive((unsigned)v, lane);
        s_warp[lane] = inc - v;
        if (lane == 31)
            s_warp[WARPS] = inc;
    }
    __syncthreads();
    *total = s_warp[WARPS];
    return s_warp[warp];
}

// The set bits of the pass's words into list by rank (rank of word m's
// first bit: base + ex[m]) while below limit.
__device__ __forceinline__ void list_pass(const uint32_t v[REG], int first,
                                          const int ex[REG], int base,
                                          int limit, int* list)
{
#pragma unroll
    for (int m = 0; m < REG; ++m) {
        uint32_t x = v[m];
        int rank = base + ex[m];
        while (x != 0u && rank < limit) {
            list[rank] = word_of(first, m) * 32 + (__ffs(x) - 1);
            x &= x - 1u;
            ++rank;
        }
    }
}

// Elements [0, m) of p set to x, this block's share of the cluster's.
template <typename V>
__device__ __forceinline__ void fill_share(V* p, int m, V x, int b, int nb)
{
    const int share = (m + nb - 1) / nb;
    const int lo = share * b;
    const int hi = lo + share < m ? lo + share : m;
    for (int i = lo + (int)threadIdx.x; i < hi; i += THREADS)
        p[i] = x;
}

// One hit's window (bit-aligned, a lane per word: o[j] is word
// 32 j + lane) and its table row, from the list entry idx.
struct HitRow {
    uint32_t o[WMAX];
    int t0, t1, t2, t3;
};

__device__ __forceinline__ HitRow hit_row(const Tail& T, const Smem& M,
                                          const uint8_t* s_tab,
                                          const uint32_t* s_mask, int r0,
                                          int idx, int lane, bool le)
{
    HitRow h;
    const int i = idx >> 5, sh = idx & 31;
    const int r = i / T.w, col = i - r * T.w;
    const uint32_t* src = T.words +
        (long long)(T.rows != nullptr ? M.rows[r - r0] : r) * T.W;
    uint32_t u[WMAX];
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        const int x = 32 * j + lane;
        u[j] = x < T.ww && col + x < T.W ? src[col + x] : 0u;
    }
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        const uint32_t up = __shfl_down_sync(FULL, u[j], 1);
        const uint32_t wrap = __shfl_sync(FULL, j + 1 < WMAX ? u[j + 1]
                                                             : 0u, 0);
        h.o[j] = __funnelshift_r(u[j], lane < 31 ? up : wrap, sh);
    }
    const uint32_t w0 = __shfl_sync(FULL, h.o[0], 0);
    const uint32_t w1 = __shfl_sync(FULL, h.o[0], 1);
    const uint32_t w2 = __shfl_sync(FULL, h.o[0], 2);
    h.t0 = r;
    h.t1 = 32 * col + sh;
    if (le) {
        const bool adv = M.adv[r - r0] != 0;
        h.t2 = le::dist(w0, w1, w2, 0, M.white[r - r0], adv, s_tab,
                        s_tab + le::N_PRE,
                        s_tab + le::N_PRE + le::N_AA +
                            (adv ? 0 : le::N_HDR));
        h.t3 = 0;
    } else {
        const uint32_t lap = (w1 >> 6) & 0xFFFFFFu;
        const bool on = lane < 24 && ((lap >> lane) & 1u);
        const uint32_t p0 = __reduce_xor_sync(FULL,
                                              on ? s_mask[3 * lane] : 0u);
        const uint32_t p1 = __reduce_xor_sync(
            FULL, on ? s_mask[3 * lane + 1] : 0u);
        const uint32_t p2 = __reduce_xor_sync(
            FULL, on ? s_mask[3 * lane + 2] : 0u);
        h.t2 = (int)lap;
        h.t3 = __popc(w0 ^ p0 ^ s_mask[72]) + __popc(w1 ^ p1 ^ s_mask[73]) +
               __popc((w2 ^ p2 ^ s_mask[74]) & 0xFu);
    }
    return h;
}

__device__ __forceinline__ void store_row(const Tail& T, const HitRow& h,
                                          int rank, int lane, bool le)
{
    uint32_t* wrow = T.win + (long long)rank * T.ww;
#pragma unroll
    for (int j = 0; j < WMAX; ++j)
        if (32 * j + lane < T.ww)
            wrow[32 * j + lane] = h.o[j];
    if (lane == 0) {
        int* trow = T.tab + (long long)rank * (le ? 3 : 4);
        trow[0] = h.t0;
        trow[1] = h.t1;
        trow[2] = h.t2;
        if (!le)
            trow[3] = h.t3;
    }
}

__device__ __forceinline__ void cluster_arrive_relaxed()
{
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's passes after the first (ranges over 8,192 words: planes
// over 16 x 8,192 words, such as the full band's at 128-slot blocks):
// their gated hits.
__device__ __forceinline__ int later_count(const Tail& T, const Smem& M,
                                           int r0, int nr, int lo, int hi,
                                           int* s_warp)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int more = 0;
    for (int p0 = lo + PASS; p0 < hi; p0 += PASS) {
        uint32_t u[REG];
        const int f = p0 + warp * WARP_WORDS + 4 * lane;
        load_pass(T.hitw, f, hi, u);
        gate_pass(T, M, r0, nr, f, u);
#pragma unroll
        for (int m = 0; m < REG; ++m)
            more += __popc(u[m]);
    }
    int tot;
    block_scan(__reduce_add_sync(FULL, more), lane, warp, s_warp, &tot);
    return tot;
}

// Their hits into list from rank `run` on while below n_list.
__device__ __forceinline__ void later_list(const Tail& T, const Smem& M,
                                           int r0, int nr, int lo, int hi,
                                           int run, int n_list, int* s_warp)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p0 = lo + PASS; p0 < hi && run < n_list; p0 += PASS) {
        uint32_t u[REG];
        int eu[REG], tot;
        const int f = p0 + warp * WARP_WORDS + 4 * lane;
        load_pass(T.hitw, f, hi, u);
        gate_pass(T, M, r0, nr, f, u);
        const int wb = block_scan(warp_ranks(u, lane, eu), lane, warp,
                                  s_warp, &tot);
        list_pass(u, f, eu, run + wb, n_list, M.list);
        run += tot;
        __syncthreads();                               // s_warp reused
    }
}

// A warp's hits after its first (more than 32 in one block).
__device__ __forceinline__ void later_hit(const Tail& T, const Smem& M,
                                          const uint8_t* s_tab,
                                          const uint32_t* s_mask, int r0,
                                          int idx, int rank, int lane,
                                          bool le)
{
    store_row(T, hit_row(T, M, s_tab, s_mask, r0, idx, lane, le), rank,
              lane, le);
}

}  // namespace

__global__ void __launch_bounds__(THREADS, 1)
hit_table_kernel(const __grid_constant__ Tails tails)
{
    extern __shared__ __align__(16) char smem[];
    __shared__ __align__(16) uint8_t s_tab[le::N_TABLES];
    __shared__ uint32_t s_mask[75];
    __shared__ int s_warp[WARPS + 1];
    __shared__ int s_counts[CLUSTER];  // every block's count, by rank

    // the first cluster barrier's arrive: its wait, before the first
    // store to another block's shared memory, knows every block started
    cluster_arrive_relaxed();
    cg::cluster_group cluster = cg::this_cluster();
    const int b = (int)cluster.block_rank();
    const Tail& T = tails.t[blockIdx.x / CLUSTER];
    const bool le = T.masks == nullptr;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = T.R * T.w;
    Smem M;
    smem_layout(T, smem, &M);

    // the block's words [lo, hi) in rows r0 to r1; the thread's first
    // word of pass 0
    const int lo = min(b * T.per, n), hi = min(lo + T.per, n);
    const int r0 = lo / T.w, nr = lo < hi ? (hi - 1) / T.w - r0 + 1 : 0;
    const int first = lo + warp * WARP_WORDS + 4 * lane;

    // ---- prologue: every load in flight before the first shared store
    // (a store waits for its load, and the next load would wait behind
    // it): the words, then the column constants (KC per thread) and the
    // squelch SNR of the block's (row, slot) pairs (KB per thread; LE
    // through the row map, a dependent load), the row constants, the
    // tables; wider planes loop after
    constexpr int KC = 3, KB = 2;
    uint32_t v[REG];
    load_pass(T.hitw, first, hi, v);
    const int s1 = T.S + 1, n_bits = T.use_gate ? nr * s1 : 0;
    long long cs0[KC];
    uint32_t cma[KC];
    long long bc[KB];
    float sn[KB];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
        const int c = tid + k * THREADS;
        const bool on = T.use_gate && c < T.w;
        cs0[k] = on ? T.s0[c] : 0;
        cma[k] = on ? (uint32_t)T.ma[c] : 0u;
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const int i = tid + k * THREADS, dr = i % max(nr, 1);
        bc[k] = i >= n_bits ? 0
              : T.rows != nullptr ? T.rows[r0 + dr] : r0 + dr;
    }
    const bool row_t = tid < nr;
    const int row_c = T.rows != nullptr && row_t
                          ? (int)T.rows[r0 + tid] : 0;
    const uint32_t white = le && row_t ? (uint32_t)T.white[r0 + tid]
                                       : 0u;
    const float aa_on = le && row_t ? T.aa_on[r0 + tid] : 0.f;
    const uint32_t tabw =
        le ? (tid < le::N_TABLES / 4
                  ? *le::table_word(tid, T.pre, T.aa, T.acc, T.dat) : 0u)
           : tid < 75 ? (uint32_t)T.masks[tid] : 0u;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const int i = tid + k * THREADS, s = i / max(nr, 1);
        const long long slot = s < T.S ? s : T.S - 1;
        sn[k] = i < n_bits ? T.snr[slot * T.st_s + bc[k] * T.st_c]
                           : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
        const int c = tid + k * THREADS;
        if (T.use_gate && c < T.w) {
            M.a[c] = (uint16_t)(cs0[k] < T.S ? cs0[k] : T.S);
            M.ma[c] = cma[k];
        }
    }
    for (int c = tid + KC * THREADS; T.use_gate && c < T.w; c += THREADS) {
        const long long x = T.s0[c];
        M.a[c] = (uint16_t)(x < T.S ? x : T.S);
        M.ma[c] = (uint32_t)T.ma[c];
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const int i = tid + k * THREADS;
        if (i < n_bits)
            M.bits[i] = sn[k] >= T.squelch;
    }
    for (int i = tid + KB * THREADS; i < n_bits; i += THREADS) {
        const int s = i / nr, dr = i - s * nr;
        const long long c = T.rows != nullptr ? T.rows[r0 + dr]
                                              : r0 + dr;
        const long long slot = s < T.S ? s : T.S - 1;
        M.bits[i] = T.snr[slot * T.st_s + c * T.st_c] >= T.squelch;
    }
    if (T.rows != nullptr && row_t)
        M.rows[tid] = row_c;
    if (le && row_t) {
        M.white[tid] = white;
        M.adv[tid] = aa_on > 0.5f;
    }
    if (le && tid < le::N_TABLES / 4)
        reinterpret_cast<uint32_t*>(s_tab)[tid] = tabw;
    else if (!le && tid < 75)
        s_mask[tid] = tabw;
    __syncthreads();

    // ---- ranks within the block: pass 0 in registers, later passes
    // (ranges over 8,192 words) counted here and listed again below
    gate_pass(T, M, r0, nr, first, v);
    int ex[REG];
    int agg0;
    const int wbase = block_scan(warp_ranks(v, lane, ex), lane, warp,
                                 s_warp, &agg0);
    const int agg = agg0 + (hi - lo > PASS                // block-uniform
                                ? later_count(T, M, r0, nr, lo, hi, s_warp)
                                : 0);

    // ---- the block's count into every block's shared memory (every
    // block has started: the first barrier's wait); while the cluster
    // gathers, list the hits of block rank below max_hits and take each
    // warp's first
    cluster_wait();
    if (warp == 0 && lane < CLUSTER)
        *cluster.map_shared_rank(&s_counts[b], lane) = agg;
    cluster_arrive();
    const int n_list = min(agg, T.max_hits);
    if (n_list > 0) {                                  // block-uniform
        list_pass(v, first, ex, wbase, n_list, M.list);
        if (hi - lo > PASS && agg0 < n_list)
            later_list(T, M, r0, nr, lo, hi, agg0, n_list, s_warp);
        __syncthreads();
    }
    HitRow h0;
    if (warp < n_list)
        h0 = hit_row(T, M, s_tab, s_mask, r0, M.list[warp], lane, le);

    // ---- the block's base and the total, from the cluster's counts
    // (after this wait no block touches another's shared memory)
    cluster_wait();
    const int c = lane < CLUSTER ? s_counts[lane] : 0;
    const int base = __reduce_add_sync(FULL, lane < b ? c : 0);
    const int total = __reduce_add_sync(FULL, c);

    // ---- the count and the rows past it, this block's share
    const int K = min(total, T.max_hits);
    const int cols = le ? 3 : 4;
    if (b == 0 && tid == 0)
        *T.count = total;
    fill_share(T.tab + K * cols, (T.max_hits - K) * cols, -1, b, CLUSTER);
    fill_share(T.win + K * T.ww, (T.max_hits - K) * T.ww, 0u, b, CLUSTER);

    // ---- the block's hits of rank base + k < max_hits
    const int n_mine = min(n_list, max(0, T.max_hits - base));
    if (warp < n_mine)
        store_row(T, h0, base + warp, lane, le);
    for (int k = warp + WARPS; k < n_mine; k += WARPS)
        later_hit(T, M, s_tab, s_mask, r0, M.list[k], base + k, lane, le);
}

// An empty kernel: the launch floor chip_smoke.py sets beside the hit
// table's time (one block of one warp, or the hit table's own grid of
// clusters with its two cluster barriers).
__global__ void hit_table_floor_kernel(int cluster_sync)
{
    if (cluster_sync) {
        cg::this_cluster().sync();
        cg::this_cluster().sync();
    }
}

namespace {

bool valid(const Tail& t)
{
    const bool le = t.masks == nullptr;
    return t.hitw != nullptr && t.words != nullptr && t.s0 != nullptr &&
           t.ma != nullptr && t.count != nullptr && t.tab != nullptr &&
           t.win != nullptr && t.R > 0 && t.w > 0 && t.w <= t.W &&
           t.max_hits > 0 && t.ww >= 3 && t.ww <= 32 * WMAX && t.per > 0 &&
           t.per % 4 == 0 &&
           (long long)t.per * CLUSTER >= (long long)t.R * t.w &&
           (long long)t.R * t.w * 32 < (1ll << 31) &&
           block_rows(t) <= THREADS &&
           (!t.use_gate || (t.snr != nullptr && t.S > 0 && t.S < 65535 &&
                            t.Cs > 0)) &&
           (!le || (t.white != nullptr && t.aa_on != nullptr &&
                    t.pre != nullptr && t.aa != nullptr &&
                    t.acc != nullptr && t.dat != nullptr));
}

// The kernel's attributes on the current device: the dynamic shared
// memory it may take and the non-portable cluster size.
cudaError_t prepare(const void* kernel, size_t smem)
{
    constexpr int MAX_DEV = 64;
    static int smem_set[MAX_DEV][2];
    static bool wide_set[MAX_DEV][2];
    const int k = kernel == (const void*)hit_table_kernel ? 0 : 1;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return e;
    if (dev >= MAX_DEV)
        return cudaErrorInvalidDevice;
    if (smem > 48 * 1024 && (int)smem > smem_set[dev][k]) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return e;
        smem_set[dev][k] = (int)smem;
    }
    if (!wide_set[dev][k]) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess)
            return e;
        wide_set[dev][k] = true;
    }
    return cudaSuccess;
}

cudaLaunchConfig_t config(int blocks, int threads, size_t smem,
                          void* stream, cudaLaunchAttribute* attr,
                          int cluster)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

// n_tails (1 or 2) tails in one launch, one cluster of CLUSTER blocks
// each.  Returns the cudaError_t of the launch: a cluster the card
// refuses (size, attribute, shared memory) is an error, not a smaller
// launch.
extern "C" int hit_table_launch(const Tail* tails, int n_tails, void* stream)
{
    if (tails == nullptr || n_tails < 1 || n_tails > MAX_TAILS)
        return (int)cudaErrorInvalidValue;
    Tails p = {};
    size_t smem = 0;
    for (int k = 0; k < n_tails; ++k) {
        if (!valid(tails[k]))
            return (int)cudaErrorInvalidValue;
        p.t[k] = tails[k];
        const size_t s = smem_layout(tails[k], nullptr, nullptr);
        smem = s > smem ? s : smem;
    }
    cudaError_t e = prepare((const void*)hit_table_kernel, smem);
    if (e == cudaSuccess) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = config(CLUSTER * n_tails, THREADS,
                                              smem, stream, &attr, CLUSTER);
        e = cudaLaunchKernelEx(&cfg, hit_table_kernel, p);
    }
    // a refusal is returned once, and not left for the next launch's
    // cudaGetLastError
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

// The launch floor: shape 0 one block of 32 threads, shape 1 the hit
// table's grid (n_tails clusters of CLUSTER blocks of 1,024 threads,
// two cluster barriers).
extern "C" int hit_table_floor_launch(int shape, int n_tails, void* stream)
{
    if ((shape != 0 && shape != 1) || n_tails < 1 || n_tails > MAX_TAILS)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = prepare((const void*)hit_table_floor_kernel, 0);
    if (e == cudaSuccess) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg =
            shape == 0 ? config(1, 32, 0, stream, &attr, 1)
                       : config(CLUSTER * n_tails, THREADS, 0, stream,
                                &attr, CLUSTER);
        e = cudaLaunchKernelEx(&cfg, hit_table_floor_kernel, shape);
    }
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}
