// Shared body of the polyphase DFT channelizer kernels pfb_snr.cu
// (gr_bluetooth_tpu/ops/pfb_kernel.py:559 and :369) and pfb_channelize.cu
// (pfb_kernel.py:193): persistent blocks walk tiles of NT = 56 output
// frames; per tile the branch FIRs run on the CUDA cores and the M-point
// DFT onto the block's bins runs on the tensor cores.
//
//   u[p][j][m] = sum_q hh[q][m] x_p[(j0 + j + 2q)D + m]   (branch FIRs;
//                hh[q] = h0[q] ++ h1[q], m < M = 2D)
//   y_r = (C^T u_r + S^T u_i) s,  y_i = (C^T u_i - S^T u_r) s
//
// with C, S the bank's dft_c / dft_s (M, C) and s = (-1)^{bin_odd[c] n}:
// the TPU kernel's own four contractions (gr_bluetooth_tpu/ops/
// pfb_kernel.py:_fir_dft), with the same matrices.  The bounds are in the
// two kernels' notes; both are bound by bytes (25 us at full band).
// Q is fixed at QTAPS = 7, the taps per branch of every bank that
// ops/pfb.py:make_pfb_bank builds (its prototype spans 6.67 symbols at
// every even rate), so the FIR keeps its taps and window in registers.
//
// DFT: mma.sync m16n8k8 TF32 with FP32 accumulation, rows = 16 bins,
// columns = 8 frames, depth = 8 branches.  Every operand is split as
// x = hi + lo, hi = rna(x), lo = rna(x - hi) (rna = cvt.rna.tf32.f32,
// round to nearest at mantissa bit 13, ties away from zero), and each
// product is taken as lo*hi + hi*lo + hi*hi: 3 MMAs per product, FP32-
// class accuracy (a single TF32 pass misses the 2e-5 channel-stream
// contract).  Each block loads its bins' dft_c / dft_s columns once,
// splits them and keeps hi and lo in shared memory in A-fragment order
// (one 16-byte load per fragment and lane); u is split as its B
// fragments load.  Where W and the tile buffers do not fit in shared
// memory, the bins are cut into groups over gridDim.y and each group's
// blocks redo the (cheap) FIR.  A direct DFT on the CUDA cores would be
// bound by its shared-memory loads (20 per 40 FMAs); here the MMAs read
// 4 16-byte A loads per 12 MMAs.
//
// Warp roles, so that the FIRs, copies and stores overlap the tensor
// cores (16 warps, 128 registers each; warps go to the SM's four
// sub-partitions by index mod 4):
//   - NC = 7 consumer warps 0-6, one per n-tile, two on each of
//     sub-partitions 0-2: warp w runs all k-steps of all the block's
//     m-tiles for n-tile w (two warps per sub-partition keep its tensor
//     core fed where one waits), then they stage y in the u buffer just
//     read;
//   - NP = 2 producer warps 7 and 11, on sub-partition 3 beside the
//     seventh consumer, run the FIRs of tile it + 2 into u[b] (two
//     buffers) as soon as the storers have taken tile it's y out of it;
//   - NS = 7 storer warps 8-10 and 12-15 copy the x window two tiles on
//     into x[b] (cp.async, tracked by mbarrier b, which the producers
//     wait on), read the staged y rows into registers, hand u[b] back
//     (EMPTY), then write the rows out whole, coalesced, with the rows'
//     energies (stores straight from the MMA fragments scatter 32-byte
//     pieces).
// Named barriers hand each u buffer on, one set per buffer: FULL (FIR
// done), STAGED (y staged), EMPTY (y read out).  So the per-tile cycle is
// the consumers' MMAs; the stores and the window copies stay off it.
//
// Shared memory reads and writes keep to distinct banks: the FIR reads
// x windows with lanes over branch m (consecutive words in pfb_snr's
// frame-major window, rows an odd stride apart in pfb_channelize's; lanes
// over frames would put rows of D = 40 words on 4 banks, 8-way
// conflicted); u is frame-major with row stride LDU = KP + 4, so a B
// fragment's 8 frames x 4 branches fall on 32 banks; the y stage has row
// stride NT = 56, so the fragments' float2 stores fall on 32 banks per
// half-warp.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pfb {

constexpr int QTAPS = 7;               // taps per branch (Q) of every bank
constexpr int NT = 56;                 // frames per tile: 7 n-tiles of 8
constexpr int NTILE = NT / 8;
constexpr int MAX_MT = 5;              // m-tiles (16 bins) per block
constexpr int NC = NTILE;              // consumer (MMA) warps 0..6
constexpr int NP = 2;                  // producer (FIR) warps 7, 11
constexpr int NS = 7;                  // storer warps 8..10, 12..15
constexpr int THREADS = 32 * (NC + NP + NS);
constexpr int RW = (16 * MAX_MT + NS - 1) / NS;  // rows per storer
constexpr int RE = 7;                  // rows per energy reduction
constexpr size_t SMEM_MAX = 232448;    // dynamic shared memory per block

struct Bank {
    const float* h0;                   // (Q, D)
    const float* h1;                   // (Q, D)
    const float* dft_c;                // (M, C)
    const float* dft_s;                // (M, C)
    const float* bin_odd;              // (C,)
    int Q, D, C;
};

// Shared-memory plan of one block, offsets in floats.
struct Layout {
    int M, KP, KT, LDU, ld, win, CG, MT;
    int mb, w, hh, bs, us, ubuf, xs, xplane, xbuf, total;
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// Input frames of one tile's window
__host__ __device__ inline int window(int Q) { return NT + 2 * Q - 1; }

// ld: stride between a branch's consecutive frames in the staged x
// window; plane: floats per window plane.  Regions start on 16-byte
// boundaries.
__host__ __device__ inline Layout make_layout(int D, int Q, int ld,
                                              int plane, int CG)
{
    Layout L;
    L.M = 2 * D;
    L.KP = (L.M + 7) & ~7;             // branches padded to the mma depth
    L.KT = L.KP / 8;
    L.LDU = L.KP + 4;                  // = 4 mod 8: conflict-free B loads
    L.ld = ld;
    L.win = window(Q);
    L.CG = CG;
    L.MT = CG / 16;
    L.mb = 0;                          // 2 mbarriers: x[b] landed
    L.w = 4;                           // [MT][KT][4][32] float4 fragments
    L.hh = L.w + 4 * CG * L.KP;        // [Q][KP] taps
    L.bs = L.hh + up4(Q * L.KP);       // [CG] rotator sign of odd bins
    L.us = L.bs + up4(CG);             // [2 buffers][2][NT][LDU] u,
    L.ubuf = up4(2 * NT * (L.LDU > CG ? L.LDU : CG));  // then [2][CG][NT] y
    L.xs = L.us + 2 * L.ubuf;          // [2 buffers][2 planes] x windows
    L.xplane = up4(plane);
    L.xbuf = 2 * L.xplane;
    L.total = L.xs + 2 * L.xbuf;
    return L;
}

// The largest bin group (a multiple of 16, at most MAX_MT m-tiles, the
// groups balanced) whose layout fits; 0 on success.
inline int plan(int D, int Q, int C, int ld, int plane, Layout* L,
                int* groups)
{
    const int mt_all = (C + 15) / 16;
    for (int mt = mt_all < MAX_MT ? mt_all : MAX_MT; mt >= 1; --mt) {
        const Layout l = make_layout(D, Q, ld, plane, 16 * mt);
        if (4 * (size_t)l.total > SMEM_MAX)
            continue;
        *groups = (mt_all + mt - 1) / mt;
        *L = make_layout(D, Q, ld, plane,
                         16 * ((mt_all + *groups - 1) / *groups));
        return 0;
    }
    return (int)cudaErrorInvalidValue;
}

// Blocks per bin group of a persistent launch of `fn` (THREADS threads,
// smem bytes of dynamic shared memory) on the current device: as many as
// the card holds at once, no more than there are tiles.  Raises fn's
// shared-memory limit on first use on each device (CUDA keeps function
// attributes per device); the occupancy is cached per (device, fn,
// smem), the SM count per device.
inline int grid_x(const void* fn, size_t smem, int groups, long long n_tiles,
                  int* gx)
{
    constexpr int MAX_DEV = 64;
    struct Seen { int dev; const void* fn; size_t smem; int occ; };
    static Seen seen[256];
    static int n_seen = 0, sms[MAX_DEV] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
    int occ = 0;
    for (int i = 0; i < n_seen && !occ; ++i)
        if (seen[i].dev == dev && seen[i].fn == fn && seen[i].smem == smem)
            occ = seen[i].occ;
    if (!occ) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, fn, THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        if (occ < 1) return (int)cudaErrorInvalidConfiguration;
        if (n_seen < 256) seen[n_seen++] = Seen{dev, fn, smem, occ};
    }
    if (!sms[dev]) {
        err = cudaDeviceGetAttribute(&sms[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    long long n = (long long)sms[dev] * occ / groups;
    if (n > n_tiles) n = n_tiles;
    *gx = n < 1 ? 1 : (int)n;
    return 0;
}

// kernel<MT> for a plan's MT
#define PFB_KERNEL_FOR(kernel, MT)                                         \
    pfb::pick<kernel<1>, kernel<2>, kernel<3>, kernel<4>, kernel<5>>(MT)

template <auto K1, auto K2, auto K3, auto K4, auto K5>
inline const void* pick(int MT)
{
    const void* k[] = {(const void*)K1, (const void*)K2, (const void*)K3,
                       (const void*)K4, (const void*)K5};
    return MT >= 1 && MT <= MAX_MT ? k[MT - 1] : nullptr;
}

// ---- device helpers

__device__ __forceinline__ uint32_t tf32_rna(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo)
{
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b for one 16x8x8 TF32 tile (A row-major fragment, B col-major)
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a,
                                    uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 4-byte asynchronous copy; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// 16-byte asynchronous copy of `bytes` (0..16) valid bytes, zeros after
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* m, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(m)), "r"(count) : "memory");
}

// m's phase completes once every storer thread's copies so far have
// landed (its count is the number of arriving threads)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* m)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(m)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* m, int parity)
{
    asm volatile("{\n"
                 ".reg .pred P1;\n"
                 "LAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
                 "@P1 bra DONE;\n"
                 "bra LAB_WAIT;\n"
                 "DONE:\n"
                 "}\n" :: "r"(smem_addr(m)), "r"(parity) : "memory");
}

// named barriers (one per buffer where two): sync waits for n threads,
// arrive counts and goes on
enum { BAR_FULL = 1, BAR_STAGED = 3, BAR_EMPTY = 5, BAR_CONS = 7 };
constexpr int N_FULL = 32 * (NP + NC), N_STAGED = 32 * (NC + NS);
constexpr int N_EMPTY = 32 * (NS + NP);

__device__ __forceinline__ void bar_sync(int id, int n)
{
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n)
{
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// W fragments for the block's bins [cg0, cg0 + CG): float4 (f*4 + which)*32
// + lane holds A elements (g, t), (g+8, t), (g, t+4), (g+8, t+4) of tile
// f = mt*KT + ks, which = C hi, C lo, S hi, S lo; A[c][k] = dft[k][c].
// Item (f, C or S, lane) loads its four elements straight from the bank
// (zeros past C and M), splits them and writes the hi and lo float4s;
// threads t, t + nth, ... of the block share the items, four at a time so
// that their loads are in flight together.
__device__ __forceinline__ void fill_dft(float* ws, const Bank& bk,
                                         const Layout& L, int cg0, int t,
                                         int nth)
{
    const int n = L.MT * L.KT * 64;
#pragma unroll 4
    for (int e = t; e < n; e += nth) {
        const int lane = e & 31, pair = (e >> 5) & 1, f = e >> 6;
        const int mt = f / L.KT, ks = f - mt * L.KT;
        const float* src = pair ? bk.dft_s : bk.dft_c;
        const int c0 = cg0 + 16 * mt + (lane >> 2), k0 = 8 * ks + (lane & 3);
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int c = c0 + 8 * (r & 1), k = k0 + 4 * (r >> 1);
            v[r] = c < bk.C && k < L.M ? __ldg(src + k * bk.C + c) : 0.f;
        }
        uint4 hi, lo;
        split(v[0], hi.x, lo.x);
        split(v[1], hi.y, lo.y);
        split(v[2], hi.z, lo.z);
        split(v[3], hi.w, lo.w);
        uint4* w = reinterpret_cast<uint4*>(ws) + (f * 4 + 2 * pair) * 32 +
                   lane;
        w[0] = hi;
        w[32] = lo;
    }
}

// FIR taps hh[q][m], and -1 for odd bins (1 elsewhere) of the group
__device__ __forceinline__ void fill_taps(float* hs, float* bs,
                                          const Bank& bk, const Layout& L,
                                          int cg0)
{
    const int D = bk.D;
    for (int i = threadIdx.x; i < bk.Q * L.KP; i += blockDim.x) {
        const int q = i / L.KP, m = i % L.KP;
        hs[i] = m < D ? bk.h0[q * D + m]
                      : (m < L.M ? bk.h1[q * D + m - D] : 0.f);
    }
    for (int c = threadIdx.x; c < L.CG; c += blockDim.x)
        bs[c] = cg0 + c < bk.C && bk.bin_odd[cg0 + c] != 0.f ? -1.f : 1.f;
}

// u for the tile's NT frames from the staged window xw, by threads tid,
// tid + nth, ...: item (p, m) computes all NT frames of branch m, a
// sliding window over the window's frames (frame k feeds outputs k - 2q),
// which start at src.branch(L, p, m) and lie L.ld apart.  Taps and window
// sit in registers: NT + 2Q - 2 loads for NT*Q FMAs.  Branches M..KP-1
// are zero.
template <class Src>
__device__ __forceinline__ void fir_tile(const Src& src, const float* xw,
                                         const float* hs, float* us,
                                         const Layout& L, int tid, int nth)
{
    for (int it = tid; it < 2 * L.KP; it += nth) {
        const int m = it % L.KP, p = it / L.KP;
        float* uo = us + p * NT * L.LDU + m;
        float acc[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j] = 0.f;
        if (m < L.M) {
            const float* xr = xw + src.branch(L, p, m);
            // each half's loads first, so that a load's latency is paid
            // once per half; two halves keep the window and the sums
            // within the 128 registers
            constexpr int H = NT / 2, NK = H + 2 * QTAPS - 2;
            float h[QTAPS];
#pragma unroll
            for (int q = 0; q < QTAPS; ++q) h[q] = hs[q * L.KP + m];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                float xv[NK];
#pragma unroll
                for (int k = 0; k < NK; ++k)
                    xv[k] = xr[(half * H + k) * L.ld];
#pragma unroll
                for (int k = 0; k < NK; ++k)
#pragma unroll
                    for (int q = 0; q < QTAPS; ++q)
                        if (k - 2 * q >= 0 && k - 2 * q < H)
                            acc[half * H + k - 2 * q] = fmaf(
                                h[q], xv[k], acc[half * H + k - 2 * q]);
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) uo[j * L.LDU] = acc[j];
    }
}

// y of every m-tile for n-tile nt of the tile.  The next k-step's B
// values load while this one's MMAs run.
template <int MT>
__device__ __forceinline__ void dft_ntile(const float* ws, const float* us,
                                          const Layout& L, int nt,
                                          float (&ar)[MT][4],
                                          float (&ai)[MT][4])
{
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint4* wf = reinterpret_cast<const uint4*>(ws) + lane;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) ar[i][e] = ai[i][e] = 0.f;
    const float* ur = us + (8 * nt + g) * L.LDU + t;
    const float* ui = ur + NT * L.LDU;
    float x[4] = {ur[0], ur[4], ui[0], ui[4]};
    // the next (m-tile, k-step)'s A fragments load while this one's MMAs
    // run: a[] = C hi, C lo, S hi, S lo
    uint4 a[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = wf[32 * w];
    for (int ks = 0; ks < L.KT; ++ks) {
        // b[0..3] = hi of u_r(k), u_r(k + 4), u_i(k), u_i(k + 4); b[4..7]
        // the lo parts; nr = -u_r (hi, lo)
        uint32_t b[8], nr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[e], b[e], b[4 + e]);
        nr[0] = b[0] ^ 0x80000000u;
        nr[1] = b[1] ^ 0x80000000u;
        nr[2] = b[4] ^ 0x80000000u;
        nr[3] = b[5] ^ 0x80000000u;
        if (ks + 1 < L.KT) {
            const int o = 8 * (ks + 1);
            x[0] = ur[o]; x[1] = ur[o + 4];
            x[2] = ui[o]; x[3] = ui[o + 4];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const uint4 chi = a[0], clo = a[1], shi = a[2], slo = a[3];
            // (mt + 1, ks), else (0, ks + 1); the last load repeats one
            const int nf = mt + 1 < MT ? (mt + 1) * L.KT + ks
                                       : (ks + 1 < L.KT ? ks + 1 : ks);
#pragma unroll
            for (int w = 0; w < 4; ++w) a[w] = wf[nf * 128 + 32 * w];
            // y_r += C^T u_r + S^T u_i, y_i += C^T u_i + S^T (-u_r), each
            // accumulator taking lo.hi, hi.lo, hi.hi of C, then of S; grouped
            // by A fragment, the accumulators alternating
            mma(ar[mt], clo, b[0], b[1]);
            mma(ai[mt], clo, b[2], b[3]);
            mma(ar[mt], chi, b[4], b[5]);
            mma(ai[mt], chi, b[6], b[7]);
            mma(ar[mt], chi, b[0], b[1]);
            mma(ai[mt], chi, b[2], b[3]);
            mma(ar[mt], slo, b[2], b[3]);
            mma(ai[mt], slo, nr[0], nr[1]);
            mma(ar[mt], shi, b[6], b[7]);
            mma(ai[mt], shi, nr[2], nr[3]);
            mma(ar[mt], shi, b[2], b[3]);
            mma(ai[mt], shi, nr[0], nr[1]);
        }
    }
}

// Consumer warp: MMAs of n-tile nt, then y staged over u
template <int MT>
__device__ __forceinline__ void consume(const float* ws, float* ub,
                                       const float* bs, const Layout& L,
                                       int nt, long long j0)
{
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int yp = L.CG * NT;
    float ar[MT][4], ai[MT][4];
    dft_ntile<MT>(ws, ub, L, nt, ar, ai);
    bar_sync(BAR_CONS, 32 * NC);             // u read by all consumers
    // rotator (frame j0 + col, col even); y[p][row][col]
    const int col = 8 * nt + 2 * t;
    const float s0 = (j0 + col) & 1 ? -1.f : 1.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * mt + g + 8 * h;
            const float sb = bs[row];
            const float se = sb < 0.f ? s0 : 1.f;
            const float so = sb < 0.f ? -s0 : 1.f;
            float* py = ub + row * NT + col;
            *reinterpret_cast<float2*>(py) =
                make_float2(ar[mt][2 * h] * se, ar[mt][2 * h + 1] * so);
            *reinterpret_cast<float2*>(py + yp) =
                make_float2(ai[mt][2 * h] * se, ai[mt][2 * h + 1] * so);
        }
}

// Frames j, j + 1 of a row (v frames to write) at p = y + o + j, j even:
// one 8-byte store where p is 8-byte aligned (the same for the whole
// row), else two 4-byte ones
__device__ __forceinline__ void store_pair(float* p, float2 a, int j, int v)
{
    if (j + 1 < v && !((uintptr_t)p & 7)) {
        *reinterpret_cast<float2*>(p) = a;
    } else {
        if (j < v) p[0] = a.x;
        if (j + 1 < v) p[1] = a.y;
    }
}

// One level of reduce_scatter32: lanes with bit H keep the upper H
// values, the others the lower, each adding its partner's half
template <int H>
__device__ __forceinline__ void rs_level(float (&e)[32], int lane)
{
    const bool up = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = up ? e[i] : e[i + H];
        const float keep = up ? e[i + H] : e[i];
        e[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
}

// Sums of e[i] over the warp, lane i receiving sum i: a butterfly in
// which each level keeps half the values, 31 shuffles in all
__device__ __forceinline__ float reduce_scatter32(float (&e)[32], int lane)
{
    rs_level<16>(e, lane);
    rs_level<8>(e, lane);
    rs_level<4>(e, lane);
    rs_level<2>(e, lane);
    rs_level<1>(e, lane);
    return e[0];
}

// The tile loop over n_out output frames, tiles of NT from frame 0.
// Src supplies n_tiles (= ceil(n_out / NT)), energy (whether to sum
// energies) and copy(buffer, layout, tile, tid, nth), which issues the
// tile's window copies (frames [tile NT, tile NT + win)) from threads
// tid < nth.  y rows have stride n_out.  With energy,
// oe[c * (n_out / tf) + k] += sum |y|^2 over frames [k tf, (k + 1) tf):
// each such sum is split between at most two tiles (NT > tf), so with oe
// zeroed first the result does not depend on their order.  MT = L.MT,
// bk.Q = QTAPS.
template <int MT, class Src>
__device__ __forceinline__ void run(const Src& src, const Bank& bk,
                                    const Layout& L, float* sm, float* yr,
                                    float* yi, long long n_out, float* oe,
                                    int tf)
{
    float* ws = sm + L.w;
    float* hs = sm + L.hh;
    float* bs = sm + L.bs;
    float* us = sm + L.us;
    float* xs = sm + L.xs;
    uint64_t* mb = reinterpret_cast<uint64_t*>(sm + L.mb);
    const int cg0 = blockIdx.y * L.CG;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long n_tiles = src.n_tiles;
    const int n_mine = blockIdx.x < n_tiles
        ? (int)((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
    auto tile_of = [&](int it) {
        return blockIdx.x + (long long)it * gridDim.x;
    };
    const int yp = L.CG * NT;                // y stage plane stride

    // the first two windows, the taps and W, their loads in flight
    // together; then every warp runs the first tile's FIRs, so that the
    // tensor cores start one FIR (not a producers' tile) after the loads
    for (int it = 0; it < 2 && it < n_mine; ++it)
        src.copy(xs + it * L.xbuf, L, tile_of(it), threadIdx.x, THREADS);
    cp_async_commit();
    fill_taps(hs, bs, bk, L, cg0);
    fill_dft(ws, bk, L, cg0, threadIdx.x, THREADS);
    if (threadIdx.x < 2) mbar_init(mb + threadIdx.x, 32 * NS);
    cp_async_wait_all();
    __syncthreads();
    if (n_mine > 0)
        fir_tile(src, xs, hs, us, L, threadIdx.x, THREADS);
    __syncthreads();

    static_assert(NC == 7 && NP == 2 && NS == 7, "the warp roles below");
    if (warp == 7 || warp == 11) {
        // producers: FIRs of tile it >= 2 once its window has landed
        // (mbarrier b, its (it / 2 - 1)-th phase) and the y of tile it - 2
        // has left u[b] (EMPTY)
        const int tid = 32 * (warp == 11) + lane;
        for (int it = 0; it < n_mine; ++it) {
            const int b = it & 1;
            if (it >= 2) {
                mbar_wait(mb + b, ((it >> 1) - 1) & 1);
                bar_sync(BAR_EMPTY + b, N_EMPTY);
            }
            if (it > 0)
                fir_tile(src, xs + b * L.xbuf, hs, us + b * L.ubuf, L, tid,
                         32 * NP);
            bar_arrive(BAR_FULL + b, N_FULL);
        }
        // the storers' last two EMPTY arrivals
        for (int it = n_mine > 2 ? n_mine - 2 : 0; it < n_mine; ++it)
            bar_sync(BAR_EMPTY + (it & 1), N_EMPTY);
        return;
    }

    if (warp >= NC) {
        // storers: rows r = sw + NS k of both planes, frames [j0, j0 + v);
        // a tile's rows go to registers first, so that u[b] goes back to
        // the producers before the stores
        const int sw = warp - 8 - (warp > 11);   // warps 8-10, 12-15
        const int cgn = min(L.CG, bk.C - cg0);
        const long long n_tf = Src::energy ? n_out / tf : 0;
        const int j = 2 * lane;              // lane: frames j, j + 1
        for (int it = 0; it < n_mine; ++it) {
            const int b = it & 1;
            const long long j0 = tile_of(it) * NT;
            const int v = (int)(n_out - j0 < NT ? n_out - j0 : NT);
            const float* ub = us + b * L.ubuf;
            float2 ya[RW], yb[RW];
            bar_sync(BAR_STAGED + b, N_STAGED);
            // FIR(it) has read x[b]: the window two tiles on goes there
            if (it + 2 < n_mine) {
                src.copy(xs + b * L.xbuf, L, tile_of(it + 2), 32 * sw + lane,
                         32 * NS);
                cp_async_mbar_arrive(mb + b);
            }
#pragma unroll
            for (int k = 0; k < RW; ++k) {
                const int r = sw + NS * k;
                ya[k] = yb[k] = make_float2(0.f, 0.f);
                if (r < cgn && j < v) {
                    const float* sy = ub + r * NT + j;
                    ya[k] = *reinterpret_cast<const float2*>(sy);
                    yb[k] = *reinterpret_cast<const float2*>(sy + yp);
                    if (j + 1 == v) ya[k].y = yb[k].y = 0.f;
                }
            }
            bar_arrive(BAR_EMPTY + b, N_EMPTY);
            float w[RW];                     // |y|^2 of this lane's frames
#pragma unroll
            for (int k = 0; k < RW; ++k)
                w[k] = ya[k].x * ya[k].x + ya[k].y * ya[k].y +
                       yb[k].x * yb[k].x + yb[k].y * yb[k].y;
#pragma unroll
            for (int k = 0; k < RW; ++k) {
                const int r = sw + NS * k;
                if (r < cgn) {
                    const long long o = (long long)(cg0 + r) * n_out + j0;
                    store_pair(yr + o + j, ya[k], j, v);
                    store_pair(yi + o + j, yb[k], j, v);
                }
            }
            if constexpr (Src::energy) {
                // energy segments: frames [0, b1), [b1, b2), [b2, v) of
                // the tile lie in energy tiles k0, k0 + 1, k0 + 2; this
                // lane's two frames in segment seg (b1, b2 and j are even)
                const long long k0 = j0 / tf;
                const int b1 = (int)((k0 + 1) * tf - j0), b2 = b1 + tf;
                const int nseg = (v > b1) + (v > b2) + 1;
                const int seg = (j >= b1) + (j >= b2);
#pragma unroll
                for (int h = 0; h < RW; h += RE) {
                    // slot 3k + s: row sw + NS (h + k), segment s
                    float e[32];
#pragma unroll
                    for (int i = 0; i < 32; ++i) e[i] = 0.f;
#pragma unroll
                    for (int k = 0; k < RE && h + k < RW; ++k)
#pragma unroll
                        for (int s = 0; s < 3; ++s)
                            e[3 * k + s] = seg == s ? w[h + k] : 0.f;
                    const float tot = reduce_scatter32(e, lane);
                    const int k = lane / 3, s = lane - 3 * k;
                    const int r = sw + NS * (h + k);
                    if (k < RE && h + k < RW && r < cgn && s < nseg &&
                        k0 + s < n_tf)
                        atomicAdd(oe + (cg0 + r) * n_tf + k0 + s, tot);
                }
            }
        }
        return;
    }

    // consumers: n-tile warp
    for (int it = 0; it < n_mine; ++it) {
        const int b = it & 1;
        const long long j0 = tile_of(it) * NT;
        float* ub = us + b * L.ubuf;
        bar_sync(BAR_FULL + b, N_FULL);
        consume<MT>(ws, ub, bs, L, warp, j0);
        bar_arrive(BAR_STAGED + b, N_STAGED);
    }
}

}  // namespace pfb
