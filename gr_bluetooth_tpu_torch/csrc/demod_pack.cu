// demod_pack: GFSK discriminator + 16-phase feedforward timing + slicer +
// 32-symbols-per-word packing, plus the SNR probe band-pass energies.
//
// Replaces the demod stages of the TPU megakernel
// gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_snr_demod_fused (the
// function of gr_bluetooth_tpu/ops/demod_kernel.py:demod_timing_pack) and
// the megakernel's probe band-pass products (pfb_kernel.py:494-506).
//
// Per (512-symbol group t, channel row c), over the window
// y[c][1024t + l], frames past the stream reading as zero:
//   d[l]     = gain * atan2_poly(Im, Re)(y[l+1] conj(y[l]))
//   metric_p = sum_{s < nvalid} |d[2s+par](1-f) + d[2s+par+1] f|,
//              f = (p % 8) / 8, par = p / 8 (16 hypotheses)
//   best     = first maximum over p (earliest on ties)
//   bit_s    = d[2s+par*](1-f*) + d[2s+par*+1] f* >= 0
// packed 32 symbols per word.  Groups at or past the data (t >=
// n_data_groups) write all-ones words, as the TPU kernel does, and the
// bits of symbols >= n_sym are zero.  Probe: for the global 40-frame grid
// points k with 40k in [1024t, 1024(t+1)) and k < n_k,
// pe[c][k] = |sum_l y[40k+l] tap[l]|^2 (zero in groups past the data).
//
// The discriminator and interpolation use explicitly rounded operations
// (__fmul_rn & co., never contracted into FMAs), so d, the soft values
// and the slicer match the plain PyTorch version bit for bit; only the
// order of the 512-term metric sums differs.
//
// Bound on an H100 SXM (80 rows of 87,050 frames, 85 groups, 2,151 probe
// points of 201 taps): the bytes, 55 MB of y read once, take 16.5 us at
// 3.35 TB/s.  The instructions come above that: two IEEE divisions and
// the polynomial per discriminator frame (about 60 instructions), 51 per
// symbol for the 16 metrics, 6 per probe tap and point (two shared loads,
// four FMAs); chip_smoke.py prints an estimate of this arithmetic alone
// (about 30 us at four warp instructions per SM and clock).  So the
// design keeps everything else off the group's path:
//   - persistent blocks of 4 warps, as many as the card holds, each
//     walking a contiguous run of groups (the runs as even as they
//     divide); a group's window (1,247 frames of both planes) is copied
//     two groups ahead into a double-buffered ring: each plane's 16-byte
//     aligned run in one bulk (TMA) copy tracked by an mbarrier, the <= 3
//     frames at either end by cp.async;
//   - frame 0 of a group is the last group's frame 1024 when that
//     group was this row's;
//   - 4 symbols and 8 discriminator frames per thread, lanes over
//     consecutive frames (shared-memory reads free of bank conflicts);
//     the metrics' products shared between the two parities;
//   - no serial phase: each warp's 16 metric sums are reduced by a
//     transposing butterfly (15 shuffles, pfb_tile.cuh:rs_level), then
//     the 16 lanes of warp 0 each sum one hypothesis over the warps and a
//     shuffle argmax keeps the earliest index on ties;
//   - the probe taps held in registers for the whole block (7 per lane);
//     warps 1-3 take up to 7 of the group's grid points each, warp 0
//     (which also takes the argmax) the rest, lanes over taps; one
//     transposing butterfly then sums each warp's complex products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pfb_tile.cuh"

namespace {

constexpr int GROUP = 512;                 // symbols per timing group
constexpr int GFRAMES = 2 * GROUP;         // frames per group
constexpr int PSTRIDE = 40;                // probe grid, frames
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int SPT = GROUP / THREADS;       // symbols per thread
constexpr int FPT = GFRAMES / THREADS;     // discriminator frames per thread
constexpr int TMAX = 224;                  // probe taps at most
constexpr int TPL = TMAX / 32;             // probe taps per lane
constexpr int KPW = 7;                     // probe points per warp
static_assert(NWARPS == 4 && 4 * KPW >= GFRAMES / PSTRIDE + 1,
              "warps 1-3 and warp 0 cover a group's grid points");
// window: frames [0, 1026) for the discriminator, [0, 1023 + TMAX) for
// the probe; a plane's buffer holds it at an offset of up to 3 frames
constexpr int WIN = GFRAMES - 1 + TMAX;
constexpr int WBUF = (WIN + 3 + 3) / 4 * 4;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const float* yr;                       // (C, F) channel streams
    const float* yi;
    int a0r, a0i;                          // their addresses in floats, mod 4
    const float* taps_re;                  // (T,) probe taps
    const float* taps_im;
    int C, F, n_sym, n_groups, n_data_groups, T, n_k, nw;
    float gain;
    int* words;                            // (C, nw)
    float* pe;                             // (C, n_k)
};

// atan2 by octant reduction + the Cephes atanf polynomial, the float32
// constants written exactly (as the reference rounds them)
__device__ __forceinline__ float atan2_poly(float y, float x)
{
    float ax = fabsf(x), ay = fabsf(y);
    bool swap = ay > ax;
    float num = swap ? ax : ay;
    float den = swap ? ay : ax;
    den = den == 0.f ? 1.f : den;
    const float q = __fdiv_rn(num, den);
    bool big = q > 0x1.a8279ap-2f;                        // tan(pi/8)
    const float qm = __fsub_rn(q, 1.f), qp = __fadd_rn(q, 1.f);
    float t = big ? __fdiv_rn(qm, qp) : q;
    float z = __fmul_rn(t, t);
    float p = __fmul_rn(0x1.49e1a2p-4f, z);
    p = __fsub_rn(p, 0x1.1c370ap-3f);
    p = __fmul_rn(p, z);
    p = __fadd_rn(p, 0x1.9924bep-3f);
    p = __fmul_rn(p, z);
    p = __fsub_rn(p, 0x1.555454p-2f);
    p = __fmul_rn(p, z);
    p = __fmul_rn(p, t);
    p = __fadd_rn(p, t);
    float r = big ? __fadd_rn(0x1.921fb6p-1f, p) : p;    // + pi/4
    r = swap ? __fsub_rn(0x1.921fb6p+0f, r) : r;         // pi/2 -
    r = x < 0.f ? __fsub_rn(0x1.921fb6p+1f, r) : r;      // pi -
    return y < 0.f ? -r : r;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f)
{
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

// The 16 timing-metric terms of one symbol added to e: |lerp_rn(de, dd,
// k / 8)| for hypothesis k and |lerp_rn(dd, de1, k / 8)| for 8 + k, the
// products shared (dd k / 8 is a term of both k and 8 - k) and those by
// 1 and 0 left out (d is finite, and |x + 0| = |x|): 21 products where
// the lerps take 32
__device__ __forceinline__ void add_metrics(float (&e)[32], float de,
                                            float dd, float de1)
{
    float pe[8], pd[8], p1[8];               // x k / 8 at [k], k = 1..7
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        pe[k] = __fmul_rn(de, k * 0.125f);
        pd[k] = __fmul_rn(dd, k * 0.125f);
        p1[k] = __fmul_rn(de1, k * 0.125f);
    }
    e[0] += fabsf(de);
    e[8] += fabsf(dd);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        e[k] += fabsf(__fadd_rn(pe[8 - k], pd[k]));
        e[8 + k] += fabsf(__fadd_rn(pd[8 - k], p1[k]));
    }
}

// d[l] from window frames l and l + 1
__device__ __forceinline__ float disc(const float* wr, const float* wi,
                                      int l, float gain)
{
    const float r0 = wr[l], r1 = wr[l + 1], i0 = wi[l], i1 = wi[l + 1];
    const float pr = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
    const float pim = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
    return __fmul_rn(gain, atan2_poly(pim, pr));
}

// d[l] for frames l = l0, l0 + THREADS, ... (FPT of them)
__device__ __forceinline__ void disc_frames(const float* wr, const float* wi,
                                            float* d, int l0, float gain)
{
#pragma unroll 4
    for (int m = 0; m < FPT; ++m)
        d[l0 + THREADS * m] = disc(wr, wi, l0 + THREADS * m, gain);
}

// Where frame 0 of a row that starts a0 + cF floats from a 16-byte
// boundary sits in its buffer: so that 16-byte aligned frames stay
// aligned
__device__ __forceinline__ int offset(int a0, int c, int F)
{
    return (int)((a0 + (long long)c * F) & 3);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* m, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(pfb::smem_addr(m)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* m)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(pfb::smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(pfb::smem_addr(m)) : "memory");
}

constexpr int EDGE = 6;                  // edge-copy lanes per plane
constexpr int ARRIVALS = 1 + 2 * EDGE;

// One plane's window of one row: frames [f0, f0 + WIN), valid below
// end; the 16-byte aligned run [h, h + run) goes in one bulk copy
struct Span {
    const float* row;
    int o, h, end, run;
};

__device__ __forceinline__ Span span(const float* y, int a0, int c, int F,
                                     int f0)
{
    Span s;
    s.o = offset(a0, c, F);
    s.h = (4 - s.o) & 3;
    s.end = F - f0 < WIN ? F - f0 : WIN;
    s.end = s.end > 0 ? s.end : 0;
    s.run = s.end > s.h ? (s.end - s.h) & ~3 : 0;
    s.row = y + (long long)c * F + f0;
    return s;
}

// The frames of a span outside its run: the <= 3 before it and the <= 3
// after it one each (lanes 1 + EDGE p ..., which always arrive), and
// frames past the row zeroed in place
__device__ __forceinline__ void edges(const Span& s, float* buf, int p,
                                      uint64_t* m, int lane)
{
    const int e = lane - 1 - EDGE * p;
    if (e >= 0 && e < EDGE) {
        const int l = e < 3 ? e : s.h + s.run + e - 3;
        if ((e >= 3 || l < s.h) && l < s.end)
            pfb::cp_async4(buf + s.o + l, s.row + l, true);
        pfb::cp_async_mbar_arrive(m);
    }
    for (int l = s.end + lane; l < WIN; l += 32) buf[s.o + l] = 0.f;
}

// The window of group t of row c into buffer buf, tracked by m: one warp's
// work (lane 0 issues the bulk copies)
__device__ __forceinline__ void copy_window(const Args& a, int c, int t,
                                            float (&buf)[2][WBUF],
                                            uint64_t* m, int lane)
{
    const Span r = span(a.yr, a.a0r, c, a.F, t * GFRAMES);
    const Span q = span(a.yi, a.a0i, c, a.F, t * GFRAMES);
    if (lane == 0) {
        mbar_expect_tx(m, 4 * (r.run + q.run));
        if (r.run) bulk_copy(buf[0] + r.o + r.h, r.row + r.h, 4 * r.run, m);
        if (q.run) bulk_copy(buf[1] + q.o + q.h, q.row + q.h, 4 * q.run, m);
    }
    edges(r, buf[0], 0, m, lane);
    edges(q, buf[1], 1, m, lane);
}

}  // namespace

__global__ void __launch_bounds__(THREADS, 8)
demod_pack_kernel(const Args a)
{
    __shared__ __align__(16) float xs[2][2][WBUF];   // [buffer][plane]
    __shared__ __align__(16) float d[GFRAMES + 4];
    __shared__ float part[NWARPS][32];
    __shared__ int best_s;
    __shared__ uint64_t mb[2];                       // buffer b landed

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int total = a.C * a.n_groups;
    const int i0 = (int)((long long)total * blockIdx.x / gridDim.x);
    const int n_mine =
        (int)((long long)total * (blockIdx.x + 1) / gridDim.x) - i0;

    // this lane's probe taps lane + 32 m, zero past T
    float tr[TPL], ti[TPL];
#pragma unroll
    for (int m = 0; m < TPL; ++m) {
        const int l = lane + 32 * m;
        tr[m] = l < a.T ? a.taps_re[l] : 0.f;
        ti[m] = l < a.T ? a.taps_im[l] : 0.f;
    }
    if (tid < 3) d[GFRAMES + 1 + tid] = 0.f;         // read, never used
    if (tid < 2) pfb::mbar_init(&mb[tid], ARRIVALS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
    // (c, t) the item's row and group, (c2, t2) those two items on, whose
    // window warp 0 copies
    int c = i0 / a.n_groups, t = i0 - c * a.n_groups, c2 = c, t2 = t;
    if (warp == 0) {
        for (int it = 0; it < 2 && it < n_mine; ++it) {
            copy_window(a, c2, t2, xs[it], &mb[it], lane);
            if (++t2 == a.n_groups) t2 = 0, ++c2;
        }
    }
    // the mbarrier orders the copies, not warp 0's zero fill of frames
    // past the row (later windows' fills precede a barrier)
    __syncthreads();

    for (int it = 0; it < n_mine; ++it) {
        const int b = it & 1;
        const float* wr = xs[b][0] + offset(a.a0r, c, a.F);
        const float* wi = xs[b][1] + offset(a.a0i, c, a.F);
        pfb::mbar_wait(&mb[b], (it >> 1) & 1);

        // discriminator: frames 1 + tid + 128 m; frame 0 is the last
        // group's frame 1024 where that group was this row's, else one
        // thread computes it
        const float last = tid == THREADS - 1 ? d[GFRAMES] : 0.f;
        disc_frames(wr, wi, d, 1 + tid, a.gain);
        if (tid == THREADS - 1) {
            d[0] = it == 0 || t == 0 ? disc(wr, wi, 0, a.gain) : last;
        }
        __syncthreads();

        // timing metrics of this thread's symbols s = tid + 128 j; e[p]
        // for hypothesis p (rs_level works on 32 values; 16 are used)
        int nvalid = a.n_sym - t * GROUP;
        nvalid = nvalid < 0 ? 0 : (nvalid > GROUP ? GROUP : nvalid);
        float e[32], de[SPT], dd[SPT], de1[SPT];
#pragma unroll
        for (int p = 0; p < 16; ++p) e[p] = 0.f;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int s = tid + THREADS * j;
            const float2 p0 = *reinterpret_cast<const float2*>(d + 2 * s);
            const float2 p1 = *reinterpret_cast<const float2*>(d + 2 * s + 2);
            de[j] = p0.x;
            dd[j] = p0.y;
            de1[j] = p1.x;
            if (s < nvalid) add_metrics(e, de[j], dd[j], de1[j]);
        }
        // lane l ends with hypothesis l % 16's sum over lanes l and l ^ 16
        // of the other 16
        pfb::rs_level<8>(e, lane);
        pfb::rs_level<4>(e, lane);
        pfb::rs_level<2>(e, lane);
        pfb::rs_level<1>(e, lane);
        part[warp][lane] = e[0];
        __syncthreads();

        if (warp == 0) {
            // hypothesis lane % 16 over the warps (both halves add the
            // same two sums), then the first maximum
            float v = 0.f;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) v += part[w][lane];
            v += __shfl_xor_sync(FULL, v, 16);
            int idx = lane & 15;
#pragma unroll
            for (int s = 1; s < 16; s <<= 1) {
                const float ov = __shfl_xor_sync(FULL, v, s);
                const int oi = __shfl_xor_sync(FULL, idx, s);
                if (ov > v || (ov == v && oi < idx)) {
                    v = ov;
                    idx = oi;
                }
            }
            if (lane == 0) best_s = idx;
        }

        // probe: warps 1-3 take up to KPW grid points each, the last ones
        // of the group; warp 0, which also took the argmax, the rest
        const int k0 = (t * GFRAMES + PSTRIDE - 1) / PSTRIDE;
        int k1 = ((t + 1) * GFRAMES + PSTRIDE - 1) / PSTRIDE;
        k1 = k1 < a.n_k ? k1 : a.n_k;
        const int np = k1 - k0;
        const int n0 = np > 3 * KPW ? np - 3 * KPW : 0;
        const int pbeg = warp ? n0 + KPW * (warp - 1) : 0;
        int cnt = warp ? (np < n0 + KPW * warp ? np : n0 + KPW * warp) - pbeg
                       : n0;
        if (cnt > 0) {
            float acc[32];                   // re, im of point q at 2q, 2q+1
#pragma unroll
            for (int v = 0; v < 16; ++v) acc[v] = 0.f;
            const float* xr = wr + (k0 + pbeg) * PSTRIDE - t * GFRAMES + lane;
            const float* xi = wi + (k0 + pbeg) * PSTRIDE - t * GFRAMES + lane;
#pragma unroll
            for (int q = 0; q < KPW; ++q) {
                if (q < cnt) {
#pragma unroll
                    for (int m = 0; m < TPL; ++m) {
                        const float x = xr[PSTRIDE * q + 32 * m];
                        const float y = xi[PSTRIDE * q + 32 * m];
                        acc[2 * q] = fmaf(x, tr[m], acc[2 * q]);
                        acc[2 * q] = fmaf(-y, ti[m], acc[2 * q]);
                        acc[2 * q + 1] = fmaf(x, ti[m], acc[2 * q + 1]);
                        acc[2 * q + 1] = fmaf(y, tr[m], acc[2 * q + 1]);
                    }
                }
            }
            pfb::rs_level<8>(acc, lane);
            pfb::rs_level<4>(acc, lane);
            pfb::rs_level<2>(acc, lane);
            pfb::rs_level<1>(acc, lane);
            const float v = acc[0] + __shfl_xor_sync(FULL, acc[0], 16);
            const float vi = __shfl_down_sync(FULL, v, 1);
            const int q = lane >> 1;
            if (lane < 2 * KPW && !(lane & 1) && q < cnt)
                a.pe[(long long)c * a.n_k + k0 + pbeg + q] =
                    t < a.n_data_groups ? v * v + vi * vi : 0.f;
        }
        __syncthreads();

        // buffer b is read: the window two groups on goes there
        if (warp == 0 && it + 2 < n_mine) {
            copy_window(a, c2, t2, xs[b], &mb[b], lane);
            if (++t2 == a.n_groups) t2 = 0, ++c2;
        }

        // slicer and pack: word 16t + 4j + warp from ballot j
        const int bst = best_s;
        const float fb = (float)(bst & 7) * 0.125f;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int s = tid + THREADS * j;
            const float soft = bst >= 8 ? lerp_rn(dd[j], de1[j], fb)
                                        : lerp_rn(de[j], dd[j], fb);
            bool bit = soft >= 0.f;
            if (t >= a.n_data_groups) bit = true;
            if (t * GROUP + s >= a.n_sym) bit = false;
            const unsigned word = __ballot_sync(FULL, bit);
            const int wi_ = t * (GROUP / 32) + (s >> 5);
            if (lane == 0 && wi_ < a.nw)
                a.words[(long long)c * a.nw + wi_] = (int)word;
        }
        if (++t == a.n_groups) t = 0, ++c;
    }
}

extern "C" int demod_pack_launch(const float* yr, const float* yi, int C,
                                 int F, float gain, int n_sym, int n_groups,
                                 int n_data_groups, const float* taps_re,
                                 const float* taps_im, int T, int n_k,
                                 int* words, int nw, float* pe, void* stream)
{
    if (T < 1 || T > TMAX) return (int)cudaErrorInvalidValue;
    // persistent grid: every block the card holds at once, each taking a
    // contiguous run of groups, the runs as even as they divide (SM count
    // and occupancy cached per device: a process may launch on several)
    constexpr int MAX_DEV = 64;
    static int slots_of[MAX_DEV] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
    int slots = slots_of[dev];
    if (!slots) {
        int sms = 0, occ = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, demod_pack_kernel, THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        if (occ < 1) return (int)cudaErrorInvalidConfiguration;
        slots = slots_of[dev] = sms * occ;
    }
    const int total = C * n_groups;
    const int grid = total < slots ? total : slots;
    Args a;
    a.yr = yr;
    a.yi = yi;
    a.a0r = (int)(((uintptr_t)yr >> 2) & 3);
    a.a0i = (int)(((uintptr_t)yi >> 2) & 3);
    a.taps_re = taps_re;
    a.taps_im = taps_im;
    a.C = C;
    a.F = F;
    a.n_sym = n_sym;
    a.n_groups = n_groups;
    a.n_data_groups = n_data_groups;
    a.T = T;
    a.n_k = n_k;
    a.nw = nw;
    a.gain = gain;
    a.words = words;
    a.pe = pe;
    demod_pack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
