// demod_pack: GFSK discriminator + 16-phase feedforward timing + slicer +
// 32-symbols-per-word packing, plus the SNR probe band-pass energies.
//
// Replaces the demod stages of the TPU megakernel
// gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_snr_demod_fused (the
// function of gr_bluetooth_tpu/ops/demod_kernel.py:demod_timing_pack) and
// the megakernel's probe band-pass products (pfb_kernel.py:494-506).
//
// One block per (512-symbol group t, channel row c), one thread per
// symbol.  The block's window is y[c][1024t + l], frames past the stream
// reading as zero:
//   d[l]     = gain * atan2_poly(Im, Re)(y[l+1] conj(y[l]))
//   metric_p = sum_{s < nvalid} |d[2s+par](1-f) + d[2s+par+1] f|,
//              f = (p % 8) / 8, par = p / 8 (16 hypotheses)
//   best     = first maximum over p (earliest on ties)
//   bit_s    = d[2s+par*](1-f*) + d[2s+par*+1] f* >= 0
// and the word is the warp's ballot over its 32 symbols.  Groups at or
// past the data (t >= n_data_groups) write all-ones words, as the TPU
// kernel does, and the bits of symbols >= n_sym are zero.
//
// The discriminator and interpolation use explicitly rounded operations
// (__fmul_rn & co., never contracted into FMAs), so d, the soft values
// and the slicer match the plain PyTorch version bit for bit; only the
// order of the 512-term metric sums differs.
//
// Probe: for the global 40-frame grid points k with 40k in
// [1024t, 1024(t+1)) and k < n_k, pe[c][k] = |sum_l y[40k+l] tap[l]|^2.
//
// Bound on an H100 SXM (80 rows, 43,125 symbols, 2,156 probe points):
// the 55 MB read of y is 16 us at 3.35 TB/s; the operations, about 100
// FLOP per frame and row for the demod and 201 x 8 FLOP per probe point,
// are about 1 GFLOP, 15 us at 67 TFLOP/s: near balance.  This first
// version keeps each window in shared memory and does nothing more.

#include <cuda_runtime.h>

#define GROUP 512
#define GFRAMES 1024
#define NPH 16
#define PSTRIDE 40

__device__ __forceinline__ float atan2_poly(float y, float x)
{
    // octant reduction + Cephes atanf polynomial; the float32 constants
    // are written exactly (as the reference rounds them)
    float ax = fabsf(x), ay = fabsf(y);
    bool swap = ay > ax;
    float num = swap ? ax : ay;
    float den = swap ? ay : ax;
    float q = __fdiv_rn(num, den == 0.f ? 1.f : den);
    bool big = q > 0x1.a8279ap-2f;                        // tan(pi/8)
    float t = big ? __fdiv_rn(__fsub_rn(q, 1.f), __fadd_rn(q, 1.f)) : q;
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

__global__ void demod_pack_kernel(const float* __restrict__ yr,
                                  const float* __restrict__ yi,
                                  int F, float gain, int n_sym,
                                  int n_data_groups,
                                  const float* __restrict__ taps_re,
                                  const float* __restrict__ taps_im,
                                  int T, int n_k, int win,
                                  int* __restrict__ words, int nw,
                                  float* __restrict__ pe)
{
    extern __shared__ float sm[];
    float* wr = sm;                      // [win]
    float* wi = wr + win;                // [win]
    float* d = wi + win;                 // [GFRAMES + 1]
    float* part = d + GFRAMES + 1;       // [GROUP / 32][NPH]
    __shared__ int best;

    const int t = blockIdx.x;
    const int c = blockIdx.y;
    const int s = threadIdx.x;           // symbol in the group
    const int lane = s & 31, warp = s >> 5;
    const long long f0 = (long long)t * GFRAMES;
    const float* rowr = yr + (long long)c * F;
    const float* rowi = yi + (long long)c * F;

    for (int l = s; l < win; l += blockDim.x) {
        long long g = f0 + l;
        wr[l] = g < F ? rowr[g] : 0.f;
        wi[l] = g < F ? rowi[g] : 0.f;
    }
    __syncthreads();

    for (int l = s; l <= GFRAMES; l += blockDim.x) {
        float pr = __fadd_rn(__fmul_rn(wr[l + 1], wr[l]),
                             __fmul_rn(wi[l + 1], wi[l]));
        float pim = __fsub_rn(__fmul_rn(wi[l + 1], wr[l]),
                              __fmul_rn(wr[l + 1], wi[l]));
        d[l] = __fmul_rn(gain, atan2_poly(pim, pr));
    }
    __syncthreads();

    int nvalid = n_sym - t * GROUP;
    nvalid = nvalid < 0 ? 0 : (nvalid > GROUP ? GROUP : nvalid);
    float de = d[2 * s], dd = d[2 * s + 1], de1 = d[2 * s + 2];
    float m[NPH];
#pragma unroll
    for (int p8 = 0; p8 < 8; ++p8) {
        float f = p8 * 0.125f;
        bool v = s < nvalid;
        m[p8] = v ? fabsf(lerp_rn(de, dd, f)) : 0.f;
        m[8 + p8] = v ? fabsf(lerp_rn(dd, de1, f)) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < NPH; ++p) {
        float v = m[p];
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) part[warp * NPH + p] = v;
    }
    __syncthreads();
    if (s == 0) {
        float bestv = 0.f;
        int besti = 0;
        for (int p = 0; p < NPH; ++p) {
            float v = 0.f;
            for (int w = 0; w < GROUP / 32; ++w) v += part[w * NPH + p];
            if (p == 0 || v > bestv) { bestv = v; besti = p; }
        }
        best = besti;
    }
    __syncthreads();

    int b = best;
    float fb = (float)(b % 8) * 0.125f;
    float soft = b >= 8 ? lerp_rn(dd, de1, fb) : lerp_rn(de, dd, fb);
    bool bit = soft >= 0.f;
    if (t >= n_data_groups) bit = true;
    if (t * GROUP + s >= n_sym) bit = false;
    unsigned word = __ballot_sync(0xffffffffu, bit);
    int wi_ = t * (GROUP / 32) + warp;
    if (lane == 0 && wi_ < nw) words[(long long)c * nw + wi_] = (int)word;

    // probe band-pass energies at this group's grid points, one warp each
    int k0 = (t * GFRAMES + PSTRIDE - 1) / PSTRIDE;
    int k1 = ((t + 1) * GFRAMES + PSTRIDE - 1) / PSTRIDE;
    if (k1 > n_k) k1 = n_k;
    for (int k = k0 + warp; k < k1; k += blockDim.x / 32) {
        int l0 = k * PSTRIDE - t * GFRAMES;
        float rr = 0.f, ri = 0.f, ir = 0.f, ii = 0.f;
        for (int l = lane; l < T; l += 32) {
            float a = wr[l0 + l], bq = wi[l0 + l];
            float tr = __ldg(taps_re + l), ti = __ldg(taps_im + l);
            rr += a * tr; ri += a * ti; ir += bq * tr; ii += bq * ti;
        }
        for (int off = 16; off > 0; off >>= 1) {
            rr += __shfl_down_sync(0xffffffffu, rr, off);
            ri += __shfl_down_sync(0xffffffffu, ri, off);
            ir += __shfl_down_sync(0xffffffffu, ir, off);
            ii += __shfl_down_sync(0xffffffffu, ii, off);
        }
        if (lane == 0) {
            float p_re = rr - ii, p_im = ri + ir;
            float e = p_re * p_re + p_im * p_im;
            pe[(long long)c * n_k + k] = t < n_data_groups ? e : 0.f;
        }
    }
}

extern "C" int demod_pack_launch(const float* yr, const float* yi, int C,
                                 int F, float gain, int n_sym, int n_groups,
                                 int n_data_groups, const float* taps_re,
                                 const float* taps_im, int T, int n_k,
                                 int* words, int nw, float* pe, void* stream)
{
    // window: 1026 frames for the discriminator, 1023 + T for the probe
    int win = GFRAMES + 2;
    if (GFRAMES - 1 + T > win) win = GFRAMES - 1 + T;
    size_t smem = sizeof(float) *
        (2 * (size_t)win + GFRAMES + 1 + (GROUP / 32) * NPH);
    // raise the kernel's dynamic shared memory limit once per library
    // load (again only if a launch needs more), not on every launch
    static size_t smem_set = 0;
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            demod_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    dim3 grid(n_groups, C);
    demod_pack_kernel<<<grid, GROUP, smem, (cudaStream_t)stream>>>(
        yr, yi, F, gain, n_sym, n_data_groups, taps_re, taps_im, T, n_k,
        win, words, nw, pe);
    return (int)cudaGetLastError();
}
