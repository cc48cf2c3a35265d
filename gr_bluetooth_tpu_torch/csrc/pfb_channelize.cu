// pfb_channelize: polyphase DFT channelizer over deinterleaved branch rows.
//
// Replaces the TPU kernel gr_bluetooth_tpu/ops/pfb_kernel.py:
// pfb_channelize_fused (flat-input mode), the TPU branch of
// ops/pfb.py:_pfb_impl.  Its input is deinterleave.cu's (2, D, n_x)
// layout, xp[p][d][j] = x_p[jD + d], which is the order of _pfb_impl's
// own formulation: deinterleave, then Q shifted FMAs along frames.
//
//   y[c][j] for j < n = n_x - 2Q, as in pfb_tile.cuh
//
// Each block computes TF output frames.  Its window of TF + 2Q - 1
// frames is contiguous in each of the 2D branch rows, so the loads are
// coalesced; they are stored frame-major in shared memory, where the
// FIR + DFT body shared with pfb_snr.cu runs in FP32 (no tensor cores:
// TF32 would break the 2e-5 agreement).  Frames past n_x read as zero;
// outputs past n are not written.
//
// Bound on an H100 SXM (80 Msps, M = 80, C = 80, Q = 7, n = 86,253
// frames): the function needs the FIRs' 4MQ = 2,240 FP32 FLOP per frame
// and an 80-point FFT, 5 M log2 M = 2,529 at the conventional count,
// 0.41 GFLOP per block, 6 us at 67 TFLOP/s, against 82.8 MB of necessary
// traffic (27.6 MB of xp in, 55.2 MB of y out), 25 us at 3.35 TB/s:
// bound by bytes.  This first version computes the DFT directly, 8CM =
// 51,200 FLOP per frame (as the TPU kernel does on its MXU), which alone
// takes 66 us at the FP32 peak; it keeps xp, u and the y tile in shared
// memory and nothing more (the same design as pfb_snr.cu).  Reaching the
// byte bound needs an FFT-shaped DFT first.

#include <cuda_runtime.h>

#include "pfb_tile.cuh"

__global__ void pfb_channelize_kernel(const float* __restrict__ xp, int n_x,
                                      const float* __restrict__ h0,
                                      const float* __restrict__ h1,
                                      const float* __restrict__ dft_c,
                                      const float* __restrict__ dft_s,
                                      const float* __restrict__ bin_odd,
                                      int Q, int D, int C, int n,
                                      float* __restrict__ yr,
                                      float* __restrict__ yi)
{
    extern __shared__ float sm[];
    const int M = 2 * D;
    const int win = TF + 2 * Q - 1;              // input frames per tile
    float* xs = sm;                              // [2][win][D]
    float* us = xs + 2 * win * D;                // [2][M][TF]
    float* ys = us + 2 * M * TF;                 // [2][C][TF]

    const long long j0 = (long long)blockIdx.x * TF;

    // window frames [j0, j0 + win) of every branch row (p, d)
    for (int i = threadIdx.x; i < 2 * D * win; i += blockDim.x) {
        int t = i % win;
        int pd = i / win;                        // p * D + d
        long long f = j0 + t;
        float v = f < n_x ? xp[(long long)pd * n_x + f] : 0.f;
        xs[((pd / D) * win + t) * D + pd % D] = v;
    }
    __syncthreads();

    pfb_fir_tile(xs, us, h0, h1, Q, D, win);
    __syncthreads();

    for (int o = threadIdx.x; o < C * JG; o += blockDim.x) {
        int c = o % C;
        int jg = o / C;
        float ar[JPT], ai[JPT];
        pfb_dft_bin(us, dft_c, dft_s, bin_odd, M, C, c, jg, j0, ar, ai);
#pragma unroll
        for (int i = 0; i < JPT; ++i) {
            int j = jg + i * JG;
            ys[c * TF + j] = ar[i];
            ys[(C + c) * TF + j] = ai[i];
        }
    }
    __syncthreads();

    // coalesced y write-out, the ragged last tile masked
    for (int i = threadIdx.x; i < 2 * C * TF; i += blockDim.x) {
        int j = i % TF;
        int c = (i / TF) % C;
        int p = i / (TF * C);
        long long f = j0 + j;
        if (f < n) {
            float* dst = p ? yi : yr;
            dst[(long long)c * n + f] = ys[i];
        }
    }
}

extern "C" int pfb_channelize_launch(const float* xp, int n_x,
                                     const float* h0, const float* h1,
                                     const float* dft_c, const float* dft_s,
                                     const float* bin_odd, int Q, int D,
                                     int C, float* yr, float* yi,
                                     void* stream)
{
    int n = n_x - 2 * Q;
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int n_tiles = (n + TF - 1) / TF;
    int M = 2 * D;
    int win = TF + 2 * Q - 1;
    size_t smem = sizeof(float) *
        (2 * (size_t)win * D + 2 * (size_t)M * TF + 2 * (size_t)C * TF);
    // raise the dynamic shared memory limit once per library load (again
    // only if a launch needs more), not on every launch
    static size_t smem_set = 0;
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            pfb_channelize_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    int threads = ((C * JG + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    pfb_channelize_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
        xp, n_x, h0, h1, dft_c, dft_s, bin_odd, Q, D, C, n, yr, yi);
    return (int)cudaGetLastError();
}
