// pfb_snr: polyphase DFT channelizer + per-tile on-channel energies.
//
// Replaces the channelize and on-energy stages of the TPU megakernel
// gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_snr_demod_fused (the
// function of pfb_kernel.py:pfb_channelize_snr_fused).  Its probe
// band-pass stage lives in demod_pack.cu, which reads y anyway and whose
// 1024-frame window covers the probe's 201-frame band-pass windows.
//
//   u, y        as in pfb_tile.cuh (branch FIRs, DFT, rotator)
//   oe[c][tile] = sum_j |y[c][j]|^2 over the tile's TF frames
//
// x is read as flat (2, N) float32 planes; samples at index >= n_valid
// (= n_x * D) read as zero, which is what the TPU's staged layout holds
// past the block's data, so frames past the data match it.
//
// Bound on an H100 SXM (80 Msps, M = 80, C = 80, Q = 7, 86,300 frames):
// the function needs the FIRs' 2,240 FP32 FLOP per frame, an 80-point
// FFT (5 M log2 M = 2,529 at the conventional count) and 320 for the
// energies, 0.44 GFLOP per block, 7 us at 67 TFLOP/s, against about
// 83 MB of necessary traffic (27.6 MB of x in, 55 MB of y out), 25 us at
// 3.35 TB/s: bound by bytes.  This first version computes the DFT
// directly (80 x 80 x 8 = 51.2k FLOP per frame, 66 us at the FP32 peak,
// as the TPU kernel does on its MXU) and does nothing more than keep x,
// u and the y tile in shared memory: one thread owns one channel row and
// JPT frames of a tile (pfb_tile.cuh).  TF divides the 1250-frame slot,
// so each tile's energy sum belongs to exactly one slot.

#include <cuda_runtime.h>

#include "pfb_tile.cuh"

__global__ void pfb_snr_kernel(const float* __restrict__ x,
                               long long n_valid, long long plane_stride,
                               const float* __restrict__ h0,
                               const float* __restrict__ h1,
                               const float* __restrict__ dft_c,
                               const float* __restrict__ dft_s,
                               const float* __restrict__ bin_odd,
                               int Q, int D, int C, int n_frames,
                               float* __restrict__ yr,
                               float* __restrict__ yi,
                               float* __restrict__ oe)
{
    extern __shared__ float sm[];
    const int M = 2 * D;
    const int win = TF + 2 * Q - 1;              // input frames per tile
    float* xs = sm;                              // [2][win * D]
    float* us = xs + 2 * win * D;                // [2][M][TF]
    float* ys = us + 2 * M * TF;                 // [2][C][TF]
    float* op = ys + 2 * C * TF;                 // [JG][C]

    const int tile = blockIdx.x;
    const int n_tiles = gridDim.x;
    const long long j0 = (long long)tile * TF;

    // input window: frames [j0, j0 + win), contiguous in each plane
    const long long base = j0 * D;
    for (int i = threadIdx.x; i < win * D; i += blockDim.x) {
        long long s = base + i;
        float vr = 0.f, vi = 0.f;
        if (s < n_valid) {
            vr = x[s];
            vi = x[plane_stride + s];
        }
        xs[i] = vr;
        xs[win * D + i] = vi;
    }
    __syncthreads();

    pfb_fir_tile(xs, us, h0, h1, Q, D, win);
    __syncthreads();

    // thread (c, jg) owns frames jg + JG*i of bin c
    for (int o = threadIdx.x; o < C * JG; o += blockDim.x) {
        int c = o % C;
        int jg = o / C;
        float ar[JPT], ai[JPT];
        pfb_dft_bin(us, dft_c, dft_s, bin_odd, M, C, c, jg, j0, ar, ai);
        float e = 0.f;
#pragma unroll
        for (int i = 0; i < JPT; ++i) {
            int j = jg + i * JG;
            ys[c * TF + j] = ar[i];
            ys[(C + c) * TF + j] = ai[i];
            e += ar[i] * ar[i] + ai[i] * ai[i];
        }
        op[jg * C + c] = e;
    }
    __syncthreads();

    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float e = 0.f;
        for (int g = 0; g < JG; ++g) e += op[g * C + c];
        oe[(long long)c * n_tiles + tile] = e;
    }
    // coalesced y write-out
    for (int i = threadIdx.x; i < 2 * C * TF; i += blockDim.x) {
        int j = i % TF;
        int c = (i / TF) % C;
        int p = i / (TF * C);
        float* dst = p ? yi : yr;
        dst[(long long)c * n_frames + j0 + j] = ys[i];
    }
}

extern "C" int pfb_snr_tile_frames(void) { return TF; }

extern "C" int pfb_snr_launch(const float* x, long long n_valid,
                              long long plane_stride,
                              const float* h0, const float* h1,
                              const float* dft_c, const float* dft_s,
                              const float* bin_odd, int Q, int D, int C,
                              int n_frames, float* yr, float* yi, float* oe,
                              void* stream)
{
    if (n_frames % TF) return (int)cudaErrorInvalidValue;
    int n_tiles = n_frames / TF;
    int M = 2 * D;
    int win = TF + 2 * Q - 1;
    size_t smem = sizeof(float) *
        (2 * (size_t)win * D + 2 * (size_t)M * TF + 2 * (size_t)C * TF +
         (size_t)JG * C);
    // raise the kernel's dynamic shared memory limit once per library
    // load (again only if a launch needs more), not on every launch
    static size_t smem_set = 0;
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            pfb_snr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    int threads = ((C * JG + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    pfb_snr_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
        x, n_valid, plane_stride, h0, h1, dft_c, dft_s, bin_odd, Q, D, C,
        n_frames, yr, yi, oe);
    return (int)cudaGetLastError();
}
