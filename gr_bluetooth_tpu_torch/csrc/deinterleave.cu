// deinterleave: xp[p][d][j] = x[p][j*D + d], (2, n_x*D) -> (2, D, n_x).
//
// Replaces the TPU kernel gr_bluetooth_tpu/ops/pfb.py:_deinterleave, a
// tiled Pallas transpose.  Each plane's first n_x*D samples are an
// (n_x, D) row-major matrix; this writes its (D, n_x) transpose.
//
// A pure copy.  Bound on an H100 SXM at 80 Msps (D = 40, n_x = 86,267
// per 64-slot block): 27.6 MB read + 27.6 MB written = 55.2 MB, 16.5 us
// at 3.35 TB/s.  The design is the textbook shared-memory transpose:
// 32 x 32 tiles with one column of padding against bank conflicts, 32 x 8
// threads, loads coalesced along d and stores coalesced along j.  D = 40
// is not a multiple of 32, so both edges are masked (the second column
// of tiles holds 8 valid branches).

#include <cuda_runtime.h>

#define TILE 32
#define ROWS 8

__global__ void deinterleave_kernel(const float* __restrict__ x,
                                    long long plane_stride, int n_x, int D,
                                    float* __restrict__ out)
{
    __shared__ float tile[TILE][TILE + 1];
    const int p = blockIdx.z;
    const float* src = x + p * plane_stride;              // (n_x, D)
    float* dst = out + (long long)p * D * n_x;            // (D, n_x)
    const long long j0 = (long long)blockIdx.x * TILE;    // frames
    const int d0 = blockIdx.y * TILE;                     // branches

    for (int r = threadIdx.y; r < TILE; r += ROWS) {
        long long j = j0 + r;
        int d = d0 + threadIdx.x;
        if (j < n_x && d < D) tile[r][threadIdx.x] = src[j * D + d];
    }
    __syncthreads();
    for (int r = threadIdx.y; r < TILE; r += ROWS) {
        int d = d0 + r;
        long long j = j0 + threadIdx.x;
        if (j < n_x && d < D) dst[(long long)d * n_x + j] = tile[threadIdx.x][r];
    }
}

extern "C" int deinterleave_launch(const float* x, long long plane_stride,
                                   int n_x, int D, float* out, void* stream)
{
    if (n_x <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
    dim3 grid((n_x + TILE - 1) / TILE, (D + TILE - 1) / TILE, 2);
    dim3 block(TILE, ROWS);
    deinterleave_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, plane_stride, n_x, D, out);
    return (int)cudaGetLastError();
}
