// Per-tile body of the polyphase DFT channelizer kernels (pfb_snr.cu,
// pfb_channelize.cu): the branch FIRs over a window of input frames held
// frame-major in shared memory, and the M-point DFT onto the covered
// bins with the (-1)^{cn} rotator, all in FP32 on the CUDA cores.
//
//   u[p][r][j] = sum_q h[qM + r] x_p[(j0 + j)D + qM + r]      (branch FIRs)
//   y[c][j]    = (-1)^{bin_odd[c] (j0+j)} DFT_M{u[.][j]}_c     (bins c)
#pragma once

#define TF 50       // output frames per tile (divides slot_ch = 1250)
#define JPT 10      // frames per thread in the DFT
#define JG (TF / JPT)

// us[p][m][j] for the tile's TF frames from xs[p][t][d] (input frame t
// of the window, branch d < D; win frames per plane): branch m < D uses
// h0 at frame offsets 2q, branch m = D + d uses h1 at offsets 2q + 1.
__device__ __forceinline__ void pfb_fir_tile(const float* xs, float* us,
                                             const float* __restrict__ h0,
                                             const float* __restrict__ h1,
                                             int Q, int D, int win)
{
    const int M = 2 * D;
    for (int i = threadIdx.x; i < 2 * M * TF; i += blockDim.x) {
        int j = i % TF;
        int m = (i / TF) % M;
        int p = i / (TF * M);
        const float* xp = xs + p * win * D;
        float acc = 0.f;
        if (m < D) {
            for (int q = 0; q < Q; ++q)
                acc += xp[(j + 2 * q) * D + m] * h0[q * D + m];
        } else {
            int d = m - D;
            for (int q = 0; q < Q; ++q)
                acc += xp[(j + 2 * q + 1) * D + d] * h1[q * D + d];
        }
        us[(p * M + m) * TF + j] = acc;
    }
}

// Bin c of the tile's frames jg + JG*i (i < JPT), the tile starting at
// global frame j0, rotator applied.  Each DFT coefficient loaded feeds
// 4 x JPT FMAs.
__device__ __forceinline__ void pfb_dft_bin(const float* us,
                                            const float* __restrict__ dft_c,
                                            const float* __restrict__ dft_s,
                                            const float* __restrict__ bin_odd,
                                            int M, int C, int c, int jg,
                                            long long j0,
                                            float (&ar)[JPT], float (&ai)[JPT])
{
#pragma unroll
    for (int i = 0; i < JPT; ++i) { ar[i] = 0.f; ai[i] = 0.f; }
    for (int m = 0; m < M; ++m) {
        float cm = __ldg(dft_c + m * C + c);
        float sn = __ldg(dft_s + m * C + c);
        const float* ur = us + m * TF + jg;
        const float* ui = us + (M + m) * TF + jg;
#pragma unroll
        for (int i = 0; i < JPT; ++i) {
            float r = ur[i * JG], im = ui[i * JG];
            ar[i] += r * cm + im * sn;
            ai[i] += im * cm - r * sn;
        }
    }
    if (bin_odd[c] != 0.f) {
#pragma unroll
        for (int i = 0; i < JPT; ++i)
            if ((j0 + jg + i * JG) & 1) { ar[i] = -ar[i]; ai[i] = -ai[i]; }
    }
}
