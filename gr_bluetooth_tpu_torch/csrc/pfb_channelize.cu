// pfb_channelize: polyphase DFT channelizer over deinterleaved branch rows.
//
// Replaces the TPU kernel gr_bluetooth_tpu/ops/pfb_kernel.py:193
// pfb_channelize_fused (flat-input mode), the TPU branch of
// ops/pfb.py:_pfb_impl.  Its input is deinterleave.cu's (2, D, n_x)
// layout, xp[p][d][j] = x_p[jD + d], which is the order of _pfb_impl's
// own formulation: deinterleave, then Q shifted FMAs along frames.
//
//   y[c][j] for j < n = n_x - 2Q, as in pfb_tile.cuh
//
// Bound on an H100 SXM (80 Msps, M = 80, C = 80, Q = 7, n = 86,253
// frames): the function needs the FIRs' 4MQ = 2,240 FP32 FLOP per frame
// and an 80-point FFT, 5 M log2 M = 2,529 at the conventional count,
// 0.41 GFLOP per block, 6 us at 67 TFLOP/s, against 82.8 MB of necessary
// traffic (27.6 MB of xp in, 55.2 MB of y out), 24.7 us at 3.35 TB/s:
// bound by bytes.
//
// Design (pfb_tile.cuh, shared with pfb_snr.cu): persistent blocks walk
// tiles of 56 output frames; the DFT runs on the tensor cores in three
// TF32 passes.  A tile's window of 56 + 2Q - 1 frames is a 2-D box of
// the 2D branch rows, contiguous along frames; it is staged as it lies,
// row by row (odd stride ldb), each row placed so that its 16-byte
// aligned groups of frames stay aligned, and copied two tiles ahead
// with 16-byte cp.async, lanes over rows (a transposing copy of one
// frame per lane took four times the copy instructions).  The FIR reads
// it with lanes over branches: rows ldb apart, on distinct banks.
// Frames past n_x read as zero; outputs past n are not written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pfb_tile.cuh"

struct FlatSrc {
    static constexpr bool energy = false;
    const float* xp;
    long long n_tiles;
    int n_x, D;
    int ldb;          // stride of the staged rows: >= win + 6, odd
    int a0;           // xp's address in floats, mod 4

    // elements of branch row pd (p D + d) before its first one that is
    // 16-byte aligned in memory (tiles start at multiples of 4 frames)
    __device__ int head(int pd) const
    {
        return (int)(-(a0 + (long long)pd * n_x) & 3);
    }

    // where row pd starts in its plane: placed so that the elements
    // 16-byte aligned in xp are 16-byte aligned here too
    __device__ int row_start(int pd) const
    {
        const int d = pd >= D ? pd - D : pd;
        return d * ldb + ((-head(pd) - d * ldb) & 3);
    }

    // branch m's first frame: branch D + d reads row d one frame on
    __device__ int branch(const pfb::Layout& L, int p, int m) const
    {
        const int h = m >= D;
        return p * L.xplane + row_start(p * D + m - h * D) + h;
    }

    // frames [f0, f0 + win) of every branch row, rows side by side: lanes
    // over rows copy 16-byte aligned groups of 4 frames (the last one cut
    // at the window's end), then the heads before the first group, one
    // frame each; frames past n_x read as zero
    __device__ void copy(float* xb, const pfb::Layout& L, long long tile,
                         int tid, int nth) const
    {
        const long long f0 = tile * pfb::NT;
        const int rows = 2 * D, groups = (L.win + 3) / 4;
        for (int e = tid; e < rows * groups; e += nth) {
            const int pd = e % rows, t = head(pd) + 4 * (e / rows);
            if (t >= L.win) continue;
            const long long left = n_x - (f0 + t);
            const int n = L.win - t < 4 ? L.win - t : 4;
            const int bytes = left <= 0 ? 0 : 4 * (left < n ? (int)left : n);
            pfb::cp_async16(xb + (pd >= D) * L.xplane + row_start(pd) + t,
                            bytes ? xp + pd * (long long)n_x + f0 + t
                                  : xp + head(0),
                            bytes);
        }
        for (int e = tid; e < rows * 3; e += nth) {
            const int pd = e % rows, t = e / rows;
            if (t >= head(pd)) continue;
            const bool ok = f0 + t < n_x;
            pfb::cp_async4(xb + (pd >= D) * L.xplane + row_start(pd) + t,
                           ok ? xp + pd * (long long)n_x + f0 + t : xp, ok);
        }
    }
};

template <int MT>
__global__ void __launch_bounds__(pfb::THREADS)
pfb_channelize_kernel(FlatSrc src, pfb::Bank bk, pfb::Layout L, float* yr,
                      float* yi, long long n)
{
    extern __shared__ float4 smem4[];
    pfb::run<MT>(src, bk, L, reinterpret_cast<float*>(smem4), yr, yi, n,
                 nullptr, 0);
}

extern "C" int pfb_channelize_launch(const float* xp, int n_x,
                                     const float* h0, const float* h1,
                                     const float* dft_c, const float* dft_s,
                                     const float* bin_odd, int Q, int D,
                                     int C, float* yr, float* yi,
                                     void* stream)
{
    const int n = n_x - 2 * Q;
    if (n <= 0 || Q != pfb::QTAPS) return (int)cudaErrorInvalidValue;
    pfb::Layout L;
    int groups = 0, gx = 0;
    const int ldb = (pfb::window(Q) + 6) | 1;
    int rc = pfb::plan(D, Q, C, 1, D * ldb, &L, &groups);
    if (rc) return rc;
    const void* fn = PFB_KERNEL_FOR(pfb_channelize_kernel, L.MT);
    const size_t smem = sizeof(float) * (size_t)L.total;
    FlatSrc src{xp, (n + pfb::NT - 1) / pfb::NT, n_x, D, ldb,
                (int)(((uintptr_t)xp >> 2) & 3)};
    pfb::Bank bk{h0, h1, dft_c, dft_s, bin_odd, Q, D, C};
    long long n_out = n;
    rc = pfb::grid_x(fn, smem, groups, src.n_tiles, &gx);
    if (rc) return rc;
    void* args[] = {&src, &bk, &L, &yr, &yi, &n_out};
    return (int)cudaLaunchKernel(fn, dim3(gx, groups), dim3(pfb::THREADS),
                                 args, smem, (cudaStream_t)stream);
}
