// pfb_snr: polyphase DFT channelizer + per-tile on-channel energies.
//
// Replaces the channelize and on-energy stages of the TPU megakernel
// gr_bluetooth_tpu/ops/pfb_kernel.py:559 pfb_channelize_snr_demod_fused
// (the function of pfb_kernel.py:369 pfb_channelize_snr_fused).  Its
// probe band-pass stage lives in demod_pack.cu, which reads y anyway and
// whose 1024-frame window covers the probe's 201-frame band-pass windows.
//
//   u, y        as in pfb_tile.cuh (branch FIRs, DFT, rotator)
//   oe[c][k]    = sum_j |y[c][j]|^2 over frames [k TF, (k + 1) TF), TF = 50
//
// x is read as flat (2, N) float32 planes; samples at index >= n_valid
// (= n_x * D) read as zero, which is what the TPU's staged layout holds
// past the block's data, so frames past the data match it.
//
// Bound on an H100 SXM (80 Msps, M = 80, C = 80, Q = 7, 86,300 frames):
// the function needs the FIRs' 2,240 FP32 FLOP per frame, an 80-point
// FFT (5 M log2 M = 2,529 at the conventional count) and 320 for the
// energies, 0.44 GFLOP per block, 7 us at 67 TFLOP/s, against 83.9 MB of
// necessary traffic (27.6 MB of x in, 55.2 MB of y out), 25.0 us at
// 3.35 TB/s: bound by bytes.
//
// Design (pfb_tile.cuh): persistent blocks walk tiles of 56 frames (7 mma
// n-tiles); the DFT (4CM = 25,600 MAC per frame, three TF32 passes) runs
// on the tensor cores; the FIR reads the flat window with lanes over
// branches, which are contiguous in x, so its loads are conflict-free;
// a tile's window is one contiguous run of each plane, copied with
// 16-byte cp.async where x's alignment allows, two tiles ahead, while
// the tensor cores work.  The energy of each TF-frame run (TF = 50
// divides the 1250-frame slot) is summed from at most two tiles' rows
// (one butterfly of 31 shuffles per 7 rows and 3 runs), with two atomic
// adds onto zero, which gives the same sum in either order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pfb_tile.cuh"

#define TF 50       // frames per energy sum (divides slot_ch = 1250)

struct SnrSrc {
    static constexpr bool energy = true;
    const float* x;
    long long n_valid, plane_stride, n_tiles;
    int D;
    bool vec;         // x and plane_stride allow 16-byte copies

    // branch m's first frame in the window (frame-major rows of D samples;
    // branch D + d is sample d of the next frame)
    __device__ int branch(const pfb::Layout& L, int p, int m) const
    {
        return p * L.xplane + m;
    }

    // window frames [j0, j0 + win): samples [j0 D, (j0 + win) D) per plane
    __device__ void copy(float* xb, const pfb::Layout& L, long long tile,
                         int tid, int nth) const
    {
        const long long base = tile * pfb::NT * D;
        const int n = L.win * D;
        if (vec) {
            const int n4 = (n + 3) >> 2;
            for (int e = tid; e < 2 * n4; e += nth) {
                const int p = e >= n4, s = 4 * (e - p * n4);
                const long long left = n_valid - (base + s);
                const int bytes = left <= 0 ? 0
                                : left >= 4 ? 16 : 4 * (int)left;
                pfb::cp_async16(xb + p * L.xplane + s,
                                bytes ? x + p * plane_stride + base + s : x,
                                bytes);
            }
            return;
        }
        for (int e = tid; e < 2 * n; e += nth) {
            const int p = e >= n, s = e - p * n;
            const bool ok = base + s < n_valid;
            pfb::cp_async4(xb + p * L.xplane + s,
                           ok ? x + p * plane_stride + base + s : x, ok);
        }
    }
};

template <int MT>
__global__ void __launch_bounds__(pfb::THREADS)
pfb_snr_kernel(SnrSrc src, pfb::Bank bk, pfb::Layout L, float* yr,
               float* yi, long long n_frames, float* oe)
{
    extern __shared__ float4 smem4[];
    pfb::run<MT>(src, bk, L, reinterpret_cast<float*>(smem4), yr, yi,
                 n_frames, oe, TF);
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
    if (n_frames <= 0 || n_frames % TF || Q != pfb::QTAPS)
        return (int)cudaErrorInvalidValue;
    pfb::Layout L;
    int groups = 0, gx = 0;
    int rc = pfb::plan(D, Q, C, D, pfb::window(Q) * D, &L, &groups);
    if (rc) return rc;
    const void* fn = PFB_KERNEL_FOR(pfb_snr_kernel, L.MT);
    const size_t smem = sizeof(float) * (size_t)L.total;
    SnrSrc src{x, n_valid, plane_stride, (n_frames + pfb::NT - 1) / pfb::NT,
               D, (uintptr_t)x % 16 == 0 && plane_stride % 4 == 0};
    pfb::Bank bk{h0, h1, dft_c, dft_s, bin_odd, Q, D, C};
    long long n_out = n_frames;
    rc = pfb::grid_x(fn, smem, groups, src.n_tiles, &gx);
    if (rc) return rc;
    cudaStream_t st = (cudaStream_t)stream;
    // the tiles add their shares of each TF-frame energy
    cudaError_t err = cudaMemsetAsync(
        oe, 0, sizeof(float) * (size_t)C * (n_frames / TF), st);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&src, &bk, &L, &yr, &yi, &n_out, &oe};
    return (int)cudaLaunchKernel(fn, dim3(gx, groups), dim3(pfb::THREADS),
                                 args, smem, st);
}
