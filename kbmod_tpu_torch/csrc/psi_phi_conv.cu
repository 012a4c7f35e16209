// K1 for Hopper: the fused masked PSF convolution that builds psi and phi.
//
// Replaces the TPU kernel `_psi_phi_kernel` (kbmod_tpu/ops/conv_pallas.py:32,
// entry `psi_phi_conv_pallas`). For every image n and output pixel (y, x):
//
//   valid(p)  = isfinite(sci) && isfinite(var) && var > 0
//   psi_raw   = valid ? sci / var : 0      phi_raw = valid ? 1 / var : 0
//   m         = valid ? 1 : 0
//   apsi = sum k[i,j]   * psi_raw(y+i-ph, x+j-pw)   am1 = sum k[i,j]   * m(...)
//   aphi = sum k[i,j]^2 * phi_raw(...)               am2 = sum k[i,j]^2 * m(...)
//   psi  = apsi * (ksum  / max(am1, 1e-24))   (NaN where the centre is invalid)
//   phi  = aphi * (k2sum / max(am2, 1e-24))
//
// Out-of-image taps read as invalid, which is SAME zero padding with the
// masked renormalisation. Taps accumulate with i outer and j inner, each
// product and sum rounded on its own, so the kernel repeats the plain
// PyTorch twin (ops/conv_kernel.py) operation for operation and equals it
// bit for bit. k^2, ksum and k2sum come from the twin's own tap table.
//
// What bounds it on the H100: instruction issue. Each output pixel costs
// 8 * kh * kw float32 operations against 16 bytes of compulsory traffic
// (sci, var in; psi, phi out), far above the card's fp32 ridge. Bit
// equality forbids contracting k * p + a into one FMA, so every tap of
// apsi and aphi is a multiply and an add, each an instruction; at 132 SMs
// x 4 schedulers x 1.98 GHz that is a floor of 5.2 ms for 8 instructions a
// tap at T = 64, 2048 x 2048, 9 x 9 (NVIDIA H100 80GB HBM3, 700 W).
//
// The first design (one output a thread, a 32 x 8 tile, taps in shared
// memory) took 18.1 ms there (PERF.md, run J): every tap of every output
// cost four shared loads (the tap and the three planes) and a recomputed
// k * k, about 10 ms of shared-load issue alone. This design:
//
// - mask terms in one instruction: m is 0 or 1, so k * m is exact (k or
//   +-0) and fma(k, m, a) rounds a + k * m once, exactly as the twin's
//   separate multiply and add do (a + -0 = a, and a sum that starts at +0
//   stays +0 in round-to-nearest). So am1 and am2 cost one FFMA a tap, and
//   a tap is 6 instructions: a floor of 3.9 ms;
// - taps as kernel parameters for the common PSF sizes (odd squares up to
//   15 x 15, templated), so each multiply reads k or k^2 as a constant
//   operand, with no load at all;
// - register tiling: a thread computes kR = 4 outputs of a row; for each tap
//   row it reads the (kR + kw - 1)-pixel halo segment of each derived plane
//   once, with 16-byte loads free of bank conflicts (neighbouring threads
//   on neighbouring 16 bytes), and applies every tap of the row to its
//   outputs from registers: 0.25 loads per output and tap, not 4;
// - a 64 x 16 tile, so the halo (and its two IEEE divisions per input
//   pixel) is 1.7 input pixels an output for a 9 x 9 PSF, not 2.5.
//
// Other PSF sizes (even or non-square shapes, or wider than 15) run a
// generic kernel: one output a thread on a 32 x 8 tile, the taps in shared
// memory, the mask terms by FFMA as above, so it takes every PSF whose halo
// fits a block's shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 64;   // output columns per block (templated kernels)
constexpr int kTH = 16;   // output rows per block
constexpr int kR = 4;     // outputs a thread computes, side by side in a row
constexpr int kGW = 32, kGH = 8;  // the generic kernel's tile, one output a thread

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The tap table of a kh x kw PSF: k row-major, k * k, sum(k), sum(k * k).
template <int NTAP>
struct Taps {
    float k[NTAP];
    float k2[NTAP];
    float ksum, k2sum;
};

// Fill a rows x pitch halo of the derived planes whose origin is image
// pixel (gy0, gx0): psi_raw, phi_raw and m, zero outside the image.
__device__ __forceinline__ void build_halo(const float* __restrict__ sci, const float* __restrict__ var, size_t plane,
                                           int H, int W, int gy0, int gx0, int rows, int pitch, float* s_p, float* s_f,
                                           float* s_m) {
    const int nthr = blockDim.x * blockDim.y, tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int e = tid; e < rows * pitch; e += nthr) {
        const int gy = gy0 + e / pitch, gx = gx0 + e % pitch;
        float p = 0.0f, f = 0.0f, m = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const float s = sci[plane + (size_t)gy * W + gx];
            const float v = var[plane + (size_t)gy * W + gx];
            if (isfinite(s) && isfinite(v) && v > 0.0f) {
                p = __fdiv_rn(s, v);
                f = __fdiv_rn(1.0f, v);
                m = 1.0f;
            }
        }
        s_p[e] = p;
        s_f[e] = f;
        s_m[e] = m;
    }
}

// psi or phi of one output from its sums; NaN where the centre is invalid.
__device__ __forceinline__ float renormalised(bool centre, float acc, float sum, float am) {
    return centre ? __fmul_rn(acc, __fdiv_rn(sum, fmaxf(am, 1e-24f))) : NAN;
}

// Read kSeg consecutive floats (16-byte aligned) from shared memory.
template <int kSeg>
__device__ __forceinline__ void load_seg(float (&v)[kSeg], const float* src) {
#pragma unroll
    for (int q = 0; q < kSeg / 4; ++q) {
        const float4 w = reinterpret_cast<const float4*>(src)[q];
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
    }
}

// The register-tiled kernel for a KH x KW PSF: a 64 x 16 tile of 256
// threads, each kR outputs of one row; at least two blocks an SM, which
// caps a thread at 128 registers.
template <int KH, int KW>
__global__ void __launch_bounds__(kThreads, 2)
    conv_tiled(const float* __restrict__ sci, const float* __restrict__ var, const Taps<KH * KW> tp, int H, int W,
               float* __restrict__ psi, float* __restrict__ phi) {
    constexpr int kPitch = round4(kTW + KW - 1);  // halo row, padded to 16 bytes
    constexpr int kRows = kTH + KH - 1;
    constexpr int kSeg = round4(kR + KW - 1);     // a thread's halo segment
    __shared__ __align__(16) float s_p[kRows * kPitch];
    __shared__ __align__(16) float s_f[kRows * kPitch];
    __shared__ __align__(16) float s_m[kRows * kPitch];

    const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
    const size_t plane = (size_t)blockIdx.z * H * W;
    build_halo(sci, var, plane, H, W, y0 - KH / 2, x0 - KW / 2, kRows, kPitch, s_p, s_f, s_m);
    __syncthreads();

    const int tx = threadIdx.x % (kTW / kR), ty = threadIdx.x / (kTW / kR);
    float apsi[kR], aphi[kR], am1[kR], am2[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) apsi[r] = aphi[r] = am1[r] = am2[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < KH; ++i) {
        const int row = (ty + i) * kPitch + kR * tx;
        float v[kSeg];
        load_seg(v, s_p + row);
#pragma unroll
        for (int j = 0; j < KW; ++j) {
#pragma unroll
            for (int r = 0; r < kR; ++r) apsi[r] = __fadd_rn(apsi[r], __fmul_rn(tp.k[i * KW + j], v[r + j]));
        }
        load_seg(v, s_f + row);
#pragma unroll
        for (int j = 0; j < KW; ++j) {
#pragma unroll
            for (int r = 0; r < kR; ++r) aphi[r] = __fadd_rn(aphi[r], __fmul_rn(tp.k2[i * KW + j], v[r + j]));
        }
        load_seg(v, s_m + row);
#pragma unroll
        for (int j = 0; j < KW; ++j) {
#pragma unroll
            for (int r = 0; r < kR; ++r) {
                am1[r] = __fmaf_rn(tp.k[i * KW + j], v[r + j], am1[r]);
                am2[r] = __fmaf_rn(tp.k2[i * KW + j], v[r + j], am2[r]);
            }
        }
    }

    const int y = y0 + ty;
    if (y >= H) return;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int x = x0 + kR * tx + r;
        if (x >= W) break;
        const bool centre = s_m[(ty + KH / 2) * kPitch + kR * tx + r + KW / 2] > 0.0f;
        const size_t out = plane + (size_t)y * W + x;
        psi[out] = renormalised(centre, apsi[r], tp.ksum, am1[r]);
        phi[out] = renormalised(centre, aphi[r], tp.k2sum, am2[r]);
    }
}

// Shared memory of the generic kernel for a kh x kw PSF: the taps and the
// three halo planes of its 32 x 8 tile.
__host__ __device__ inline size_t generic_smem_bytes(int kh, int kw) {
    return sizeof(float) * ((size_t)kh * kw + 3 * (size_t)(kGH + kh - 1) * (kGW + kw - 1));
}

// Any PSF shape: one output a thread, taps in shared memory. taps: the
// device tap table (k, k * k, ksum, k2sum).
__global__ void __launch_bounds__(kGW * kGH)
    conv_generic(const float* __restrict__ sci, const float* __restrict__ var, const float* __restrict__ taps, int H,
                 int W, int kh, int kw, float* __restrict__ psi, float* __restrict__ phi) {
    extern __shared__ float smem[];
    const int HWd = kGW + kw - 1, HHd = kGH + kh - 1;
    const int ntap = kh * kw;
    float* s_k = smem;
    float* s_p = s_k + ntap;
    float* s_f = s_p + HHd * HWd;
    float* s_m = s_f + HHd * HWd;

    const int x0 = blockIdx.x * kGW, y0 = blockIdx.y * kGH;
    const size_t plane = (size_t)blockIdx.z * H * W;
    const int tid = threadIdx.y * kGW + threadIdx.x;
    for (int e = tid; e < ntap; e += kGW * kGH) s_k[e] = taps[e];
    build_halo(sci, var, plane, H, W, y0 - kh / 2, x0 - kw / 2, HHd, HWd, s_p, s_f, s_m);
    __syncthreads();

    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= W || y >= H) return;
    float apsi = 0.0f, aphi = 0.0f, am1 = 0.0f, am2 = 0.0f;
    for (int i = 0; i < kh; ++i) {
        const int row = (threadIdx.y + i) * HWd + threadIdx.x;
        for (int j = 0; j < kw; ++j) {
            const float k = s_k[i * kw + j];
            const float k2 = __fmul_rn(k, k);
            const float mv = s_m[row + j];
            apsi = __fadd_rn(apsi, __fmul_rn(k, s_p[row + j]));
            aphi = __fadd_rn(aphi, __fmul_rn(k2, s_f[row + j]));
            am1 = __fmaf_rn(k, mv, am1);
            am2 = __fmaf_rn(k2, mv, am2);
        }
    }
    const bool centre = s_m[(threadIdx.y + kh / 2) * HWd + threadIdx.x + kw / 2] > 0.0f;
    const size_t out = plane + (size_t)y * W + x;
    psi[out] = renormalised(centre, apsi, taps[2 * ntap], am1);
    phi[out] = renormalised(centre, aphi, taps[2 * ntap + 1], am2);
}

template <int K>
int launch_tiled(const float* sci, const float* var, const float* taps_host, int N, int H, int W, float* psi,
                 float* phi, cudaStream_t s) {
    Taps<K * K> tp;
    memcpy(&tp, taps_host, sizeof(tp));
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
    conv_tiled<K, K><<<grid, kThreads, 0, s>>>(sci, var, tp, H, W, psi, phi);
    return (int)cudaGetLastError();
}

// Calls CALL(K) for the templated K x K sizes.
#define KB_TILED_SIZES(CALL) CALL(1) CALL(3) CALL(5) CALL(7) CALL(9) CALL(11) CALL(13) CALL(15)

bool tiled(int kh, int kw) { return kh == kw && kh % 2 == 1 && kh <= 15; }

}  // namespace

extern "C" {

// Shared memory one block needs for a kh x kw PSF.
size_t kb_psi_phi_conv_smem_bytes(int kh, int kw) {
    if (tiled(kh, kw)) return 3 * sizeof(float) * (size_t)(kTH + kh - 1) * round4(kTW + kw - 1);
    return generic_smem_bytes(kh, kw);
}

// Resident blocks per SM of the kernel that serves a kh x kw PSF, or -1.
int kb_psi_phi_conv_blocks_per_sm(int kh, int kw) {
    int n = -1;
#define KB_OCC(K) \
    if (kh == K && kw == K) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_tiled<K, K>, kThreads, 0) ? -1 : n;
    if (tiled(kh, kw)) {
        KB_TILED_SIZES(KB_OCC)
    }
#undef KB_OCC
    const int smem = (int)generic_smem_bytes(kh, kw);
    if (cudaFuncSetAttribute(conv_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_generic, kGW * kGH, smem) != cudaSuccess)
        return -1;
    return n;
}

// sci, var, psi, phi: (N, H, W) float32, contiguous, on the device. The
// tap table (2 * kh * kw + 2 floats: k row-major, k * k, sum(k), sum(k * k))
// twice: taps on the device (read by the generic kernel) and taps_host in
// host memory (passed to the templated kernels as parameters). Launches on
// `stream`; returns cudaGetLastError().
int kb_psi_phi_conv(const float* sci, const float* var, const float* taps, const float* taps_host, int N, int H,
                    int W, int kh, int kw, float* psi, float* phi, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define KB_LAUNCH(K) \
    if (kh == K && kw == K) return launch_tiled<K>(sci, var, taps_host, N, H, W, psi, phi, s);
    if (tiled(kh, kw)) {
        KB_TILED_SIZES(KB_LAUNCH)
    }
#undef KB_LAUNCH
    const size_t smem = generic_smem_bytes(kh, kw);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(conv_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((W + kGW - 1) / kGW, (H + kGH - 1) / kGH, N);
    conv_generic<<<grid, dim3(kGW, kGH), smem, s>>>(sci, var, taps, H, W, kh, kw, psi, phi);
    return (int)cudaGetLastError();
}

}  // extern "C"
