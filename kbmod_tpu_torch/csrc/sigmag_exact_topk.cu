// K7 for Hopper: the exact in-search sigma-G top-K.
//
// Replaces no TPU kernel: the JAX package runs this search in XLA
// (kbmod_tpu/ops/search.py, search_topk_sigmag_exact). Its plain twin is
// kbmod_tpu_torch/ops/search.py search_topk_sigmag_exact on a CPU tensor.
// For every window pixel (i, j) and candidate c, in index order:
//
//   for t in 0..T-1 (in order):  y = y_min + i + dy[c,t],  x = x_min + j + dx[c,t]
//     if 0 <= y < H and 0 <= x < W and valid[t,y,x]:
//       psi_sum += psi[t,y,x];  phi_sum += phi[t,y,x];  obs += 1
//   unclipped gate (kernels.cu:201-203): obs >= min_obs, obs > 0 and
//     lh(psi_sum, phi_sum) >= min_lh, lh = psi / sqrt(phi), -1 where phi <= 0
//   only a pair that passes is clipped: its light curve psi/phi (0 where
//     phi == 0) sorted stably by (value, time); with (iL, iM, iH) the
//     percentile indices of its n samples (a host table, the twin's float64
//     formula), sigma = coeff * (v[iH] - v[iL]), the kept window runs from
//     start = min(#(v < v[iM] - 2 sigma), iM) to end = the first j > iM with
//     v[j] > v[iM] + 2 sigma, else n; the kept psi and phi are summed in
//     sorted order
//   insertion gate: lh(kept sums) >= min_lh; the pixel's top-K keeps
//     (lh, cand_offset + c) at p = #(top >= lh): (lh desc, index asc), the
//     order of the twin's stable merge, since candidates arrive in index order
//
// Empty slots stay (-FLT_MAX, -1). Every step rounds on its own (IEEE sqrt
// and division, no contraction into an fma where a product meets a sum), so
// the sums differ from the twin's PyTorch reductions by float32 rounding only.
//
// What bounds it on the H100: the sample loads. Every (pixel, candidate,
// time) sample is three loads (psi, phi, validity) and two adds; the twin
// also sorts every pair's curve and merges every chunk through device memory.
// Here one thread owns one start pixel and walks the candidates, so a pair
// costs its T samples in registers and nothing in device memory; the sort
// runs only for the pairs that pass the unclipped gate (at lh_level 25 on
// noise, a few in a million). Up to kLocalT samples it is a stable insertion
// of each sample, as it is read again, into the curve in local memory; past
// kLocalT the curve is not held at all but walked in sorted order, each step
// one pass over the pair's samples for the next in (value, time) order, so a
// clipped pair costs O(T^2) cached loads and any T runs. A block is 32 x 8
// pixels: a warp is one row of 32 neighbouring pixels, so one candidate's
// offset is one broadcast load and each sample load is one coalesced 128-byte
// row, and the 8 rows of a block share the L1 lines of neighbouring
// candidates' windows. The top list is in registers up to kRegK; a longer
// one stays in the maps themselves (kb_encoded::rank_insert_map, as K2-K5
// keep theirs past 64), so K is bounded by the maps' memory alone.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "encoded_common.cuh"

namespace {

constexpr int kBX = 32;  // window columns a block: one warp a row
constexpr int kBY = 8;   // window rows a block
constexpr int kThreads = kBX * kBY;
constexpr int kLocalT = 128;  // samples a clipped curve holds in local memory
constexpr int kRegK = 32;     // the longest top list in registers

using kb_encoded::likelihood;
using kb_encoded::kMapList;
using kb_encoded::rank_insert;
using kb_encoded::rank_insert_map;
using kb_encoded::store_top;

struct Args {
    const float* psi;
    const float* phi;
    const uint8_t* valid;
    const int2* off;  // (C, T) (dx, dy)
    const int* pct;   // (T + 1, 3) percentile indices (iL, iM, iH) by sample count
    int C, T, H, W, x_min, y_min, SH, SW, K_out, cand_offset;
    float min_obs, min_lh, coeff;
    float* top_lh;
    int* top_idx;
    unsigned long long* clipped;  // pairs clipped, or null
};

// The clipped lh of one (pixel, candidate) pair whose unclipped gate passed:
// its samples read again in time order, each inserted stably into the sorted
// curve, then the keep window of the twin's _clipped_scores and the kept sums
// in sorted order. T <= TB.
template <int TB>
__device__ __noinline__ float clipped_lh(const float* __restrict__ psi, const float* __restrict__ phi,
                                         const uint8_t* __restrict__ valid, const int2* __restrict__ off,
                                         const int* __restrict__ pct, int T, int H, int W, int x0, int y0,
                                         float coeff) {
    float v[TB], p[TB], f[TB];
    int n = 0;
    const size_t plane = (size_t)H * W;
    size_t base = 0;
    for (int t = 0; t < T; ++t, base += plane) {
        const int2 o = __ldg(off + t);
        const int x = x0 + o.x, y = y0 + o.y;
        if ((unsigned)x >= (unsigned)W || (unsigned)y >= (unsigned)H) continue;
        const size_t at = base + (size_t)(y * W + x);
        if (!__ldg(valid + at)) continue;
        const float ps = __ldg(psi + at), fs = __ldg(phi + at);
        const float lc = fs != 0.0f ? __fdiv_rn(ps, fs) : 0.0f;
        int k = n;
        for (; k > 0 && v[k - 1] > lc; --k) {
            v[k] = v[k - 1];
            p[k] = p[k - 1];
            f[k] = f[k - 1];
        }
        v[k] = lc;
        p[k] = ps;
        f[k] = fs;
        ++n;
    }
    if (n == 0) return -1.0f;
    const int iL = __ldg(pct + 3 * n), iM = __ldg(pct + 3 * n + 1), iH = __ldg(pct + 3 * n + 2);
    const float sigma = __fmul_rn(coeff, __fsub_rn(v[iH], v[iL]));
    const float reach = __fmul_rn(2.0f, sigma);
    const float lo = __fsub_rn(v[iM], reach), hi = __fadd_rn(v[iM], reach);
    int start = 0;
    for (int k = 0; k < n; ++k) start += v[k] < lo ? 1 : 0;
    start = min(start, iM);
    int end = n;
    for (int k = iM + 1; k < n; ++k) {
        if (v[k] > hi) {
            end = k;
            break;
        }
    }
    float ps = 0.0f, fs = 0.0f;
    for (int k = start; k < end; ++k) {
        ps = __fadd_rn(ps, p[k]);
        fs = __fadd_rn(fs, f[k]);
    }
    return likelihood(ps, fs);
}

// The sample after (vc, tc) in the curve's stable (value, time) order, by one
// pass over the pair's samples: its time, or -1 past the last, and its value,
// psi and phi in vn, pn, fn.
__device__ __forceinline__ int next_in_order(const float* __restrict__ psi, const float* __restrict__ phi,
                                             const uint8_t* __restrict__ valid, const int2* __restrict__ off,
                                             int T, int H, int W, int x0, int y0, float vc, int tc, float& vn,
                                             float& pn, float& fn) {
    int tn = -1;
    const size_t plane = (size_t)H * W;
    size_t base = 0;
    for (int t = 0; t < T; ++t, base += plane) {
        const int2 o = __ldg(off + t);
        const int x = x0 + o.x, y = y0 + o.y;
        if ((unsigned)x >= (unsigned)W || (unsigned)y >= (unsigned)H) continue;
        const size_t at = base + (size_t)(y * W + x);
        if (!__ldg(valid + at)) continue;
        const float ps = __ldg(psi + at), fs = __ldg(phi + at);
        const float lc = fs != 0.0f ? __fdiv_rn(ps, fs) : 0.0f;
        // Times ascend, so a later sample of the best value comes after it.
        if ((lc > vc || (lc == vc && t > tc)) && (tn < 0 || lc < vn)) {
            tn = t;
            vn = lc;
            pn = ps;
            fn = fs;
        }
    }
    return tn;
}

// clipped_lh for a curve of any length, not held: the n samples walked in
// sorted order (next_in_order) once up to the last percentile index, then
// again from the start to the end of the keep window, summing from its start.
// The same values, window and sums in the same order as clipped_lh.
__device__ __noinline__ float clipped_lh_walk(const float* __restrict__ psi, const float* __restrict__ phi,
                                              const uint8_t* __restrict__ valid, const int2* __restrict__ off,
                                              const int* __restrict__ pct, int T, int H, int W, int x0, int y0,
                                              float coeff, int n) {
    const int iL = __ldg(pct + 3 * n), iM = __ldg(pct + 3 * n + 1), iH = __ldg(pct + 3 * n + 2);
    float vc = -INFINITY, vn = 0.0f, pn = 0.0f, fn = 0.0f, vL = 0.0f, vM = 0.0f, vH = 0.0f;
    int tc = -1;
    for (int k = 0, last = max(iL, max(iM, iH)); k <= last; ++k) {
        tc = next_in_order(psi, phi, valid, off, T, H, W, x0, y0, vc, tc, vn, pn, fn);
        vc = vn;
        if (k == iL) vL = vc;
        if (k == iM) vM = vc;
        if (k == iH) vH = vc;
    }
    const float sigma = __fmul_rn(coeff, __fsub_rn(vH, vL));
    const float reach = __fmul_rn(2.0f, sigma);
    const float lo = __fsub_rn(vM, reach), hi = __fadd_rn(vM, reach);
    int start = 0;
    const size_t plane = (size_t)H * W;
    size_t base = 0;
    for (int t = 0; t < T; ++t, base += plane) {
        const int2 o = __ldg(off + t);
        const int x = x0 + o.x, y = y0 + o.y;
        if ((unsigned)x >= (unsigned)W || (unsigned)y >= (unsigned)H) continue;
        const size_t at = base + (size_t)(y * W + x);
        if (!__ldg(valid + at)) continue;
        const float fs = __ldg(phi + at);
        start += (fs != 0.0f ? __fdiv_rn(__ldg(psi + at), fs) : 0.0f) < lo ? 1 : 0;
    }
    start = min(start, iM);
    float ps = 0.0f, fs = 0.0f;
    vc = -INFINITY;
    tc = -1;
    for (int k = 0; k < n; ++k) {
        tc = next_in_order(psi, phi, valid, off, T, H, W, x0, y0, vc, tc, vn, pn, fn);
        vc = vn;
        if (k > iM && vc > hi) break;
        if (k >= start) {
            ps = __fadd_rn(ps, pn);
            fs = __fadd_rn(fs, fn);
        }
    }
    return likelihood(ps, fs);
}

// KB: the register list's length, or kMapList for a list kept in the maps.
// TB: the local curve's length, at least T, or kLocalT with T past it, whose
// curves are walked (clipped_lh_walk).
template <int KB, int TB>
__global__ void __launch_bounds__(kThreads) sigmag_exact_kernel(const Args a) {
    const int j = blockIdx.x * kBX + threadIdx.x;
    const int i = blockIdx.y * kBY + threadIdx.y;
    constexpr bool in_map = KB == kMapList;
    float top[in_map ? 1 : KB];
    int tidx[in_map ? 1 : KB];
#pragma unroll
    for (int k = 0; k < (in_map ? 1 : KB); ++k) {
        top[k] = -FLT_MAX;
        tidx[k] = -1;
    }
    unsigned long long clipped = 0;
    if (i < a.SH && j < a.SW) {
        const int x0 = a.x_min + j, y0 = a.y_min + i;
        const size_t plane = (size_t)a.H * a.W;
        const size_t pixel = (size_t)i * a.SW + j, map_plane = (size_t)a.SH * a.SW;
        if constexpr (in_map) {
            for (int k = 0; k < a.K_out; ++k) {
                a.top_lh[pixel + k * map_plane] = -FLT_MAX;
                a.top_idx[pixel + k * map_plane] = -1;
            }
        }
        for (int c = 0; c < a.C; ++c) {
            const int2* off = a.off + (size_t)c * a.T;
            float ps = 0.0f, fs = 0.0f;
            int obs = 0;
            size_t base = 0;
#pragma unroll 4
            for (int t = 0; t < a.T; ++t) {
                const int2 o = __ldg(off + t);
                const int x = x0 + o.x, y = y0 + o.y;
                if ((unsigned)x < (unsigned)a.W && (unsigned)y < (unsigned)a.H) {
                    const size_t at = base + (size_t)(y * a.W + x);
                    const float p = __ldg(a.psi + at), f = __ldg(a.phi + at);
                    if (__ldg(a.valid + at)) {
                        ps = __fadd_rn(ps, p);
                        fs = __fadd_rn(fs, f);
                        ++obs;
                    }
                }
                base += plane;
            }
            if (obs == 0 || (float)obs < a.min_obs || !(likelihood(ps, fs) >= a.min_lh)) continue;
            ++clipped;
            const float lh =
                a.T <= TB ? clipped_lh<TB>(a.psi, a.phi, a.valid, off, a.pct, a.T, a.H, a.W, x0, y0, a.coeff)
                          : clipped_lh_walk(a.psi, a.phi, a.valid, off, a.pct, a.T, a.H, a.W, x0, y0, a.coeff, obs);
            if (!(lh >= a.min_lh)) continue;
            if constexpr (in_map)
                rank_insert_map<false>(a.top_lh, a.top_idx, pixel, map_plane, a.K_out, lh, a.cand_offset + c);
            else
                rank_insert<KB, false>(top, tidx, lh, a.cand_offset + c);
        }
        if constexpr (!in_map) store_top<KB>(top, tidx, a.K_out, a.SH, a.SW, i, j, a.top_lh, a.top_idx);
    }
    if (a.clipped != nullptr) {
        // One row of the block is one warp: sum it, then the block, then one
        // atomic add a block.
        __shared__ unsigned long long block_sum;
        if (threadIdx.x == 0 && threadIdx.y == 0) block_sum = 0;
        __syncthreads();
        for (int o = 16; o > 0; o >>= 1) clipped += __shfl_down_sync(0xffffffffu, clipped, o);
        if (threadIdx.x == 0 && clipped) atomicAdd(&block_sum, clipped);
        __syncthreads();
        if (threadIdx.x == 0 && threadIdx.y == 0 && block_sum) atomicAdd(a.clipped, block_sum);
    }
}

template <int KB>
cudaError_t launch(const Args& a, cudaStream_t s) {
    const dim3 grid((a.SW + kBX - 1) / kBX, (a.SH + kBY - 1) / kBY);
    const dim3 block(kBX, kBY);
    if (a.T <= 32)
        sigmag_exact_kernel<KB, 32><<<grid, block, 0, s>>>(a);
    else
        sigmag_exact_kernel<KB, kLocalT><<<grid, block, 0, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// psi, phi: (T, H, W) float32 zero-filled, valid: (T, H, W) uint8, H * W <
// 2^31; off: (C, T, 2) int32 offsets (dx, dy); pct: (T + 1, 3) int32
// percentile indices by sample count, each in [0, max(n - 1, 0)]; the window
// x_min .. x_min + SW - 1, y_min .. y_min + SH - 1 (either may start below
// 0); top_lh, top_idx: (K_out, SH, SW); clipped: one uint64 that the pairs
// clipped are added to, or null. T >= 1, K_out >= 0 (0: nothing to do).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// what it cannot run).
int kb_sigmag_exact_topk(const float* psi, const float* phi, const uint8_t* valid, const int* off, const int* pct,
                         int C, int T, int H, int W, int x_min, int y_min, int SH, int SW, int K_out,
                         int cand_offset, float min_obs, float min_lh, float coeff, float* top_lh, int* top_idx,
                         unsigned long long* clipped, void* stream) {
    if (T < 1 || K_out < 0 || C < 0 || SH < 1 || SW < 1 || H < 1 || W < 1 || (long long)H * W >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (K_out == 0) return (int)cudaSuccess;
    const Args a{psi,  phi,   valid,         reinterpret_cast<const int2*>(off), pct, C, T, H, W, x_min, y_min, SH,
                 SW,   K_out, cand_offset,   min_obs, min_lh, coeff, top_lh, top_idx, clipped};
    cudaStream_t s = (cudaStream_t)stream;
    if (K_out <= 1) return (int)launch<1>(a, s);
    if (K_out <= 2) return (int)launch<2>(a, s);
    if (K_out <= 4) return (int)launch<4>(a, s);
    if (K_out <= 8) return (int)launch<8>(a, s);
    if (K_out <= 16) return (int)launch<16>(a, s);
    if (K_out <= kRegK) return (int)launch<kRegK>(a, s);
    return (int)launch<kMapList>(a, s);
}

}  // extern "C"
