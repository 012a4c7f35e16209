// K5 for Hopper: the uint8 top-K search over candidate groups.
//
// Replaces the TPU kernel `_search_kernel_paired_grouped`
// (kbmod_tpu/ops/search_pallas.py:1493). It computes K3's function
// (csrc/search_topk_encoded.cu) for uint8 codes, with the candidates in
// groups of at most kG whose per-time rows lie within a few pixels of each
// other (the plan of kbmod_tpu_torch/ops/search_plan.py, in plan order):
//
//   for each group, for t in 0..T-1:
//     stage, once, the box of code pairs that covers every member's window
//     for this block's tile (the tile's rows plus the group's row spread,
//     its columns plus the group's column spread, within the image) in
//     shared memory;
//     every thread adds its pixels' codes for all members from there.
//   then decode each member's sums once and rank-insert it into the
//   pixel's top-K by (lh desc, global index asc).
//
// Candidates arrive in plan order, not index order, so the insert compares
// (lh, index) explicitly: exact ties rank by ascending global index, as in
// the per-candidate kernels. The sums are int32, so any T works (the TPU
// kernel's 16-bit fields needed a flush every 255 steps).
//
// What bounds it on the H100: operations, not HBM. The compulsory traffic
// is one read of the codes (2 bytes a pixel and time); every (pixel,
// candidate, time) sample is a bounds test, a shared-memory load, a
// validity test and three adds. The design serves a group's kG candidates
// from one staged window per time step, so the global (L2) reads per sample
// fall by up to kG against K3/K4 when the members' windows overlap; the
// staging moves 16-byte chunks (rows of the pair layout are padded to 8
// pairs). A block owns kTH x kTW pixels (kTH rows per thread, one column);
// its top-K list lives in the output map, which only this block touches:
// it is read into registers, updated with the group's members and written
// back once per group, so the registers hold the kG x kTH sums instead of
// kTH lists.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "encoded_common.cuh"

namespace {

constexpr int kTW = 256;  // threads per block = window columns per block
constexpr int kTH = 4;    // window rows per block (per thread)
constexpr int kG = 8;     // most candidates in a group

using kb_encoded::decode_sum;
using kb_encoded::gated;
using kb_encoded::likelihood;
using kb_encoded::rank_insert;

// Shared memory header: the group's offsets (kG x T twice) and one box per
// time step (x0, y0, pitch, rows), rounded up to 16 bytes.
__host__ __device__ inline size_t header_bytes(int T) {
    return (((size_t)(2 * kG + 4) * T * sizeof(int)) + 15) / 16 * 16;
}

template <int KB>
__global__ void __launch_bounds__(kTW)
    grouped_kernel(const uint16_t* __restrict__ pairs, const int* __restrict__ ox,
                   const int* __restrict__ oy, const int* __restrict__ gidx,
                   const uint8_t* __restrict__ cand_ok, const int* __restrict__ gstart, int NG,
                   int T, int H, int W, int Wp, int SH, int SW, int K_out, float psi_min,
                   float psi_scale, float phi_min, float phi_scale, float min_obs, float min_lh,
                   int gate_min_obs, int gate_min_lh, float* __restrict__ top_lh,
                   int* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_ox = reinterpret_cast<int*>(smem);  // (kG, T)
    int* s_oy = s_ox + kG * T;                 // (kG, T)
    int* s_box = s_oy + kG * T;                // (T, 4): x0, y0, pitch, rows
    uint16_t* s_pairs = reinterpret_cast<uint16_t*>(smem + header_bytes(T));

    const int col0 = blockIdx.x * kTW;
    const int j = col0 + threadIdx.x;
    const int i0 = blockIdx.y * kTH;
    const bool active = j < SW;
    const float psi_d = __fsub_rn(psi_min, psi_scale);
    const float phi_d = __fsub_rn(phi_min, phi_scale);
    const size_t plane_chunks = (size_t)H * (Wp / 8);
    const uint4* pairs4 = reinterpret_cast<const uint4*>(pairs);
    uint4* s_pairs4 = reinterpret_cast<uint4*>(s_pairs);

    if (active) {
        for (int r = 0; r < kTH; ++r) {
            if (i0 + r >= SH) break;
            for (int k = 0; k < K_out; ++k) {
                const size_t o = ((size_t)k * SH + i0 + r) * SW + j;
                top_lh[o] = -FLT_MAX;
                top_idx[o] = -1;
            }
        }
    }

    for (int g = 0; g < NG; ++g) {
        const int c0 = gstart[g];
        const int n = gstart[g + 1] - c0;
        __syncthreads();  // the previous group is done with the tables
        for (int e = threadIdx.x; e < n * T; e += kTW) {
            s_ox[e] = ox[(size_t)c0 * T + e];
            s_oy[e] = oy[(size_t)c0 * T + e];
        }
        __syncthreads();
        // The box of each time step: every member's window within the image.
        for (int t = threadIdx.x; t < T; t += kTW) {
            int xmin = INT_MAX, xmax = INT_MIN, ymin = INT_MAX, ymax = INT_MIN;
            for (int m = 0; m < n; ++m) {
                xmin = min(xmin, s_ox[m * T + t]);
                xmax = max(xmax, s_ox[m * T + t]);
                ymin = min(ymin, s_oy[m * T + t]);
                ymax = max(ymax, s_oy[m * T + t]);
            }
            const int y0 = max(i0 + ymin, 0), y1 = min(i0 + ymax + kTH, H);
            const int x0 = max(col0 + xmin, 0), x1 = min(col0 + xmax + kTW, W);
            const int x0a = x0 & ~7;  // 16-byte aligned start
            const bool empty = y1 <= y0 || x1 <= x0;
            s_box[4 * t + 0] = x0a;
            s_box[4 * t + 1] = y0;
            s_box[4 * t + 2] = empty ? 0 : (x1 - x0a + 7) & ~7;
            s_box[4 * t + 3] = empty ? 0 : y1 - y0;
        }

        int ap[kG][kTH], af[kG][kTH], ao[kG][kTH];
#pragma unroll
        for (int m = 0; m < kG; ++m) {
#pragma unroll
            for (int r = 0; r < kTH; ++r) ap[m][r] = af[m][r] = ao[m][r] = 0;
        }

        for (int t = 0; t < T; ++t) {
            __syncthreads();  // the box of t - 1 is consumed (and the boxes are written)
            const int bx0 = s_box[4 * t + 0], by0 = s_box[4 * t + 1];
            const int pitch = s_box[4 * t + 2], rows = s_box[4 * t + 3];
            const int cpr = pitch / 8;  // 16-byte chunks per box row
            const uint4* src = pairs4 + (size_t)t * plane_chunks + (size_t)by0 * (Wp / 8) + bx0 / 8;
            for (int e = threadIdx.x; e < rows * cpr; e += kTW) {
                const int r = e / cpr, c = e - r * cpr;
                s_pairs4[e] = src[(size_t)r * (Wp / 8) + c];
            }
            __syncthreads();
            if (!active) continue;
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const int x = s_ox[m * T + t] + j;
                    const int yb = s_oy[m * T + t] + i0;
                    const bool xin = (unsigned)x < (unsigned)W;
#pragma unroll
                    for (int r = 0; r < kTH; ++r) {
                        const int y = yb + r;
                        if (xin && (unsigned)y < (unsigned)H) {
                            const uint32_t v = s_pairs[(y - by0) * pitch + (x - bx0)];
                            const int p = (int)(v & 0xFFu), f = (int)(v >> 8);
                            const bool both = (p != 0) & (f != 0);
                            ap[m][r] += both ? p : 0;
                            af[m][r] += both ? f : 0;
                            ao[m][r] += both ? 1 : 0;
                        }
                    }
                }
            }
        }

        if (!active) continue;
#pragma unroll
        for (int r = 0; r < kTH; ++r) {
            const int i = i0 + r;
            if (i >= SH) break;
            float top[KB];
            int tidx[KB];
#pragma unroll
            for (int k = 0; k < KB; ++k) {
                const size_t o = ((size_t)k * SH + i) * SW + j;
                top[k] = k < K_out ? top_lh[o] : -FLT_MAX;
                tidx[k] = k < K_out ? top_idx[o] : -1;
            }
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const float obs = (float)ao[m][r];
                    const float lh = likelihood(decode_sum(ap[m][r], obs, psi_scale, psi_d),
                                                decode_sum(af[m][r], obs, phi_scale, phi_d));
                    const float nv = gated(lh, ao[m][r], cand_ok[c0 + m] != 0, min_obs, min_lh,
                                           gate_min_obs, gate_min_lh);
                    rank_insert<KB, true>(top, tidx, nv, gidx[c0 + m]);
                }
            }
#pragma unroll
            for (int k = 0; k < KB; ++k) {
                if (k < K_out) {
                    const size_t o = ((size_t)k * SH + i) * SW + j;
                    top_lh[o] = top[k];
                    top_idx[o] = tidx[k];
                }
            }
        }
    }
}

}  // namespace

extern "C" {

int kb_search_grouped_max_group() { return kG; }

// The block's tile: axis 0 its rows, axis 1 its columns.
int kb_search_grouped_tile(int axis) { return axis == 0 ? kTH : kTW; }

// Shared memory for T time steps and boxes of at most box_rows x box_cols
// code pairs (box_cols a multiple of 8).
size_t kb_search_grouped_smem_bytes(int T, int box_rows, int box_cols) {
    return header_bytes(T) + (size_t)box_rows * box_cols * sizeof(uint16_t);
}

// pairs: (T, H, Wp) uint8 code pairs as 16-bit words, Wp a multiple of 8,
// 16-byte aligned; ox, oy: (C, T) int32 window-origin offsets in plan
// order; gidx: (C,) global candidate indices and cand_ok (C,) uint8, in
// plan order; gstart: (NG + 1,) group bounds within the plan, each group
// 1..8 candidates; top_lh, top_idx: (K_out, SH, SW). smem: the bytes from
// kb_search_grouped_smem_bytes for the plan's largest box. K_out <= 64.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for what it cannot run).
int kb_search_grouped(const void* pairs, const int* ox, const int* oy, const int* gidx,
                      const uint8_t* cand_ok, const int* gstart, int NG, int T, int H, int W,
                      int Wp, int SH, int SW, int K_out, int smem, float psi_min, float psi_scale,
                      float phi_min, float phi_scale, float min_obs, float min_lh,
                      int gate_min_obs, int gate_min_lh, float* top_lh, int* top_idx,
                      void* stream) {
    if (Wp % 8 != 0 || (reinterpret_cast<uintptr_t>(pairs) & 15) != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
#define KB_LAUNCH(KB)                                                                              \
    {                                                                                              \
        auto k = grouped_kernel<KB>;                                                               \
        if (smem > 48 * 1024) {                                                                    \
            cudaError_t err =                                                                      \
                cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);        \
            if (err != cudaSuccess) return (int)err;                                               \
        }                                                                                          \
        k<<<grid, kTW, smem, s>>>((const uint16_t*)pairs, ox, oy, gidx, cand_ok, gstart, NG, T, H, \
                                  W, Wp, SH, SW, K_out, psi_min, psi_scale, phi_min, phi_scale,    \
                                  min_obs, min_lh, gate_min_obs, gate_min_lh, top_lh, top_idx);    \
        return (int)cudaGetLastError();                                                            \
    }
    if (K_out <= 1) KB_LAUNCH(1);
    if (K_out <= 2) KB_LAUNCH(2);
    if (K_out <= 4) KB_LAUNCH(4);
    if (K_out <= 8) KB_LAUNCH(8);
    if (K_out <= 16) KB_LAUNCH(16);
    if (K_out <= 32) KB_LAUNCH(32);
    if (K_out <= 64) KB_LAUNCH(64);
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
