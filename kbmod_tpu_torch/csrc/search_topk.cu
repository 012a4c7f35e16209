// K2 for Hopper: the float shift-and-stack search with a per-pixel top-K.
//
// Replaces the TPU kernel `_search_kernel` (kbmod_tpu/ops/search_pallas.py:182,
// entry `search_topk_pallas`). For every window pixel (i, j) and candidate c:
//
//   for t in 0..T-1 (in order):  y = oy[c,t] + i,  x = ox[c,t] + j
//     if 0 <= y < H and 0 <= x < W and valid[t,y,x]:
//       psi_sum += psi[t,y,x];  phi_sum += phi[t,y,x];  obs += 1
//   lh  = phi_sum > 0 ? psi_sum / sqrt(phi_sum) : -1   (IEEE div and sqrt)
//   ok  = cand_ok[c] && (!gate_min_obs || obs >= min_obs)
//                    && (!gate_min_lh  || lh  >= min_lh)
//   the pixel's top-K keeps (ok ? lh : -inf, cand_offset + c), ranked by
//   (lh desc, index asc)
//
// oy/ox already hold the window origin (y_min + dy, x_min + dx), which lets
// windows be larger than the image or start at negative coordinates. Empty
// slots stay (-FLT_MAX, -1). The lh arithmetic is that of the XLA reference
// (`search_topk_shift`, kbmod_tpu/ops/search.py:819), not the TPU kernel's
// rsqrt.
//
// What bounds it on the H100: operations and the load path, not HBM. The
// compulsory traffic is one read of psi, phi and valid (9 bytes a pixel and
// time), but there are C * T samples per input pixel, each a validity test,
// two float adds and a count. The first design (one pixel a thread, batches
// of 8 candidates sweeping every plane again from L2, three global loads and
// a bounds test a sample, nothing overlapping the loads) ran 166x its bound
// on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
// This design:
//
// - candidates come in groups of at most kG from the host plan
//   (ops/search_plan.py: members' rows within 8 pixels of each other, or
//   identical), in plan order;
// - a block owns kTH x kTW window pixels (a thread one column of four rows,
//   or of two where a long top-K list makes the block 512 threads: Shape);
//   for each (group, t) it stages, with cp.async 16-byte copies, the psi,
//   phi and validity pixels the members' windows read (one box over all of
//   them, or one slab per member where that is smaller: csrc/stage_window.cuh),
//   double-buffered so the copy for t + 1 runs while t is summed, with one
//   barrier a step; pixels outside the image arrive as zeros with validity 0,
//   so a sample is three shared loads, two adds of a selected value and a
//   count, with no bounds test;
// - the group's tables (offsets, layout rows) sit in shared memory 64 steps
//   at a time (stage_window.cuh), so shared memory does not grow with T:
//   holding all T steps at once (116 bytes a step) refused T >= 1,000 at
//   the 41 x 41 grid's layout, where the JAX package has no such cap;
// - each thread sums its rows for every member in t order, the adds of the
//   twin in the twin's order (an invalid sample adds +0.0 in the twin, which
//   leaves a sum that starts at +0.0 unchanged), so the result is bit-equal;
// - the top-K lives in the output map, read and written once per group, and
//   members insert by (lh desc, index asc) (rank_insert<KB, true>), so the
//   plan's order does not change the result. A list longer than 64 does not
//   fit the registers: that instantiation (kMapList) inserts into the maps
//   in place (rank_insert_map), so K is bounded by the maps' memory alone.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "encoded_common.cuh"
#include "stage_window.cuh"

namespace {

constexpr int kTW = 256;  // window columns per block
constexpr int kTH = 4;    // window rows per block
constexpr int kCH = 16;   // staging chunk in pixels: 64 bytes of float, 16 of validity

using kb_encoded::gated;
using kb_encoded::likelihood;
using kb_encoded::rank_insert;
using kb_stage::header_bytes;
using kb_stage::kG;
using kb_stage::kLay;
using kb_stage::kRows;

// One staging buffer: buf_elems pixels of psi, of phi (float) and of validity.
__host__ __device__ inline size_t buffer_bytes(int buf_elems) { return (size_t)buf_elems * 9; }

// The block shape for a top-K list of KB: 256 threads of four rows each
// (two blocks an SM: 16 warps to hide the shared-load latency, at most 128
// registers a thread, which the sums and a list of up to 16 fit), or, for
// longer lists, whose registers allow one block an SM, 512 threads of two
// rows each, so that block still has 16 warps.
template <int KB>
struct Shape {
    static constexpr int kThreads = KB >= 32 ? 512 : 256;
    static constexpr int kR = kTH * kTW / kThreads;  // window rows per thread
    static constexpr int kMinBlocks = KB >= 32 ? 1 : 2;
};

struct Planes {
    const float* psi;
    const float* phi;
    const uint8_t* valid;
    int T, H, W, Wp;
    int has_masked;
};

// Issue the copies of time step t's windows into buffer b; lt is the
// table row that holds step t.
template <int NT>
__device__ __forceinline__ void stage_step(const Planes& P, unsigned char* buf, int buf_elems,
                                           const kb_stage::Tables& s, int t, int lt, int i0, int col0) {
    const int* lay = s.lay + lt * kLay;
    const int nrows = lay[0] * lay[1], pitch = lay[2];
    const int fchunks = pitch / 4, vchunks = P.has_masked ? pitch / 16 : 0;
    const int per_row = 2 * fchunks + vchunks;
    float* d_psi = reinterpret_cast<float*>(buf);
    float* d_phi = d_psi + buf_elems;
    uint8_t* d_val = reinterpret_cast<uint8_t*>(d_phi + buf_elems);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int sr = warp; sr < nrows; sr += NT / 32) {
        int y, x;
        kb_stage::slab_row_origin(s, lt, sr, i0, col0, kCH, y, x);
        const bool yin = (unsigned)y < (unsigned)P.H;
        const size_t row = ((size_t)t * P.H + (yin ? y : 0)) * P.Wp;
        const int drow = sr * pitch;
        for (int c = lane; c < per_row; c += 32) {
            if (c < 2 * fchunks) {
                const bool second = c >= fchunks;
                const int xs = x + 4 * (c - (second ? fchunks : 0));
                const bool ok = yin && xs >= 0 && xs < P.Wp;
                const float* src = (second ? P.phi : P.psi) + (ok ? row + xs : 0);
                kb_stage::cp_async16((second ? d_phi : d_psi) + drow + (xs - x), src, ok);
            } else {
                const int xs = x + 16 * (c - 2 * fchunks);
                const bool ok = yin && xs >= 0 && xs < P.Wp;
                kb_stage::cp_async16(d_val + drow + (xs - x), P.valid + (ok ? row + xs : 0), ok);
            }
        }
    }
    kb_stage::cp_async_commit();
}

// kLong: T > kRows, so the tables are reloaded every kStride steps; the
// instantiation for shorter stacks has no reload code at all.
template <int KB, bool kLong>
__global__ void __launch_bounds__(Shape<KB>::kThreads, Shape<KB>::kMinBlocks)
    search_topk_kernel(Planes P, const int* __restrict__ ox, const int* __restrict__ oy,
                       const int* __restrict__ gidx, const uint8_t* __restrict__ cand_ok,
                       const int* __restrict__ gstart, const int* __restrict__ lay,
                       const int* __restrict__ off, int NG, int SH, int SW, int K_out, int buf_elems,
                       float min_obs, float min_lh, int gate_min_obs, int gate_min_lh,
                       float* __restrict__ top_lh, int* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int NT = Shape<KB>::kThreads, R = Shape<KB>::kR;
    const int T = P.T;
    const kb_stage::Plan plan{ox, oy, gstart, lay, off, T};
    const kb_stage::Tables s = kb_stage::tables_at(smem);
    unsigned char* bufs = smem + header_bytes();
    const size_t bbytes = buffer_bytes(buf_elems);

    const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
    const int col0 = blockIdx.x * kTW;
    const int j = col0 + tx;
    const int i0 = blockIdx.y * kTH;
    const int ir = i0 + ty * R;  // this thread's first row
    const bool active = j < SW;

    if (active) {
        for (int r = 0; r < R && ir + r < SH; ++r) {
            for (int k = 0; k < K_out; ++k) {
                const size_t o = ((size_t)k * SH + ir + r) * SW + j;
                top_lh[o] = -FLT_MAX;
                top_idx[o] = -1;
            }
        }
    }

    for (int g = 0; g < NG; ++g) {
        const int c0 = gstart[g];
        const int n = gstart[g + 1] - c0;
        __syncthreads();  // the previous group is done with the tables and buffers
        kb_stage::load_tables<NT>(s, plan, g, 0);
        __syncthreads();

        float ap[kG][R], af[kG][R];
        int ao[kG][R / 2];  // two rows' counts as 16-bit fields (T < 65536)
#pragma unroll
        for (int m = 0; m < kG; ++m) {
#pragma unroll
            for (int r = 0; r < R; ++r) ap[m][r] = af[m][r] = 0.0f;
#pragma unroll
            for (int r = 0; r < R / 2; ++r) ao[m][r] = 0;
        }

        stage_step<NT>(P, bufs, buf_elems, s, 0, 0, i0, col0);
        for (int t = 0; t < T; ++t) {
            kb_stage::cp_async_wait_all();
            __syncthreads();  // step t has landed; every thread is done with step t - 1
            int lt = t;       // the table row of step t
            if (kLong) {
                lt = t % kb_stage::kStride;
                if (t > 0 && lt == 0) {
                    kb_stage::load_tables<NT>(s, plan, g, t);
                    __syncthreads();
                }
            }
            if (t + 1 < T) stage_step<NT>(P, bufs + ((t + 1) & 1) * bbytes, buf_elems, s, t + 1, lt + 1, i0, col0);
            const float* b_psi = reinterpret_cast<const float*>(bufs + (t & 1) * bbytes);
            const float* b_phi = b_psi + buf_elems;
            const uint8_t* b_val = reinterpret_cast<const uint8_t*>(b_phi + buf_elems);
            const int pitch = s.lay[lt * kLay + 2];
            if (P.has_masked) {
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    if (m < n) {
                        const int o = s.off[lt * kG + m] + tx + ty * R * pitch;
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const int e = o + r * pitch;
                            const bool v = b_val[e] != 0;
                            ap[m][r] = __fadd_rn(ap[m][r], v ? b_psi[e] : 0.0f);
                            af[m][r] = __fadd_rn(af[m][r], v ? b_phi[e] : 0.0f);
                            ao[m][r / 2] += (int)v << (16 * (r & 1));
                        }
                    }
                }
            } else {
                // No validity plane: every in-image sample counts; outside
                // the image the staged values are zeros.
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    if (m < n) {
                        const int o = s.off[lt * kG + m] + tx + ty * R * pitch;
                        const bool xin = (unsigned)(col0 + s.ox[m * kRows + lt] + tx) < (unsigned)P.W;
                        const int yb = ir + s.oy[m * kRows + lt];
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const int e = o + r * pitch;
                            ap[m][r] = __fadd_rn(ap[m][r], b_psi[e]);
                            af[m][r] = __fadd_rn(af[m][r], b_phi[e]);
                            ao[m][r / 2] += (int)(xin && (unsigned)(yb + r) < (unsigned)P.H) << (16 * (r & 1));
                        }
                    }
                }
            }
        }

        if (!active) continue;
        // A list of up to 64 in registers, a longer one in the maps.
        constexpr bool in_map = KB == kb_encoded::kMapList;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = ir + r;
            if (i >= SH) break;
            float top[in_map ? 1 : KB];
            int tidx[in_map ? 1 : KB];
            if constexpr (!in_map) {
#pragma unroll
                for (int k = 0; k < KB; ++k) {
                    const size_t o = ((size_t)k * SH + i) * SW + j;
                    top[k] = k < K_out ? top_lh[o] : -FLT_MAX;
                    tidx[k] = k < K_out ? top_idx[o] : -1;
                }
            }
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const int obs = (ao[m][r / 2] >> (16 * (r & 1))) & 0xFFFF;
                    const float lh = likelihood(ap[m][r], af[m][r]);
                    const float nv = gated(lh, obs, cand_ok[c0 + m] != 0, min_obs, min_lh, gate_min_obs, gate_min_lh);
                    if constexpr (in_map)
                        kb_encoded::rank_insert_map<true>(top_lh, top_idx, (size_t)i * SW + j, (size_t)SH * SW, K_out,
                                                          nv, gidx[c0 + m]);
                    else
                        rank_insert<KB, true>(top, tidx, nv, gidx[c0 + m]);
                }
            }
            if constexpr (!in_map) {
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
}

}  // namespace

extern "C" {

int kb_search_topk_max_group() { return kG; }

// The block's tile (axis 0 its rows, axis 1 its columns) and the staging
// chunk in pixels (axis 2), for the host's window layout.
int kb_search_topk_tile(int axis) { return axis == 0 ? kTH : (axis == 1 ? kTW : kCH); }

// Shared memory for staging buffers of buf_elems pixels (and the tables,
// whose size does not depend on T).
size_t kb_search_topk_smem_bytes(int buf_elems) { return header_bytes() + 2 * buffer_bytes(buf_elems); }

// Resident blocks per SM of the kernel for K_out and T <= 64 with smem
// bytes of shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1.
int kb_search_topk_blocks_per_sm(int K_out, int smem) {
    int n = -1;
#define KB_OCC(KB)                                                                                      \
    {                                                                                                   \
        auto k = search_topk_kernel<KB, false>;                                                         \
        if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess || \
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, Shape<KB>::kThreads, smem) != cudaSuccess)             \
            return -1;                                                                                  \
        return n;                                                                                       \
    }
    if (K_out <= 1) KB_OCC(1);
    if (K_out <= 2) KB_OCC(2);
    if (K_out <= 4) KB_OCC(4);
    if (K_out <= 8) KB_OCC(8);
    if (K_out <= 16) KB_OCC(16);
    if (K_out <= 32) KB_OCC(32);
    if (K_out <= 64) KB_OCC(64);
    KB_OCC(kb_encoded::kMapList);
#undef KB_OCC
    return n;
}

// psi, phi: (T, H, Wp) float32, valid: (T, H, Wp) uint8 (unread when
// has_masked == 0), Wp a multiple of 16, 16-byte aligned, columns W..Wp
// zero; ox, oy: (C, T) int32 window-origin offsets in plan order; gidx: (C,)
// global candidate indices and cand_ok (C,) uint8 in plan order; gstart:
// (NG + 1,) group bounds, 1..8 candidates a group; lay: (NG, T, 5) and off:
// (NG, T, 8) int32, the window layout (csrc/stage_window.cuh) for buffers of
// buf_elems pixels (a multiple of 16); top_lh, top_idx: (K_out, SH, SW).
// K_out >= 1 (past 64 the list stays in the maps), T < 65536. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for what it
// cannot run).
int kb_search_topk(const float* psi, const float* phi, const uint8_t* valid, const int* ox, const int* oy,
                   const int* gidx, const uint8_t* cand_ok, const int* gstart, const int* lay, const int* off,
                   int NG, int T, int H, int W, int Wp, int SH, int SW, int K_out, int buf_elems,
                   float min_obs, float min_lh, int gate_min_obs, int gate_min_lh, int has_masked,
                   float* top_lh, int* top_idx, void* stream) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(psi) | reinterpret_cast<uintptr_t>(phi) |
                            (has_masked ? reinterpret_cast<uintptr_t>(valid) : 0);
    if (Wp % kCH != 0 || buf_elems % kCH != 0 || (align & 15) != 0 || T >= 65536 || NG < 1)
        return (int)cudaErrorInvalidValue;
    const Planes P{psi, phi, valid, T, H, W, Wp, has_masked};
    const size_t smem = kb_search_topk_smem_bytes(buf_elems);
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
    cudaStream_t s = (cudaStream_t)stream;
#define KB_LAUNCH(KB)                                                                                 \
    {                                                                                                 \
        auto k = T > kb_stage::kRows ? search_topk_kernel<KB, true> : search_topk_kernel<KB, false>;  \
        cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
        if (err != cudaSuccess) return (int)err;                                                      \
        k<<<grid, Shape<KB>::kThreads, smem, s>>>(P, ox, oy, gidx, cand_ok, gstart, lay, off, NG, SH, SW, K_out, buf_elems, \
                                  min_obs, min_lh, gate_min_obs, gate_min_lh, top_lh, top_idx);       \
        return (int)cudaGetLastError();                                                               \
    }
    if (K_out <= 1) KB_LAUNCH(1);
    if (K_out <= 2) KB_LAUNCH(2);
    if (K_out <= 4) KB_LAUNCH(4);
    if (K_out <= 8) KB_LAUNCH(8);
    if (K_out <= 16) KB_LAUNCH(16);
    if (K_out <= 32) KB_LAUNCH(32);
    if (K_out <= 64) KB_LAUNCH(64);
    KB_LAUNCH(kb_encoded::kMapList);
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
