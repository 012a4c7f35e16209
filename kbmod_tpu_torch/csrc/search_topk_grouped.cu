// K5 for Hopper: the uint8 top-K search over candidate groups.
//
// Replaces the TPU kernel `_search_kernel_paired_grouped`
// (kbmod_tpu/ops/search_pallas.py:1493). It computes K3's function
// (csrc/search_topk_encoded_grouped.cu) for uint8 codes, with the
// candidates in groups of at most kG whose per-time rows lie within a few
// pixels of each other (the plan of kbmod_tpu_torch/ops/search_plan.py, in
// plan order): for each group and time step the windows of every member are
// staged once in shared memory and every thread adds its pixels' codes for
// all members from there; then each member's sums are decoded once and
// rank-inserted into the pixel's top-K by (lh desc, global index asc), so
// the plan's order does not change the result.
//
// What bounds it on the H100: int32 operations, not HBM. The compulsory
// traffic is one read of the codes (2 bytes a pixel and time); every
// (pixel, candidate, time) sample is a code test and three adds, or 1.5
// adds when two columns share a 32-bit add. The first design (one column a
// thread, three int32 adds a sample, 143 registers so one 256-thread block
// an SM, two barriers a step and synchronous staging through registers) ran
// 33x its bound and drew 230 W on an NVIDIA H100 80GB HBM3 with a 700 W
// power limit (PERF.md): latency-bound. This design:
//
// - sums as K4 and the TPU kernel do: a thread owns two columns, which are
//   one 32-bit word of the code-pair layout (psi0, phi0, psi1, phi1), and
//   splits it with 0x00FF00FF masks into a psi and a phi word of two 16-bit
//   fields; a sample counts where BOTH codes are non-zero, a per-field
//   indicator that also masks the codes; so one word is about a dozen
//   integer operations for two pixels, the 16-bit fields holding up to 257
//   steps of codes (longer stacks flush them into 32-bit sums in shared
//   memory every 257 steps, as the TPU kernel's FLUSH does);
// - an odd column shift reads two adjacent words and joins them with a
//   funnel shift;
// - 24 sum registers a thread (8 members x 3 words, one row), so two
//   512-thread blocks (32 warps) fit an SM for K <= 8;
// - the windows are staged with cp.async 16-byte copies (csrc/
//   stage_window.cuh), double-buffered so the copy for t + 1 runs while t
//   is summed, with one barrier a step; chunks outside the image arrive as
//   zero codes, so the loop has no bounds test (the code pairs' padding
//   columns are zero);
// - the group's tables sit in shared memory 64 steps at a time, so shared
//   memory does not grow with T: holding all T steps (116 bytes a step)
//   refused T >= 1,500 at the 41 x 41 grid's layout. Stacks of at most 64
//   steps run an instantiation without the reload;
// - the top-K lives in the output map, read and written once per group; past
//   K = 64 (kMapList) each member inserts into the maps in place.
//
// Mode C of the micro-benchmark K6 (csrc/exactrow_microbench.cu) is its
// inner loop.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "encoded_common.cuh"
#include "stage_window.cuh"

namespace {

using kb_encoded::Decode;
using kb_encoded::insert_member;
using kb_encoded::launch;
using kb_encoded::load_top;
using kb_encoded::occupancy;
using kb_encoded::store_top;
using kb_stage::header_bytes;
using kb_stage::kG;
using kb_stage::kLay;

constexpr int kThreads = 512;

constexpr int kWX = 128;  // word columns per block: 256 pixel columns
constexpr int kTY = kThreads / kWX;  // thread rows
constexpr int kR = 1;     // window rows per thread
constexpr int kTH = kTY * kR;  // window rows per block
constexpr int kTW = 2 * kWX;   // window columns per block
constexpr int kCH = 8;    // staging chunk: 8 code pairs, 16 bytes
constexpr int kFlush = 257;  // steps a 16-bit field holds: 257 * 255 <= 65535
constexpr uint32_t kPair = 0x00FF00FFu;
constexpr uint32_t kField = 0x00010001u;

// 32-bit sums of the fields, for stacks longer than kFlush steps: per
// thread kG x kR x (psi, phi) x 2 columns.
constexpr int kWide = kG * kR * 4;
__host__ __device__ inline size_t wide_bytes(int T) {
    return T > kFlush ? (size_t)kWide * kThreads * sizeof(int) : 0;
}

// Two 512-thread blocks an SM cap a thread at 64 registers, which the sums
// and a top-K list of up to 8 fit; longer lists run one block an SM. kLong:
// T > 64, the tables reloaded every 63 steps (stage_window.cuh).
template <int KB, bool kLong>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 2 : 1)
    grouped_kernel(const uint16_t* __restrict__ pairs, const int* __restrict__ ox,
                   const int* __restrict__ oy, const int* __restrict__ gidx,
                   const uint8_t* __restrict__ cand_ok, const int* __restrict__ gstart,
                   const int* __restrict__ lay, const int* __restrict__ off, int NG, int T, int H, int Wp,
                   int SH, int SW, int K_out, int buf_elems, Decode D, float* __restrict__ top_lh,
                   int* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    const kb_stage::Plan plan{ox, oy, gstart, lay, off, T};
    const kb_stage::Tables s = kb_stage::tables_at(smem);
    uint16_t* bufs = reinterpret_cast<uint16_t*>(smem + header_bytes());
    int* s_wide = reinterpret_cast<int*>(smem + header_bytes() + 2 * (size_t)buf_elems * sizeof(uint16_t));
    const bool wide = T > kFlush;

    const int tx = threadIdx.x % kWX, ty = threadIdx.x / kWX;
    const int col0 = blockIdx.x * kTW;
    const int i0 = blockIdx.y * kTH;
    const int ir = i0 + ty * kR;      // this thread's first row
    const int jc = col0 + 2 * tx;     // this thread's first column
    const float psi_d = __fsub_rn(D.psi_min, D.psi_scale);
    const float phi_d = __fsub_rn(D.phi_min, D.phi_scale);

    for (int r = 0; r < kR; ++r) {
        for (int p = 0; p < 2; ++p) {
            if (ir + r >= SH || jc + p >= SW) continue;
            for (int k = 0; k < K_out; ++k) {
                const size_t o = ((size_t)k * SH + ir + r) * SW + jc + p;
                top_lh[o] = -FLT_MAX;
                top_idx[o] = -1;
            }
        }
    }

    for (int g = 0; g < NG; ++g) {
        const int c0 = gstart[g];
        const int n = gstart[g + 1] - c0;
        __syncthreads();  // the previous group is done with the tables and buffers
        kb_stage::load_tables<kThreads>(s, plan, g, 0);
        if (wide) {
            for (int q = 0; q < kWide; ++q) s_wide[q * kThreads + threadIdx.x] = 0;
        }
        __syncthreads();

        // Per member and row: psi and phi codes as two 16-bit fields (one
        // per column), and the two columns' sample counts.
        uint32_t ap[kG][kR], af[kG][kR], ao[kG][kR];
#pragma unroll
        for (int m = 0; m < kG; ++m) {
#pragma unroll
            for (int r = 0; r < kR; ++r) ap[m][r] = af[m][r] = ao[m][r] = 0u;
        }

        kb_stage::stage_plane<kThreads>(pairs, H, Wp, bufs, s, 0, 0, i0, col0);
        for (int t = 0; t < T; ++t) {
            kb_stage::cp_async_wait_all();
            __syncthreads();  // step t has landed; every thread is done with step t - 1
            int lt = t;       // the table row of step t
            if (kLong) {
                lt = t % kb_stage::kStride;
                if (t > 0 && lt == 0) {
                    kb_stage::load_tables<kThreads>(s, plan, g, t);
                    __syncthreads();
                }
            }
            if (t + 1 < T)
                kb_stage::stage_plane<kThreads>(pairs, H, Wp, bufs + ((t + 1) & 1) * buf_elems, s, t + 1, lt + 1, i0,
                                                col0);
            const uint32_t* w32 = reinterpret_cast<const uint32_t*>(bufs + (t & 1) * buf_elems);
            const int pitch = s.lay[lt * kLay + 2];
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const int o = s.off[lt * kG + m] + 2 * tx + ty * kR * pitch;
                    const bool odd = o & 1;
#pragma unroll
                    for (int r = 0; r < kR; ++r) {
                        const int e = o + r * pitch;
                        uint32_t w;
                        if (odd) {
                            w = __funnelshift_r(w32[(e - 1) >> 1], w32[(e + 1) >> 1], 16);
                        } else {
                            w = w32[e >> 1];
                        }
                        const uint32_t pv = w & kPair, fv = (w >> 8) & kPair;
                        const uint32_t ind = ((pv + kPair) >> 8) & ((fv + kPair) >> 8) & kField;
                        const uint32_t keep = ind * 0xFFu;
                        ap[m][r] += pv & keep;
                        af[m][r] += fv & keep;
                        ao[m][r] += ind;
                    }
                }
            }
            if (wide && (t % kFlush == kFlush - 1 || t == T - 1)) {
#pragma unroll
                for (int m = 0; m < kG; ++m) {
#pragma unroll
                    for (int r = 0; r < kR; ++r) {
                        int* wq = s_wide + ((m * kR + r) * 4) * kThreads + threadIdx.x;
                        wq[0] += ap[m][r] & 0xFFFFu;
                        wq[kThreads] += ap[m][r] >> 16;
                        wq[2 * kThreads] += af[m][r] & 0xFFFFu;
                        wq[3 * kThreads] += af[m][r] >> 16;
                        ap[m][r] = af[m][r] = 0u;
                    }
                }
            }
        }

#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int i = ir + r;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                const int j = jc + p;
                if (i >= SH || j >= SW) continue;
                // A list of up to 64 in registers, a longer one in the maps.
                constexpr bool in_map = KB == kb_encoded::kMapList;
                float top[in_map ? 1 : KB];
                int tidx[in_map ? 1 : KB];
                if constexpr (!in_map) load_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    if (m < n) {
                        const int obs = (int)((ao[m][r] >> (16 * p)) & 0xFFFFu);
                        int ps, fs;
                        if (wide) {
                            const int* wq = s_wide + ((m * kR + r) * 4) * kThreads + threadIdx.x;
                            ps = wq[p * kThreads];
                            fs = wq[(2 + p) * kThreads];
                        } else {
                            ps = (int)((ap[m][r] >> (16 * p)) & 0xFFFFu);
                            fs = (int)((af[m][r] >> (16 * p)) & 0xFFFFu);
                        }
                        if constexpr (in_map)
                            kb_encoded::insert_member_map(top_lh, top_idx, (size_t)i * SW + j, (size_t)SH * SW, K_out,
                                                          ps, fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m], D, psi_d,
                                                          phi_d);
                        else
                            insert_member(top, tidx, ps, fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m], D, psi_d, phi_d);
                    }
                }
                if constexpr (!in_map) store_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
            }
        }
    }
}

}  // namespace

extern "C" {

int kb_search_grouped_max_group() { return kG; }

// The block's tile (axis 0 its rows, axis 1 its columns) and the staging
// chunk in pixels (axis 2), for the host's window layout.
int kb_search_grouped_tile(int axis) { return axis == 0 ? kTH : (axis == 1 ? kTW : kCH); }

// Shared memory for staging buffers of buf_elems code pairs (plus the 32-bit
// field sums past 257 steps).
size_t kb_search_grouped_smem_bytes(int T, int buf_elems) {
    return header_bytes() + 2 * (size_t)buf_elems * sizeof(uint16_t) + wide_bytes(T);
}

// Resident blocks per SM of the kernel for K_out with smem bytes of shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
int kb_search_grouped_blocks_per_sm(int K_out, int smem) {
#define KB_OCC(KB) return occupancy<kThreads>(grouped_kernel<KB, false>, smem)
    KB_DISPATCH(K_out, KB_OCC)
#undef KB_OCC
    return -1;
}

// pairs: (T, H, Wp) uint8 code pairs as 16-bit words, Wp a multiple of 8,
// 16-byte aligned, the columns W..Wp zero; ox, oy: (C, T) int32
// window-origin offsets in plan order; gidx: (C,) global candidate indices
// and cand_ok (C,) uint8, in plan order; gstart: (NG + 1,) group bounds
// within the plan, each group 1..8 candidates; lay: (NG, T, 5) and off:
// (NG, T, 8) int32, the window layout (csrc/stage_window.cuh) for buffers of
// buf_elems pairs (a multiple of 8), with one extra column on each window's
// right; top_lh, top_idx: (K_out, SH, SW). K_out >= 1 (past 64 the list stays
// in the maps), T < 65536. Launches
// on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for what it
// cannot run).
int kb_search_grouped(const void* pairs, const int* ox, const int* oy, const int* gidx,
                      const uint8_t* cand_ok, const int* gstart, const int* lay, const int* off, int NG, int T,
                      int H, int Wp, int SH, int SW, int K_out, int buf_elems, float psi_min, float psi_scale,
                      float phi_min, float phi_scale, float min_obs, float min_lh, int gate_min_obs,
                      int gate_min_lh, float* top_lh, int* top_idx, void* stream) {
    if (Wp % kCH != 0 || buf_elems % kCH != 0 || (reinterpret_cast<uintptr_t>(pairs) & 15) != 0 ||
        T >= 65536 || NG < 1)
        return (int)cudaErrorInvalidValue;
    const Decode D{psi_min, psi_scale, phi_min, phi_scale, min_obs, min_lh, gate_min_obs, gate_min_lh};
    const size_t smem = kb_search_grouped_smem_bytes(T, buf_elems);
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
#define KB_LAUNCH(KB)                                                                                   \
    return launch<kThreads>(T > kb_stage::kRows ? grouped_kernel<KB, true> : grouped_kernel<KB, false>, grid, smem, \
                  (cudaStream_t)stream, (const uint16_t*)pairs, ox, oy, gidx, cand_ok, gstart, lay, off, NG, T, H, \
                  Wp, SH, SW, K_out, buf_elems, D, top_lh, top_idx)
    KB_DISPATCH(K_out, KB_LAUNCH)
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
