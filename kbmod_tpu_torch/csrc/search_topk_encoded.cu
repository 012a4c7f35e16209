// K4 for Hopper: the uint8 top-K search over candidates that do not group,
// two columns a 32-bit add.
//
// Replaces the TPU kernel `_search_kernel_paired` (K4,
// kbmod_tpu/ops/search_pallas.py:916). It computes K2's function over
// uint8 codes (0 = masked): for every window pixel (i, j) and candidate c,
// in candidate index order,
//
//   for t in 0..T-1:  y = oy[c,t] + i,  x = ox[c,t] + j
//     if 0 <= y < H and 0 <= x < W and psi code > 0 and phi code > 0:
//       psum += psi code;  fsum += phi code;  obs += 1      (integers)
//   psi = scale * psum + (min - scale) * obs   (and phi alike, decoded once)
//   lh  = phi > 0 ? psi / sqrt(phi) : -1      (IEEE div and sqrt)
//   rank-insert (gated lh, cand_offset + c) at p = #(top >= new)
//
// The codes come interleaved, (T, H, Wp) pairs of (psi, phi), a 16-bit
// word each (psi in the low byte). Wp is W rounded up to 8; columns past W
// hold zero pairs. T <= 257: one thread sums two adjacent columns as the two
// 16-bit fields of one 32-bit register, as the TPU kernel does
// (search_pallas.py:952-956), exact while T * 255 <= 65535.
//
// The dispatcher sends a search here when its candidates do NOT group:
// uint8 codes whose grouping plan does not fill (K5 takes the others).
// What bounds it on the H100: int32 operations by the card's rates (1.5
// adds a sample), but with no two members sharing a window every (pixel,
// candidate, time) sample is also 2 bytes moved from L2 to the SM. The first
// design (a block one row of 256 columns, a synchronous global load a
// sample whose address hung on two shared loads, a row and a column bounds
// test a sample, two 2-byte loads and a join for every odd shift, nothing in
// flight while a step summed) took 4.956 ms against a 0.188 ms bound on the
// main path's sparse uint8 band (T = 64, 256 x 2048, 66 candidates, K = 8;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md). This design takes what K5 and K3
// learned (csrc/search_topk_grouped.cu, search_topk_encoded_grouped.cu):
//
// - the candidates in index order, in batches of 8 (no plan): batch b holds
//   candidates 8b .. 8b + 7, so every insert sees them in index order and
//   rank_insert<KB, false> keeps the twin's tie order;
// - a block owns 4 rows x 256 columns, a thread one word (two columns) of
//   two rows, as K3 found best; for each (batch, t) the block stages every
//   member's window with cp.async 16-byte copies (csrc/stage_window.cuh; the
//   host's layout, k4_staging in ops/search_encoded_kernel.py, gives one
//   slab per member, or one box where the windows overlap enough),
//   double-buffered so the copy of t + 1 runs while t is summed, one barrier
//   a step; chunks outside the image arrive as zero codes, so the loop has
//   no bounds test;
// - an odd column shift joins two adjacent words with a funnel shift, as K5;
// - 48 sum registers a thread (8 members x 2 rows x psi, phi, counts):
//   three 256-thread blocks (24 warps) an SM for K <= 8;
// - the group's tables sit in shared memory 64 steps at a time
//   (stage_window.cuh), reloaded every 63 steps past T = 64;
// - the top-K lives in the output map, read and written once a batch. A
//   version that kept each thread's four lists in registers for the block's
//   life ran 36% slower at K = 8 and 14% at K = 32: the lists take the
//   registers that buy blocks an SM.
//   Past K = 64 (kMapList) each member inserts into the maps in place.
//
// What the card showed (PERF.md): on the main path's sparse band the
// time hardly moves with the shape around the loop: one row a thread in
// 512-thread blocks, four blocks an SM, two batches a sweep over the steps
// (to reuse each plane in L2) and three steps of copies in flight all came
// within 15% of this design, none faster. Every sample still costs 2 staged
// bytes, with no reuse to win.

#include <cuda_runtime.h>
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

constexpr int kThreads = 256;
constexpr int kWX = 128;              // word columns per block: 256 pixel columns
constexpr int kR = 2;                 // window rows a thread
constexpr int kTH = kR * kThreads / kWX;  // window rows per block
constexpr int kTW = 2 * kWX;          // window columns per block
constexpr int kCH = 8;                // staging chunk: 8 code pairs, 16 bytes
constexpr int kMaxT = 257;            // steps a 16-bit field holds: 257 * 255 <= 65535
constexpr uint32_t kPair = 0x00FF00FFu;
constexpr uint32_t kField = 0x00010001u;

// kLong: T > 64, the tables reloaded every 63 steps (stage_window.cuh).
// Three 256-thread blocks an SM allow 85 registers a thread, which the sums
// (48) and a list of up to 8 fit; longer lists run fewer blocks an SM.
template <int KB, bool kLong>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 3 : (KB <= 32 ? 2 : 1))
    paired_kernel(const uint16_t* __restrict__ pairs, const int* __restrict__ ox, const int* __restrict__ oy,
                  const int* __restrict__ gidx, const uint8_t* __restrict__ cand_ok,
                  const int* __restrict__ gstart, const int* __restrict__ lay, const int* __restrict__ off, int NB,
                  int T, int H, int Wp, int SH, int SW, int K_out, int buf_elems, Decode D,
                  float* __restrict__ top_lh, int* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    const kb_stage::Plan plan{ox, oy, gstart, lay, off, T};
    const kb_stage::Tables s = kb_stage::tables_at(smem);
    uint16_t* bufs = reinterpret_cast<uint16_t*>(smem + header_bytes());

    const int tx = threadIdx.x % kWX, ty = threadIdx.x / kWX;
    const int col0 = blockIdx.x * kTW, i0 = blockIdx.y * kTH;
    const int ir = i0 + kR * ty;  // this thread's first row
    const int jc = col0 + 2 * tx;  // this thread's first column
    const float psi_d = __fsub_rn(D.psi_min, D.psi_scale);
    const float phi_d = __fsub_rn(D.phi_min, D.phi_scale);

    for (int r = 0; r < kR; ++r)
        for (int p = 0; p < 2; ++p) {
            if (ir + r >= SH || jc + p >= SW) continue;
            for (int k = 0; k < K_out; ++k) {
                const size_t o = ((size_t)k * SH + ir + r) * SW + jc + p;
                top_lh[o] = -FLT_MAX;
                top_idx[o] = -1;
            }
        }

    for (int b = 0; b < NB; ++b) {
        const int c0 = gstart[b];
        const int n = gstart[b + 1] - c0;
        __syncthreads();  // the previous batch is done with the tables and buffers
        kb_stage::load_tables<kThreads>(s, plan, b, 0);
        __syncthreads();

        // Per member and row: psi and phi codes as two 16-bit fields (one
        // per column), and the two columns' sample counts.
        uint32_t ap[kG][kR], af[kG][kR], ao[kG][kR];
#pragma unroll
        for (int m = 0; m < kG; ++m)
#pragma unroll
            for (int r = 0; r < kR; ++r) ap[m][r] = af[m][r] = ao[m][r] = 0u;

        kb_stage::stage_plane<kThreads>(pairs, H, Wp, bufs, s, 0, 0, i0, col0);
        for (int t = 0; t < T; ++t) {
            kb_stage::cp_async_wait_all();
            __syncthreads();  // step t has landed; every thread is done with step t - 1
            int lt = t;       // the table row of step t
            if (kLong) {
                lt = t % kb_stage::kStride;
                if (t > 0 && lt == 0) {
                    kb_stage::load_tables<kThreads>(s, plan, b, t);
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
                    const int o = s.off[lt * kG + m] + 2 * tx + kR * ty * pitch;
                    const bool odd = o & 1;  // the same for the whole block
#pragma unroll
                    for (int r = 0; r < kR; ++r) {
                        const int e = o + r * pitch;
                        const uint32_t w =
                            odd ? __funnelshift_r(w32[(e - 1) >> 1], w32[(e + 1) >> 1], 16) : w32[e >> 1];
                        const uint32_t pv = w & kPair, fv = (w >> 8) & kPair;
                        const uint32_t ind = ((pv + kPair) >> 8) & ((fv + kPair) >> 8) & kField;
                        const uint32_t keep = ind * 0xFFu;
                        ap[m][r] += pv & keep;
                        af[m][r] += fv & keep;
                        ao[m][r] += ind;
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
                const int sh = 16 * p;
                // A list of up to 64 in registers, a longer one in the maps.
                constexpr bool in_map = KB == kb_encoded::kMapList;
                float top[in_map ? 1 : KB];
                int tidx[in_map ? 1 : KB];
                if constexpr (!in_map) load_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    if (m < n) {
                        const int ps = (int)((ap[m][r] >> sh) & 0xFFFFu), fs = (int)((af[m][r] >> sh) & 0xFFFFu);
                        const int obs = (int)((ao[m][r] >> sh) & 0xFFFFu);
                        if constexpr (in_map)
                            kb_encoded::insert_member_map<false>(top_lh, top_idx, (size_t)i * SW + j, (size_t)SH * SW,
                                                                 K_out, ps, fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m],
                                                                 D, psi_d, phi_d);
                        else
                            insert_member<KB, false>(top, tidx, ps, fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m], D,
                                                     psi_d, phi_d);
                    }
                }
                if constexpr (!in_map) store_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
            }
        }
    }
}

}  // namespace

extern "C" {

int kb_search_paired_max_group() { return kG; }

// K4's most time steps: the 16-bit fields hold 257 steps of uint8 codes.
int kb_search_paired_max_t() { return kMaxT; }

// The block's tile (axis 0 its rows, axis 1 its columns) and the staging
// chunk in code pairs (axis 2), for the host's window layout.
int kb_search_paired_tile(int axis) { return axis == 0 ? kTH : (axis == 1 ? kTW : kCH); }

// Shared memory for two staging buffers of buf_elems code pairs (and the
// tables, whose size does not depend on T).
size_t kb_search_paired_smem_bytes(int buf_elems) {
    return header_bytes() + 2 * (size_t)buf_elems * sizeof(uint16_t);
}

// Resident blocks per SM of K4 for K_out with smem bytes of shared memory,
// or -1.
int kb_search_paired_blocks_per_sm(int K_out, int smem) {
#define KB_OCC(KB) return occupancy<kThreads>(paired_kernel<KB, false>, smem)
    KB_DISPATCH(K_out, KB_OCC)
#undef KB_OCC
    return -1;
}

// K4. pairs: (T, H, Wp) uint8 code pairs as 16-bit words, Wp a multiple of 8,
// 16-byte aligned, the columns W..Wp zero; ox, oy: (C, T) int32
// window-origin offsets in index order; gidx (C,) the global indices
// (cand_offset + c) and cand_ok (C,) uint8; gstart (NB + 1,) the batch
// bounds 0, 8, 16, ..., C; lay (NB, T, 5) and off (NB, T, 8) int32, the
// window layout (csrc/stage_window.cuh) for buffers of buf_elems pairs (a
// multiple of 8) with one extra column on each window's right; top_lh,
// top_idx: (K_out, SH, SW). K_out >= 1 (past 64 the list stays in the
// maps), T <= 257. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for what it cannot run).
int kb_search_paired(const void* pairs, const int* ox, const int* oy, const int* gidx,
                     const uint8_t* cand_ok, const int* gstart, const int* lay, const int* off, int NB, int T, int H,
                     int Wp, int SH, int SW, int K_out, int buf_elems, float psi_min, float psi_scale, float phi_min,
                     float phi_scale, float min_obs, float min_lh, int gate_min_obs, int gate_min_lh, float* top_lh,
                     int* top_idx, void* stream) {
    if (Wp % kCH != 0 || buf_elems % kCH != 0 || (reinterpret_cast<uintptr_t>(pairs) & 15) != 0 || T < 1 ||
        T > kMaxT || NB < 1)
        return (int)cudaErrorInvalidValue;
    const Decode D{psi_min, psi_scale, phi_min, phi_scale, min_obs, min_lh, gate_min_obs, gate_min_lh};
    const size_t smem = kb_search_paired_smem_bytes(buf_elems);
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
    cudaStream_t s = (cudaStream_t)stream;
    const bool lng = T > kb_stage::kRows;
#define KB_LAUNCH(KB)                                                                                         \
    return launch<kThreads>(lng ? paired_kernel<KB, true> : paired_kernel<KB, false>, grid, smem, s,          \
                            (const uint16_t*)pairs, ox, oy, gidx, cand_ok, gstart, lay, off, NB, T, H, Wp, SH, SW, \
                            K_out, buf_elems, D, top_lh, top_idx)
    KB_DISPATCH(K_out, KB_LAUNCH)
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
