// K3 for Hopper: the top-K search over uint16 (and long uint8) codes,
// candidates in groups.
//
// Replaces the TPU kernel `_search_kernel_encoded`
// (kbmod_tpu/ops/search_pallas.py:505). It computes K2's function over
// uint8/uint16 codes (0 = masked): for every window pixel (i, j) and
// candidate c,
//
//   for t in 0..T-1:  y = oy[c,t] + i,  x = ox[c,t] + j
//     if 0 <= y < H and 0 <= x < W and psi code > 0 and phi code > 0:
//       psum += psi code;  fsum += phi code;  obs += 1      (integers)
//   psi = scale * psum + (min - scale) * obs   (and phi alike, decoded once)
//   lh  = phi > 0 ? psi / sqrt(phi) : -1      (IEEE div and sqrt)
//   rank-insert (gated lh, global index) by (lh desc, index asc)
//
// The codes come interleaved, (T, H, Wp) pairs of (psi, phi): for uint8 a
// 16-bit word (psi in the low byte), for uint16 a 32-bit word (psi in the
// low half). Wp is W rounded up to 8; columns past W hold zero pairs. It
// serves uint16 stacks, and uint8 stacks past K4's 257 steps whose grouping
// plan does not fill (K5 takes the others).
//
// What bounds it on the H100: int32 operations, not HBM. The compulsory
// traffic is one read of the codes (4 bytes a pixel and time for uint16);
// every (pixel, candidate, time) sample is a code test and three adds.
// Its first design, the first K2's per-candidate design over codes (one pixel
// a thread, each batch of 8 candidates sweeping all T planes again from L2,
// two shared offset loads, a bounds test and a 4-byte global load a sample,
// nothing overlapping the loads), took 219.9 ms against a 9.4 ms bound on
// the uint16 sigma-G band (T = 64, 256 x 2048, 1,681 candidates, K = 8;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md run J). This design joins K5's
// family (csrc/search_topk_grouped.cu):
//
// - candidates in the groups of the host plan (search_plan.grouped_plan),
//   the windows of a group's members staged in shared memory with cp.async
//   16-byte copies (csrc/stage_window.cuh), a chunk being 4 uint16 pairs or
//   8 uint8 pairs, double-buffered so the copy of step t + 1 runs while t
//   is summed, with one barrier a step; chunks outside the image arrive as
//   zero codes, so the loop has no bounds test (the code pairs' padding
//   columns are zero);
// - a block owns 8 rows x 128 columns, a thread one column of two rows
//   (one whole pair a pixel, so no funnel shift);
// - per member and row, uint32 sums of psi codes and of phi codes, and the
//   counts of a member's two rows as the 16-bit fields of one register (40
//   sum registers a thread), so two 512-thread blocks (32 warps) fit an SM
//   for K <= 8;
// - a sample is one add for its shared address, one shared load of the
//   pair, the psi mask, the phi shift, one compare of both codes and three
//   predicated adds (written in PTX, since the compiler turned the adds
//   into selects and adds): 7.5 integer instructions and a load on
//   average, read from the compiled code (PERF.md); every member is
//   summed, a partial group's spare members on the window at offset 0,
//   and never inserted;
// - two rows a thread because the step, not the sample, was the cost: with
//   one row a thread (4 x 128 tile) a thread's 8 samples between barriers
//   could not cover the step's dependent shared loads, its staging and the
//   barrier, and this kernel took 63.2 ms on the band, 4.7x the issue floor
//   of its loop; two steps a barrier helped a little, two rows a thread,
//   which also stages 30% fewer bytes an output, brought it to 50.2 ms
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md);
// - int32 sums are exact while T * 65535 < 2^31 for uint16 (T <= 32,768)
//   and the count fields while T < 65,536;
// - the group's tables sit in shared memory 64 steps at a time, so shared
//   memory does not grow with T; stacks of at most 64 steps run an
//   instantiation without the reload;
// - the top-K lives in the output map, read and written once per group; past
//   K = 64 (kMapList) each member inserts into the maps in place.

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
constexpr int kTW = 128;                 // window columns per block, one a thread
constexpr int kR = 2;                    // window rows a thread
constexpr int kTH = kR * kThreads / kTW;  // window rows per block

// One code pair from shared memory (a 32-bit shared address).
template <typename PairT>
__device__ __forceinline__ uint32_t load_pair(uint32_t addr);
template <>
__device__ __forceinline__ uint32_t load_pair<uint32_t>(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
    return v;
}
template <>
__device__ __forceinline__ uint32_t load_pair<uint16_t>(uint32_t addr) {
    unsigned short v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
    return v;
}

// Add a sample's psi code (the low BITS of w) to ap, its phi code to af and
// INC to ao where both codes are non-zero: a mask, a shift, one compare of
// both codes and three predicated adds.
template <int BITS, uint32_t INC>
__device__ __forceinline__ void add_sample(uint32_t w, uint32_t& ap, uint32_t& af, uint32_t& ao) {
    asm("{\n\t.reg .pred q;\n\t.reg .u32 p, f;\n\t"
        "and.b32 p, %3, %4;\n\t"
        "shr.u32 f, %3, %5;\n\t"
        "setp.ne.u32 q, p, 0;\n\t"
        "setp.ne.and.u32 q, f, 0, q;\n\t"
        "@q add.u32 %0, %0, p;\n\t"
        "@q add.u32 %1, %1, f;\n\t"
        "@q add.u32 %2, %2, %6;\n\t}"
        : "+r"(ap), "+r"(af), "+r"(ao)
        : "r"(w), "n"((1u << BITS) - 1u), "n"(BITS), "n"(INC));
}

// PairT: uint16_t (uint8 codes) or uint32_t (uint16 codes). Two 512-thread
// blocks an SM for K <= 8, as K5. kLong: T > 64, the tables reloaded every
// 63 steps (stage_window.cuh).
template <typename PairT, int KB, bool kLong>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 2 : 1)
    encoded_kernel(const PairT* __restrict__ pairs, const int* __restrict__ ox, const int* __restrict__ oy,
                   const int* __restrict__ gidx, const uint8_t* __restrict__ cand_ok,
                   const int* __restrict__ gstart, const int* __restrict__ lay, const int* __restrict__ off,
                   int NG, int T, int H, int Wp, int SH, int SW, int K_out, int buf_elems, Decode D,
                   float* __restrict__ top_lh, int* __restrict__ top_idx) {
    constexpr int BITS = 4 * sizeof(PairT);  // bits of one code
    constexpr int kPx = sizeof(PairT);
    static_assert(kG == 8, "a step's member offsets are two 16-byte loads");
    extern __shared__ __align__(16) unsigned char smem[];
    const kb_stage::Plan plan{ox, oy, gstart, lay, off, T};
    const kb_stage::Tables s = kb_stage::tables_at(smem);
    PairT* bufs = reinterpret_cast<PairT*>(smem + header_bytes());

    const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
    const int col0 = blockIdx.x * kTW, i0 = blockIdx.y * kTH;
    const int ir = i0 + kR * ty, j = col0 + tx;  // this thread's first row, its column
    const float psi_d = __fsub_rn(D.psi_min, D.psi_scale);
    const float phi_d = __fsub_rn(D.phi_min, D.phi_scale);

    if (j < SW) {
        for (int r = 0; r < kR && ir + r < SH; ++r) {
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
        kb_stage::load_tables<kThreads>(s, plan, g, 0);
        __syncthreads();

        // Per member and row: psi and phi code sums; a member's two rows'
        // counts as the 16-bit fields of one register. Members past n sum
        // whatever their zero offsets read and are never inserted.
        uint32_t ap[kG][kR], af[kG][kR], ao[kG];
#pragma unroll
        for (int m = 0; m < kG; ++m) {
            ao[m] = 0u;
#pragma unroll
            for (int r = 0; r < kR; ++r) ap[m][r] = af[m][r] = 0u;
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
            // The shared address of this thread's first pixel in a window
            // whose origin is at offset 0, and the members' offsets (two
            // 16-byte loads): a sample's address is one multiply-add.
            const int pitch = s.lay[lt * kLay + 2];
            const uint32_t px = static_cast<uint32_t>(
                __cvta_generic_to_shared(bufs + (t & 1) * buf_elems + kR * ty * pitch + tx));
            const uint32_t row = pitch * kPx;
            const int4 o0 = reinterpret_cast<const int4*>(s.off + lt * kG)[0];
            const int4 o1 = reinterpret_cast<const int4*>(s.off + lt * kG)[1];
            const int moff[kG] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                const uint32_t a = px + moff[m] * kPx;
                add_sample<BITS, 1u>(load_pair<PairT>(a), ap[m][0], af[m][0], ao[m]);
                add_sample<BITS, 0x10000u>(load_pair<PairT>(a + row), ap[m][1], af[m][1], ao[m]);
            }
        }

        if (j >= SW) continue;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int i = ir + r;
            if (i >= SH) break;
            // A list of up to 64 in registers, a longer one in the maps.
            constexpr bool in_map = KB == kb_encoded::kMapList;
            float top[in_map ? 1 : KB];
            int tidx[in_map ? 1 : KB];
            if constexpr (!in_map) load_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const int obs = (int)((ao[m] >> (16 * r)) & 0xFFFFu);
                    if constexpr (in_map)
                        kb_encoded::insert_member_map(top_lh, top_idx, (size_t)i * SW + j, (size_t)SH * SW, K_out,
                                                      (int)ap[m][r], (int)af[m][r], obs, cand_ok[c0 + m] != 0,
                                                      gidx[c0 + m], D, psi_d, phi_d);
                    else
                        insert_member(top, tidx, (int)ap[m][r], (int)af[m][r], obs, cand_ok[c0 + m] != 0,
                                      gidx[c0 + m], D, psi_d, phi_d);
                }
            }
            if constexpr (!in_map) store_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
        }
    }
}

}  // namespace

extern "C" {

int kb_search_encoded_max_group() { return kG; }

// K3's most time steps for codes of `bits`: int32 sums of uint16 codes
// stay exact up to 32,768 steps; the 16-bit count fields hold 65,535.
int kb_search_encoded_max_t(int bits) { return bits == 16 ? 32768 : 65535; }

// K3's tile (axis 0 its rows, axis 1 its columns) and staging chunk in
// pixels (axis 2) for codes of `bits`.
int kb_search_encoded_tile(int bits, int axis) {
    return axis == 0 ? kTH : (axis == 1 ? kTW : (bits == 16 ? 4 : 8));
}

// K3's shared memory for two staging buffers of buf_elems code pairs of
// `bits` (and the tables, whose size does not depend on T).
size_t kb_search_encoded_smem_bytes(int bits, int buf_elems) {
    return header_bytes() + 2 * (size_t)buf_elems * (bits == 16 ? 4 : 2);
}

// Resident blocks per SM of K3 for codes of `bits`, K_out and smem bytes of
// shared memory, or -1.
int kb_search_encoded_blocks_per_sm(int bits, int K_out, int smem) {
#define KB_OCC(KB)                                                                   \
    return bits == 16 ? occupancy<kThreads>(encoded_kernel<uint32_t, KB, false>, smem) \
                      : occupancy<kThreads>(encoded_kernel<uint16_t, KB, false>, smem)
    KB_DISPATCH(K_out, KB_OCC)
#undef KB_OCC
    return -1;
}

// K3. bits = 8 (uint8 codes, 16-bit pairs) or 16 (uint16 codes, 32-bit
// pairs); pairs (T, H, Wp), Wp a multiple of 8, 16-byte aligned, the
// columns W..Wp zero; the other arguments as K5's kb_search_grouped
// (csrc/search_topk_grouped.cu), the layout's chunk being 16 bytes of pairs
// and its extra column 0. T <= kb_search_encoded_max_t(bits). Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for what it cannot run).
int kb_search_encoded(int bits, const void* pairs, const int* ox, const int* oy, const int* gidx,
                      const uint8_t* cand_ok, const int* gstart, const int* lay, const int* off, int NG, int T,
                      int H, int Wp, int SH, int SW, int K_out, int buf_elems, float psi_min, float psi_scale,
                      float phi_min, float phi_scale, float min_obs, float min_lh, int gate_min_obs,
                      int gate_min_lh, float* top_lh, int* top_idx, void* stream) {
    if ((bits != 8 && bits != 16) || Wp % 8 != 0 || buf_elems % kb_search_encoded_tile(bits, 2) != 0 ||
        (reinterpret_cast<uintptr_t>(pairs) & 15) != 0 || T < 1 || T > kb_search_encoded_max_t(bits) || NG < 1)
        return (int)cudaErrorInvalidValue;
    const Decode D{psi_min, psi_scale, phi_min, phi_scale, min_obs, min_lh, gate_min_obs, gate_min_lh};
    const size_t smem = kb_search_encoded_smem_bytes(bits, buf_elems);
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
    cudaStream_t s = (cudaStream_t)stream;
    const bool lng = T > kb_stage::kRows;
#define KB_LAUNCH(KB)                                                                                      \
    return bits == 16                                                                                      \
               ? launch<kThreads>(lng ? encoded_kernel<uint32_t, KB, true> : encoded_kernel<uint32_t, KB, false>, \
                                  grid, smem, s, (const uint32_t*)pairs, ox, oy, gidx, cand_ok, gstart, lay, off, \
                                  NG, T, H, Wp, SH, SW, K_out, buf_elems, D, top_lh, top_idx)                  \
               : launch<kThreads>(lng ? encoded_kernel<uint16_t, KB, true> : encoded_kernel<uint16_t, KB, false>, \
                                  grid, smem, s, (const uint16_t*)pairs, ox, oy, gidx, cand_ok, gstart, lay, off, \
                                  NG, T, H, Wp, SH, SW, K_out, buf_elems, D, top_lh, top_idx)
    KB_DISPATCH(K_out, KB_LAUNCH)
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
