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
// What bounds it on the H100: latency and issue, not HBM. The compulsory
// traffic is one read of the codes (2 bytes a pixel and time); every
// (pixel, candidate, time) sample is a code test and three adds. The
// earlier design extracted each member's word on its own: reload its
// offset, read one or two staged words (a funnel shift for an odd column),
// split them into psi and phi fields with 0x00FF00FF masks, derive the
// both-non-zero indicator and its mask, three adds: about 16 integer
// operations and 1.5-2 shared loads a member-word (two pixels), about 9 of
// them the same for every member that reads the word. At the survey band's
// layout each staged pixel is read by 6.7 members. This design extracts a
// staged word once a step for the whole group:
//
// - a thread owns one row and the two columns tx and tx + 128 of a 4 x 256
//   tile, so that its two pixels are two words that 32 lanes read from 32
//   consecutive banks whatever the member's column parity;
// - prepare: once step t + 1's window has landed, the block turns it into
//   one 32-bit word a pixel, the psi code masked by the both-non-zero
//   indicator in bits 0-12, the indicator in bits 13-18, the masked phi
//   code in bits 19-31 (19 instructions, a shared load and an 8-byte store
//   a staged pair);
// - a member then adds two words, one a pixel, into two short sums: an
//   address, two conflict-free shared loads and two adds a member-word.
//   The fields hold 32 steps (32 * 255 < 2^13, 32 < 2^6); every 32 steps
//   the short sums move into the long sums, psi, phi and counts as 16-bit
//   fields of the two pixels, which hold 257 steps of codes: psi in
//   registers, phi and the counts in shared memory, so that the 16 short
//   and 8 long sums fit 64 registers without spilling (spills cost 7%
//   at the band). Longer stacks flush psi and phi into 32-bit sums in
//   shared memory every 256 steps, as the TPU kernel's FLUSH does;
// - cost a warp member-word, in instructions: prepared, 5.3 (the two
//   loads, two adds, the address, the short sums' move over 32 steps) plus
//   the prepare, 21 a staged pair, over the reuse r; per member, about 20
//   (two 16-bit loads joined by one byte permute, no funnel shift, the
//   extract, psi into the long sums, phi and the indicator into the short
//   ones) plus a copy of the window, 1 a staged pair, over r. The two meet
//   at r = 1.3-1.6: a step is prepared when it stages one box that its n
//   members read at least kShareHalves / 2 = 1.5 times over (2 * n * 4 *
//   256 pixels read against 3 * rows * pitch staged), a rule of its layout
//   row that the host applies too (search_plan.share_summary sizes the
//   buffers and counts the steps). One slab a member (r < 1) or a box that
//   a lone member or a scattered group reads keeps the per-member extract;
// - staging: cp.async 16-byte copies of step t + 2, chunk q of the window
//   thread q's, run while step t is summed and step t + 1 prepared, with
//   one barrier a step: two raw buffers and two prepared ones (a shared
//   step's words, or a per-member step's window copied as it is). The last
//   warps prepare while the first issue the copies. Chunks outside the
//   image arrive as zero codes, so the loop has no bounds test;
// - what it measured at the band's shapes (PERF.md): the loop's skeleton
//   (barriers, flushes, tables, the top-K) about 17% of the time, the
//   members' adds 29%, the copies 23%, the prepare 11%. Fewer
//   instructions there moved little: three steps of copies in flight,
//   two-row or one-row blocks, and one block an SM (33% slower) did not
//   pay; the time follows the warps resident and the spills;
// - two 512-thread blocks (32 warps) an SM for K <= 8;
// - the group's tables sit in shared memory 64 steps at a time, so shared
//   memory does not grow with T; since a step reads the tables of t, t + 1
//   and t + 2, a stack longer than 64 steps reloads them every kStride5 =
//   62 steps;
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

constexpr int kWX = 128;  // threads across a row; a thread owns columns tx and tx + kWX
constexpr int kTH = kThreads / kWX;  // window rows per block, one a thread
constexpr int kTW = 2 * kWX;         // window columns per block
constexpr int kCH = 8;    // staging chunk: 8 code pairs, 16 bytes
constexpr int kFlush = 257;  // steps a 16-bit field holds: 257 * 255 <= 65535
constexpr int kWideEvery = 256;  // steps between flushes into 32-bit sums past kFlush steps
constexpr int kShort = 32;       // steps a prepared word's fields hold
constexpr int kShareHalves = 3;  // reads a staged pixel, in halves, from which a step is prepared
constexpr int kStride5 = kb_stage::kRows - 2;  // steps between table reloads
constexpr uint32_t kPair = 0x00FF00FFu;
constexpr uint32_t kField = 0x00010001u;
// A prepared word: psi in bits 0-12, the indicator in 13-18, phi in 19-31.
constexpr int kIndAt = 13, kPhiAt = 19;
constexpr uint32_t kPsiMask = 0x1FFFu, kIndMask = 0x3Fu;

static_assert(kShort * 255 < (1 << kIndAt) && kShort < (1 << (kPhiAt - kIndAt)) && kShort * 255 < (1 << (32 - kPhiAt)),
              "a prepared word's fields hold kShort steps");
static_assert(kWideEvery % kShort == 0 && kWideEvery * 255 <= 0xFFFF, "short sums move into 16-bit fields");

// Long sums in shared memory: per thread kG x (phi, counts), two 16-bit
// fields each.
constexpr int kLong2 = 2 * kG;
// 32-bit sums of the fields, for stacks longer than kFlush steps: per
// thread kG x (psi, phi) x 2 columns.
constexpr int kWide = kG * 4;
__host__ __device__ inline size_t wide_bytes(int T) {
    return T > kFlush ? (size_t)kWide * kThreads * sizeof(int) : 0;
}

// Whether the step of layout row `lay` is prepared for a group of n
// members: one box whose pixels its members read kShareHalves / 2 times
// over, and whose prepared words fit a buffer of ext_elems 16-bit elements.
__device__ __forceinline__ bool shares(const int* lay, int n, int ext_elems) {
    const int elems = lay[1] * lay[2];
    return lay[0] == 1 && kShareHalves * elems <= 2 * n * kTH * kTW && 2 * elems <= ext_elems;
}

// Issue the copies of step t's window (table row lt) into buf, in 16-byte
// chunks: chunk q of the window's nslab * rows * pitch / kCH is thread q's
// (and q + kThreads's, ...). The same chunks as kb_stage::stage_plane,
// which gives a warp a staged row; spread over threads they issue 4% faster.
__device__ __forceinline__ void stage_window(const uint16_t* pairs, int H, int Wp, uint16_t* buf,
                                             const kb_stage::Tables& s, int t, int lt, int i0, int col0) {
    const int* lay = s.lay + lt * kLay;
    const int pitch = lay[2], per_row = pitch / kCH;
    const int nchunks = lay[0] * lay[1] * per_row;
    for (int q = threadIdx.x; q < nchunks; q += kThreads) {
        const int sr = q / per_row, c = q - sr * per_row;
        int y, x;
        kb_stage::slab_row_origin(s, lt, sr, i0, col0, kCH, y, x);
        const int xs = x + kCH * c;
        const bool ok = (unsigned)y < (unsigned)H && xs >= 0 && xs < Wp;
        const size_t row = ((size_t)t * H + (ok ? y : 0)) * Wp;
        kb_stage::cp_async16(buf + sr * pitch + kCH * c, pairs + (ok ? row + xs : 0), ok);
    }
    kb_stage::cp_async_commit();
}

// Turn one step's staged window (elems code pairs at raw) into its prepared
// form at ext: a 32-bit word a pixel when `shared`, else the pairs as they
// are. The last warps take the first words: the first ones issue the copies.
__device__ __forceinline__ void prepare(const uint16_t* raw, uint16_t* ext, int elems, bool shared) {
    const int lane = kThreads - 1 - (int)threadIdx.x;
    if (shared) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(raw);
        uint2* dst = reinterpret_cast<uint2*>(ext);
        for (int k = lane; k < elems / 2; k += kThreads) {
            const uint32_t w = src[k];
            const uint32_t pv = w & kPair, fv = __byte_perm(w, 0u, 0x4341);
            const uint32_t ind8 = (pv + kPair) & (fv + kPair) & (kField << 8);  // the indicator at bits 8, 24
            const uint32_t keep = ind8 - (ind8 >> 8);
            const uint32_t p = (pv & keep) | (ind8 << (kIndAt - 8));  // psi and indicator, a pixel a 16-bit half
            const uint32_t f = fv & keep;
            dst[k] = make_uint2((p & 0xFFFFu) | (f << kPhiAt), (p >> 16) | ((f >> 16) << kPhiAt));
        }
    } else {
        const uint4* src = reinterpret_cast<const uint4*>(raw);
        uint4* dst = reinterpret_cast<uint4*>(ext);
        for (int k = lane; k < elems / 8; k += kThreads) dst[k] = src[k];
    }
}

// Add step t's prepared words to every member's short sums: x is the
// thread's first pixel in the prepared buffer, om the members' offsets.
template <bool kFull>
__device__ __forceinline__ void add_prepared(uint32_t (&sa)[kG], uint32_t (&sb)[kG], const uint32_t* x,
                                             const int (&om)[kG], int n) {
    const char* xb = reinterpret_cast<const char*>(x);
#pragma unroll
    for (int m = 0; m < kG; ++m) {
        if (kFull || m < n) {
            const uint32_t* xm = reinterpret_cast<const uint32_t*>(xb + 4 * om[m]);
            sa[m] += xm[0];
            sb[m] += xm[kWX];
        }
    }
}

// Two 512-thread blocks an SM cap a thread at 64 registers, which the sums
// and a top-K list of up to 8 fit; longer lists run one block an SM. kLong:
// T > 64, the tables reloaded every kStride5 steps.
template <int KB, bool kLong>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 2 : 1)
    grouped_kernel(const uint16_t* __restrict__ pairs, const int* __restrict__ ox, const int* __restrict__ oy,
                   const int* __restrict__ gidx, const uint8_t* __restrict__ cand_ok,
                   const int* __restrict__ gstart, const int* __restrict__ lay, const int* __restrict__ off, int NG,
                   int T, int H, int Wp, int SH, int SW, int K_out, int buf_elems, int ext_elems, Decode D,
                   float* __restrict__ top_lh, int* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    const kb_stage::Plan plan{ox, oy, gstart, lay, off, T};
    const kb_stage::Tables s = kb_stage::tables_at(smem);
    uint16_t* raws = reinterpret_cast<uint16_t*>(smem + header_bytes());
    uint16_t* exts = raws + 2 * (size_t)buf_elems;
    // The long phi sums and counts of member m: s_phi[m * kThreads + tid],
    // s_obs[m * kThreads + tid] (a pointer a thread would spill).
    uint32_t* s_phi = reinterpret_cast<uint32_t*>(exts + 2 * (size_t)ext_elems);
    uint32_t* s_obs = s_phi + kG * kThreads;
    int* s_wide = reinterpret_cast<int*>(s_phi + kLong2 * kThreads);
    const bool wide = T > kFlush;

    const int tx = threadIdx.x % kWX, ty = threadIdx.x / kWX;
    const int col0 = blockIdx.x * kTW;
    const int i0 = blockIdx.y * kTH;
    const int i = i0 + ty;  // this thread's row; its columns are jc and jc + kWX
    const int jc = col0 + tx;
    const float psi_d = __fsub_rn(D.psi_min, D.psi_scale);
    const float phi_d = __fsub_rn(D.phi_min, D.phi_scale);

    for (int p = 0; p < 2; ++p) {
        if (i >= SH || jc + kWX * p >= SW) continue;
        for (int k = 0; k < K_out; ++k) {
            const size_t o = ((size_t)k * SH + i) * SW + jc + kWX * p;
            top_lh[o] = -FLT_MAX;
            top_idx[o] = -1;
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

        // Per member: the two pixels' short sums of prepared words, and the
        // long psi sums as two 16-bit fields (one per column).
        uint32_t sa[kG], sb[kG], ap[kG];
#pragma unroll
        for (int m = 0; m < kG; ++m) {
            sa[m] = sb[m] = ap[m] = 0u;
            s_phi[m * kThreads + threadIdx.x] = s_obs[m * kThreads + threadIdx.x] = 0u;
        }
        __syncthreads();

        stage_window(pairs, H, Wp, raws, s, 0, 0, i0, col0);
        kb_stage::cp_async_wait_all();
        __syncthreads();
        bool shared = shares(s.lay, n, ext_elems);  // whether the step being summed was prepared
        prepare(raws, exts, s.lay[0] * s.lay[1] * s.lay[2], shared);
        if (T > 1) stage_window(pairs, H, Wp, raws + buf_elems, s, 1, 1, i0, col0);
        for (int t = 0; t < T; ++t) {
            kb_stage::cp_async_wait_all();
            __syncthreads();  // step t is prepared and t + 1 has landed; every thread is done with t - 1
            int lt = t;       // the table row of step t
            if (kLong) {
                lt = t % kStride5;
                if (t > 0 && lt == 0) {
                    kb_stage::load_tables<kThreads>(s, plan, g, t);
                    __syncthreads();
                }
            }
            // Step t + 2 into the raw buffer that step t was prepared from;
            // step t summed; then step t + 1 prepared into the buffer that
            // step t - 1 was summed from.
            if (t + 2 < T) stage_window(pairs, H, Wp, raws + (t & 1) * (size_t)buf_elems, s, t + 2, lt + 2, i0, col0);
            const int at = tx + ty * s.lay[lt * kLay + 2];
            const int4* o4 = reinterpret_cast<const int4*>(s.off + lt * kG);
            const int4 oa = o4[0], ob = o4[1];
            const int om[kG] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
            const uint16_t* ext = exts + (t & 1) * (size_t)ext_elems;
            if (shared) {
                const uint32_t* x = reinterpret_cast<const uint32_t*>(ext) + at;
                if (n == kG)
                    add_prepared<true>(sa, sb, x, om, n);
                else
                    add_prepared<false>(sa, sb, x, om, n);
            } else {
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    if (m < n) {
                        const int e = om[m] + at;
                        const uint32_t w = __byte_perm((uint32_t)ext[e], (uint32_t)ext[e + kWX], 0x5410);
                        const uint32_t pv = w & kPair, fv = (w >> 8) & kPair;
                        const uint32_t ind = ((pv + kPair) >> 8) & ((fv + kPair) >> 8) & kField;
                        const uint32_t keep = ind * 0xFFu;
                        const uint32_t f = fv & keep;
                        ap[m] += pv & keep;
                        sa[m] += (f << kPhiAt) | ((ind << kIndAt) & (1u << kIndAt));
                        sb[m] += ((f >> 16) << kPhiAt) | ((ind >> (16 - kIndAt)) & (1u << kIndAt));
                    }
                }
            }
            if (t + 1 < T) {
                const int* ln = s.lay + (lt + 1) * kLay;
                shared = shares(ln, n, ext_elems);
                prepare(raws + ((t + 1) & 1) * (size_t)buf_elems, exts + ((t + 1) & 1) * (size_t)ext_elems,
                        ln[0] * ln[1] * ln[2], shared);
            }
            if (t % kShort == kShort - 1 || t == T - 1) {
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    ap[m] += (sa[m] & kPsiMask) | ((sb[m] & kPsiMask) << 16);
                    s_obs[m * kThreads + threadIdx.x] += ((sa[m] >> kIndAt) & kIndMask) | (((sb[m] >> kIndAt) & kIndMask) << 16);
                    s_phi[m * kThreads + threadIdx.x] += (sa[m] >> kPhiAt) | ((sb[m] >> kPhiAt) << 16);
                    sa[m] = sb[m] = 0u;
                }
            }
            if (wide && (t % kWideEvery == kWideEvery - 1 || t == T - 1)) {
#pragma unroll
                for (int m = 0; m < kG; ++m) {
                    int* wq = s_wide + (m * 4) * kThreads + threadIdx.x;
                    const uint32_t f = s_phi[m * kThreads + threadIdx.x];
                    wq[0] += ap[m] & 0xFFFFu;
                    wq[kThreads] += ap[m] >> 16;
                    wq[2 * kThreads] += f & 0xFFFFu;
                    wq[3 * kThreads] += f >> 16;
                    ap[m] = 0u;
                    s_phi[m * kThreads + threadIdx.x] = 0u;
                }
            }
        }

#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int j = jc + kWX * p;
            if (i >= SH || j >= SW) continue;
            // A list of up to 64 in registers, a longer one in the maps.
            constexpr bool in_map = KB == kb_encoded::kMapList;
            float top[in_map ? 1 : KB];
            int tidx[in_map ? 1 : KB];
            if constexpr (!in_map) load_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
#pragma unroll
            for (int m = 0; m < kG; ++m) {
                if (m < n) {
                    const int obs = (int)((s_obs[m * kThreads + threadIdx.x] >> (16 * p)) & 0xFFFFu);
                    int ps, fs;
                    if (wide) {
                        const int* wq = s_wide + (m * 4) * kThreads + threadIdx.x;
                        ps = wq[p * kThreads];
                        fs = wq[(2 + p) * kThreads];
                    } else {
                        ps = (int)((ap[m] >> (16 * p)) & 0xFFFFu);
                        fs = (int)((s_phi[m * kThreads + threadIdx.x] >> (16 * p)) & 0xFFFFu);
                    }
                    if constexpr (in_map)
                        kb_encoded::insert_member_map(top_lh, top_idx, (size_t)i * SW + j, (size_t)SH * SW, K_out, ps,
                                                      fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m], D, psi_d, phi_d);
                    else
                        insert_member(top, tidx, ps, fs, obs, cand_ok[c0 + m] != 0, gidx[c0 + m], D, psi_d, phi_d);
                }
            }
            if constexpr (!in_map) store_top(top, tidx, K_out, SH, SW, i, j, top_lh, top_idx);
        }
    }
}

}  // namespace

extern "C" {

int kb_search_grouped_max_group() { return kG; }

// The block's tile (axis 0 its rows, axis 1 its columns), the staging chunk
// in pixels (axis 2) and the reads a staged pixel from which a step is
// prepared, in halves (axis 3), for the host's window layout.
int kb_search_grouped_tile(int axis) {
    return axis == 0 ? kTH : (axis == 1 ? kTW : (axis == 2 ? kCH : kShareHalves));
}

// Shared memory for two raw staging buffers of buf_elems code pairs, two
// prepared buffers of ext_elems 16-bit elements, the long phi sums and
// counts (plus the 32-bit field sums past 257 steps).
size_t kb_search_grouped_smem_bytes(int T, int buf_elems, int ext_elems) {
    return header_bytes() + 2 * (size_t)buf_elems * sizeof(uint16_t) + 2 * (size_t)ext_elems * sizeof(uint16_t) +
           (size_t)kLong2 * kThreads * sizeof(uint32_t) + wide_bytes(T);
}

// Resident blocks per SM of the kernel for K_out with smem bytes of shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
int kb_search_grouped_blocks_per_sm(int K_out, int smem) {
#define KB_OCC(KB) return occupancy<kThreads>(grouped_kernel<KB, false>, smem)
    KB_DISPATCH(K_out, KB_OCC)
#undef KB_OCC
    return -1;
}

// ext_elems: 16-bit elements of a prepared buffer, at least twice a
// prepared step's pairs and once any other step's (a multiple of 8);
// pairs: (T, H, Wp) uint8 code pairs as 16-bit words, Wp a multiple of 8,
// 16-byte aligned, the columns W..Wp zero; ox, oy: (C, T) int32
// window-origin offsets in plan order; gidx: (C,) global candidate indices
// and cand_ok (C,) uint8, in plan order; gstart: (NG + 1,) group bounds
// within the plan, each group 1..8 candidates; lay: (NG, T, 5) and off:
// (NG, T, 8) int32, the window layout (csrc/stage_window.cuh) for buffers of
// buf_elems pairs (a multiple of 8); top_lh, top_idx: (K_out, SH, SW).
// K_out >= 1 (past 64 the list stays in the maps), T < 65536. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for what it
// cannot run).
int kb_search_grouped(int ext_elems, const void* pairs, const int* ox, const int* oy, const int* gidx,
                      const uint8_t* cand_ok, const int* gstart, const int* lay, const int* off, int NG, int T,
                      int H, int Wp, int SH, int SW, int K_out, int buf_elems, float psi_min, float psi_scale,
                      float phi_min, float phi_scale, float min_obs, float min_lh, int gate_min_obs,
                      int gate_min_lh, float* top_lh, int* top_idx, void* stream) {
    if (Wp % kCH != 0 || buf_elems % kCH != 0 || ext_elems % kCH != 0 || ext_elems < buf_elems ||
        (reinterpret_cast<uintptr_t>(pairs) & 15) != 0 || T >= 65536 || NG < 1)
        return (int)cudaErrorInvalidValue;
    const Decode D{psi_min, psi_scale, phi_min, phi_scale, min_obs, min_lh, gate_min_obs, gate_min_lh};
    const size_t smem = kb_search_grouped_smem_bytes(T, buf_elems, ext_elems);
    const dim3 grid((SW + kTW - 1) / kTW, (SH + kTH - 1) / kTH);
#define KB_LAUNCH(KB)                                                                                   \
    return launch<kThreads>(T > kb_stage::kRows ? grouped_kernel<KB, true> : grouped_kernel<KB, false>, grid, smem, \
                  (cudaStream_t)stream, (const uint16_t*)pairs, ox, oy, gidx, cand_ok, gstart, lay, off, NG, T, H, \
                  Wp, SH, SW, K_out, buf_elems, ext_elems, D, top_lh, top_idx)
    KB_DISPATCH(K_out, KB_LAUNCH)
#undef KB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
