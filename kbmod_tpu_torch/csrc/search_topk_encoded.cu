// K4 for Hopper: the per-candidate uint8 top-K search, two columns a
// 32-bit add.
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
// hold zero pairs. K3, which served uint16 codes from this source, is now
// grouped, in search_topk_encoded_grouped.cu.
//
// K4 (`kb_search_paired`): uint8, T <= 257. One thread owns two adjacent
// output columns and sums their codes as the two 16-bit fields of one
// 32-bit register, as the TPU kernel does (search_pallas.py:952-956): one
// add serves two columns. A field sum stays exact while T * 255 <= 65535.
//
// What bounds it on the H100: as K2, operations and the load path, not
// HBM: every (pixel, candidate, time) sample is a bounds test, a 2-byte
// load, a validity test and 1.5 integer adds, and the compulsory traffic is
// one read of the codes (2 bytes a pixel and time). The design is that of
// the first K2: neighbouring threads own neighbouring columns, so each
// (candidate, time) read is one coalesced row segment; the (C, T) offsets
// are staged in shared memory in batches; kCB candidates accumulate
// together with time as the outer loop, so one plane's neighbourhood is
// read kCB times while it is hot in L1/L2; the top-K lives in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encoded_common.cuh"

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kCB = 8;       // candidates accumulated together

using kb_encoded::decode_sum;
using kb_encoded::gated;
using kb_encoded::likelihood;
using kb_encoded::rank_insert;
using kb_encoded::store_top;

// Stages a batch of candidates' offsets and validity in shared memory.
__device__ __forceinline__ void stage_batch(int* s_ox, int* s_oy, uint8_t* s_ok, const int* ox,
                                            const int* oy, const uint8_t* cand_ok, int c0, int ncs,
                                            int T) {
    __syncthreads();
    for (int e = threadIdx.x; e < ncs * T; e += kBlock) {
        s_ox[e] = ox[(size_t)c0 * T + e];
        s_oy[e] = oy[(size_t)c0 * T + e];
    }
    for (int e = threadIdx.x; e < ncs; e += kBlock) s_ok[e] = cand_ok[c0 + e];
    __syncthreads();
}

template <int KB>
__device__ __forceinline__ void init_top(float (&top)[KB], int (&tidx)[KB]) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        top[k] = -FLT_MAX;
        tidx[k] = -1;
    }
}

// K4: uint8 pairs as 16-bit words; thread owns columns j0 = 2 * (block
// column) and j0 + 1. The two columns' words form one 32-bit register
// [psi0, phi0, psi1, phi1] (bytes, low first); the psi fields are bits
// 0-7 and 16-23, the phi fields bits 8-15 and 24-31.
template <int KB>
__global__ void __launch_bounds__(kBlock)
    paired_kernel(const uint16_t* __restrict__ pairs, const int* __restrict__ ox,
                  const int* __restrict__ oy, const uint8_t* __restrict__ cand_ok, int C, int T,
                  int H, int W, int Wp, int SH, int SW, int K_out, int CS, int cand_offset,
                  float psi_min, float psi_scale, float phi_min, float phi_scale, float min_obs,
                  float min_lh, int gate_min_obs, int gate_min_lh, float* __restrict__ top_lh,
                  int* __restrict__ top_idx) {
    extern __shared__ int smem[];
    int* s_ox = smem;
    int* s_oy = s_ox + CS * T;
    uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_oy + CS * T);
    constexpr uint32_t kPairOnes = 0x00FF00FFu;   // one code field per column
    constexpr uint32_t kFieldOnes = 0x00010001u;  // bit 0 of each 16-bit field

    const int j0 = 2 * (blockIdx.x * kBlock + threadIdx.x);
    const int i = blockIdx.y;
    const bool active = j0 < SW;
    const size_t plane = (size_t)H * Wp;
    const float psi_d = __fsub_rn(psi_min, psi_scale);
    const float phi_d = __fsub_rn(phi_min, phi_scale);

    float top0[KB], top1[KB];
    int tidx0[KB], tidx1[KB];
    init_top(top0, tidx0);
    init_top(top1, tidx1);

    for (int c0 = 0; c0 < C; c0 += CS) {
        const int ncs = min(CS, C - c0);
        stage_batch(s_ox, s_oy, s_ok, ox, oy, cand_ok, c0, ncs, T);
        if (!active) continue;
        for (int cb = 0; cb < ncs; cb += kCB) {
            uint32_t ap[kCB], af[kCB], ao[kCB];
#pragma unroll
            for (int u = 0; u < kCB; ++u) ap[u] = af[u] = ao[u] = 0u;
            const uint16_t* pt = pairs;
            for (int t = 0; t < T; ++t, pt += plane) {
#pragma unroll
                for (int u = 0; u < kCB; ++u) {
                    if (cb + u < ncs) {
                        const int y = s_oy[(cb + u) * T + t] + i;
                        const int x = s_ox[(cb + u) * T + t] + j0;
                        if ((unsigned)y < (unsigned)H) {
                            const uint16_t* row = pt + (size_t)y * Wp;
                            uint32_t w;
                            if ((x & 1) == 0 && x >= 0 && x + 1 < W) {
                                w = *reinterpret_cast<const uint32_t*>(row + x);  // 4-byte aligned
                            } else {
                                const uint32_t lo = (unsigned)x < (unsigned)W ? row[x] : 0u;
                                const uint32_t hi = (unsigned)(x + 1) < (unsigned)W ? row[x + 1] : 0u;
                                w = lo | (hi << 16);
                            }
                            const uint32_t pf = w & kPairOnes;
                            const uint32_t ff = (w >> 8) & kPairOnes;
                            // Per field: (v + 255) has bit 8 set iff v > 0.
                            const uint32_t both = (((pf + kPairOnes) >> 8) & kFieldOnes) &
                                                  (((ff + kPairOnes) >> 8) & kFieldOnes);
                            const uint32_t keep = both * 0xFFFFu;  // 0xFFFF in each valid field
                            ap[u] += pf & keep;
                            af[u] += ff & keep;
                            ao[u] += both;
                        }
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kCB; ++u) {
                if (cb + u >= ncs) break;
                const bool ok = s_ok[cb + u] != 0;
                const int ni = cand_offset + c0 + cb + u;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int sh = 16 * h;
                    const int obs_i = (int)((ao[u] >> sh) & 0xFFFFu);
                    const float obs = (float)obs_i;
                    const float lh =
                        likelihood(decode_sum((int)((ap[u] >> sh) & 0xFFFFu), obs, psi_scale, psi_d),
                                   decode_sum((int)((af[u] >> sh) & 0xFFFFu), obs, phi_scale, phi_d));
                    const float nv = gated(lh, obs_i, ok, min_obs, min_lh, gate_min_obs, gate_min_lh);
                    if (h == 0) rank_insert<KB, false>(top0, tidx0, nv, ni);
                    else rank_insert<KB, false>(top1, tidx1, nv, ni);
                }
            }
        }
    }
    if (!active) return;
    store_top(top0, tidx0, K_out, SH, SW, i, j0, top_lh, top_idx);
    if (j0 + 1 < SW) store_top(top1, tidx1, K_out, SH, SW, i, j0 + 1, top_lh, top_idx);
}

// Opts a kernel in to more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int kb_search_paired_cand_batch() { return kCB; }

// Shared memory for CS staged candidates of T offsets each.
size_t kb_search_paired_smem_bytes(int CS, int T) {
    return (size_t)CS * T * 2 * sizeof(int) + (size_t)CS;
}

// Common arguments: pairs (T, H, Wp) code pairs; ox, oy (C, T) int32
// window-origin offsets; cand_ok (C,) uint8; top_lh, top_idx (K_out, SH,
// SW). All contiguous on the device. K_out <= 64. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for what it cannot run).
#define KB_ENC_PARAMS                                                                              \
    const void *pairs, const int *ox, const int *oy, const uint8_t *cand_ok, int C, int T, int H,  \
        int W, int Wp, int SH, int SW, int K_out, int CS, int cand_offset, float psi_min,          \
        float psi_scale, float phi_min, float phi_scale, float min_obs, float min_lh,              \
        int gate_min_obs, int gate_min_lh, float *top_lh, int *top_idx, void *stream
#define KB_ENC_ARGS                                                                                \
    ox, oy, cand_ok, C, T, H, W, Wp, SH, SW, K_out, CS, cand_offset, psi_min, psi_scale, phi_min,  \
        phi_scale, min_obs, min_lh, gate_min_obs, gate_min_lh, top_lh, top_idx

// K4: uint8 codes, T <= 257.
int kb_search_paired(KB_ENC_PARAMS) {
    if (T > 257) return (int)cudaErrorInvalidValue;
    const size_t smem = kb_search_paired_smem_bytes(CS, T);
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((SW + 2 * kBlock - 1) / (2 * kBlock), SH);
#define KB_LAUNCH(KB)                                                                              \
    {                                                                                              \
        auto k = paired_kernel<KB>;                                                                \
        int err = allow_smem(k, smem);                                                        \
        if (err) return err;                                                                       \
        k<<<grid, kBlock, smem, s>>>((const uint16_t*)pairs, KB_ENC_ARGS);                         \
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
