// Pieces shared by the encoded search kernels (K4 in search_topk_encoded.cu,
// K5 in search_topk_grouped.cu, K3 in search_topk_encoded_grouped.cu) and K2
// (search_topk.cu): the
// decode of integer code sums, the likelihood, the top-K rank-insert, the
// top-K map's reads and writes, and the launch helpers.
// Every step
// rounds on its own (nvcc would otherwise contract a*b+c into an fma), in
// the order of the plain twin, search_topk_encoded_shift in
// kbmod_tpu_torch/ops/search_encoded_kernel.py.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace kb_encoded {

// Sum of decoded values over `obs` valid samples whose codes sum to
// `code_sum`: scale * code_sum + (min - scale) * obs, as the JAX package's
// kernels decode (kbmod_tpu/ops/search_pallas.py:647-648).
__device__ __forceinline__ float decode_sum(int code_sum, float obs, float scale,
                                            float min_minus_scale) {
    return __fadd_rn(__fmul_rn(scale, __int2float_rn(code_sum)), __fmul_rn(min_minus_scale, obs));
}

// lh = psi / sqrt(phi), IEEE sqrt and division; -1 where phi <= 0.
__device__ __forceinline__ float likelihood(float psi, float phi) {
    return phi > 0.0f ? __fdiv_rn(psi, __fsqrt_rn(phi)) : -1.0f;
}

// Insert (nv, ni) into a sorted top-KB list at p = the number of entries
// ranked above it; entries from p down shift one slot. With `by_index` an
// entry ranks above when its lh is larger, or equal with a smaller index
// (the order-independent rule for candidates that arrive out of index
// order); without, when its lh is larger or equal (candidates arrive in
// index order, so the two agree). Every slot index is static, so the list
// stays in registers.
template <int KB, bool by_index>
__device__ __forceinline__ void rank_insert(float (&top)[KB], int (&tidx)[KB], float nv, int ni) {
    int p = 0;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const bool above = by_index ? (top[k] > nv || (top[k] == nv && tidx[k] < ni)) : (top[k] >= nv);
        p += above ? 1 : 0;
    }
    if (p >= KB) return;
#pragma unroll
    for (int k = KB - 1; k > 0; --k) {
        const bool shift = k > p, here = k == p;
        top[k] = shift ? top[k - 1] : (here ? nv : top[k]);
        tidx[k] = shift ? tidx[k - 1] : (here ? ni : tidx[k]);
    }
    if (p == 0) {
        top[0] = nv;
        tidx[0] = ni;
    }
}

// The gated value a candidate is ranked with: its lh, or -inf when it is a
// padding candidate or fails an enabled gate.
__device__ __forceinline__ float gated(float lh, int obs, bool cand_ok, float min_obs, float min_lh,
                                       int gate_min_obs, int gate_min_lh) {
    bool ok = cand_ok;
    if (gate_min_obs) ok = ok && ((float)obs >= min_obs);
    if (gate_min_lh) ok = ok && (lh >= min_lh);
    return ok ? lh : -INFINITY;
}

// The list length (template KB) of the instantiation for lists longer than
// 64: a pixel's list stays in the (K_out, SH, SW) maps themselves, slot k at
// o + k * plane, and takes any K_out the maps' memory holds.
constexpr int kMapList = 0;

// Whether slot k of a list in the maps ranks above (nv, ni), by
// rank_insert's rule.
template <bool by_index>
__device__ __forceinline__ bool map_above(const float* top_lh, const int* top_idx, size_t at, float nv, int ni) {
    const float v = top_lh[at];
    return by_index ? (v > nv || (v == nv && top_idx[at] < ni)) : (v >= nv);
}

// rank_insert on a list kept in the maps: the same insertion point p and the
// same shift. The list is sorted by the rule, so when its last slot ranks
// above the new entry every slot does and nothing moves.
template <bool by_index>
__device__ __forceinline__ void rank_insert_map(float* top_lh, int* top_idx, size_t o, size_t plane, int K_out,
                                                float nv, int ni) {
    if (map_above<by_index>(top_lh, top_idx, o + (size_t)(K_out - 1) * plane, nv, ni)) return;
    int p = 0;
    for (int k = 0; k < K_out - 1; ++k) p += map_above<by_index>(top_lh, top_idx, o + (size_t)k * plane, nv, ni);
    for (int k = K_out - 1; k > p; --k) {
        top_lh[o + (size_t)k * plane] = top_lh[o + (size_t)(k - 1) * plane];
        top_idx[o + (size_t)k * plane] = top_idx[o + (size_t)(k - 1) * plane];
    }
    top_lh[o + (size_t)p * plane] = nv;
    top_idx[o + (size_t)p * plane] = ni;
}

// Read pixel (i, j)'s top list from the (K_out, SH, SW) maps; slots past
// K_out are empty.
template <int KB>
__device__ __forceinline__ void load_top(float (&top)[KB], int (&tidx)[KB], int K_out, int SH, int SW, int i, int j,
                                         const float* top_lh, const int* top_idx) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const size_t o = ((size_t)k * SH + i) * SW + j;
        top[k] = k < K_out ? top_lh[o] : -FLT_MAX;
        tidx[k] = k < K_out ? top_idx[o] : -1;
    }
}

// Write pixel (i, j)'s first K_out slots to the (K_out, SH, SW) maps.
template <int KB>
__device__ __forceinline__ void store_top(const float (&top)[KB], const int (&tidx)[KB], int K_out, int SH, int SW,
                                          int i, int j, float* top_lh, int* top_idx) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        if (k < K_out) {
            const size_t o = ((size_t)k * SH + i) * SW + j;
            top_lh[o] = top[k];
            top_idx[o] = tidx[k];
        }
    }
}

// The decode and gate parameters of a launch.
struct Decode {
    float psi_min, psi_scale, phi_min, phi_scale;
    float min_obs, min_lh;
    int gate_min_obs, gate_min_lh;
};

// Insert a candidate's decoded sums (ps, fs over obs samples; ok false for
// padding; gi its global index) into a pixel's top list by (lh desc, index
// asc), or, without `by_index`, for candidates that arrive in index order
// (rank_insert); psi_d and phi_d are min - scale, rounded once.
template <int KB, bool by_index = true>
__device__ __forceinline__ void insert_member(float (&top)[KB], int (&tidx)[KB], int ps, int fs, int obs, bool ok,
                                              int gi, const Decode& D, float psi_d, float phi_d) {
    const float fobs = (float)obs;
    const float lh = likelihood(decode_sum(ps, fobs, D.psi_scale, psi_d), decode_sum(fs, fobs, D.phi_scale, phi_d));
    rank_insert<KB, by_index>(top, tidx, gated(lh, obs, ok, D.min_obs, D.min_lh, D.gate_min_obs, D.gate_min_lh), gi);
}

// insert_member for a list kept in the maps (kMapList): pixel at flat index
// o, slot k at o + k * plane.
template <bool by_index = true>
__device__ __forceinline__ void insert_member_map(float* top_lh, int* top_idx, size_t o, size_t plane, int K_out,
                                                  int ps, int fs, int obs, bool ok, int gi, const Decode& D,
                                                  float psi_d, float phi_d) {
    const float fobs = (float)obs;
    const float lh = likelihood(decode_sum(ps, fobs, D.psi_scale, psi_d), decode_sum(fs, fobs, D.phi_scale, phi_d));
    rank_insert_map<by_index>(top_lh, top_idx, o, plane, K_out,
                              gated(lh, obs, ok, D.min_obs, D.min_lh, D.gate_min_obs, D.gate_min_lh), gi);
}

// Resident blocks per SM of `kernel` at NT threads a block with smem bytes
// of dynamic shared memory, or -1.
template <int NT, typename Kernel>
int occupancy(Kernel kernel, int smem) {
    int n = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem) != cudaSuccess)
        return -1;
    return n;
}

// Launch `kernel` at NT threads a block with smem bytes of dynamic shared
// memory; returns cudaGetLastError().
template <int NT, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NT, smem, s>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace kb_encoded

// Instantiate a templated call for the top-K list length that serves K_out:
// a register list up to 64, the list in the maps past it.
#define KB_DISPATCH(K_out, CALL)  \
    if ((K_out) <= 1) CALL(1);    \
    if ((K_out) <= 2) CALL(2);    \
    if ((K_out) <= 4) CALL(4);    \
    if ((K_out) <= 8) CALL(8);    \
    if ((K_out) <= 16) CALL(16);  \
    if ((K_out) <= 32) CALL(32);  \
    if ((K_out) <= 64) CALL(64);  \
    CALL(kb_encoded::kMapList);
