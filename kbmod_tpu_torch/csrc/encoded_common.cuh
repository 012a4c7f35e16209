// Pieces shared by the encoded search kernels (K3, K4 in
// search_topk_encoded.cu, K5 in search_topk_grouped.cu): the decode of
// integer code sums, the likelihood and the top-K rank-insert. Every step
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

}  // namespace kb_encoded
