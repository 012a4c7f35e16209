// K6 for Hopper: the design micro-benchmark of K5's packed inner loop.
//
// Replaces the TPU kernel that `make_kernel(mode)` returns
// (scripts/exactrow_microbench.py:49, `pallas_call` :113). All arithmetic is
// on uint32 and wraps mod 2^32. With SL = TH + 8 and P = 0x00FF00FF, for
// every group pg < NG:
//
//   acc_psi/phi/obs[gi] = 0 (TH, W4) for gi < G
//   for t < T:
//     rs = tbl[pg, t], base = tbl[pg, T + t]
//     pw[r] = buf[base + (r + rs) mod SL]                  (the row roll)
//     for gi < G:
//       aln = tbl[pg, 2T + t] + gi
//       wm[:, c] = pw[:, (c + aln) mod W4]                 (the lane roll)
//       pv = wm & P, fv = (wm >> 8) & P
//       acc_psi[gi] += pv, acc_phi[gi] += fv,
//       acc_obs[gi] += ((pv + P) >> 8) & 0x00010001
//   out += acc_psi[0] + sum_gi (acc_psi[gi] + acc_phi[gi] + acc_obs[gi])
//
// Every 32-bit word packs two pixels' (psi, phi) uint8 codes, as the port's
// uint8 code pairs do, so the loop is K5's: two pixels per add, 16-bit fields.
//
// The modes differ in where the extract and the lane roll sit:
//   A: per member, the lane-roll index from scratch (a modulo), then the
//      extract from the staged word;
//   B: the extract once per staged word into three planes (pv, fv, the
//      indicator), then three shifted reads and three adds per member;
//   C: the lane-roll index once per slot, then per member a shifted read
//      and the extract.
//
// What bounds it on the H100: int32 operations (3 adds per slot and word at
// the least); the inputs are a few KB. The design: one thread owns one
// output word, so a (group, t) slot costs it G x (1 or 3) shared loads plus
// the extract; the block stages its rolled row (the row roll is the staging
// address) in shared memory, double-buffered through registers so the global
// loads of step t + 1 are in flight while step t sums, with one barrier a
// step. The TPU's grid walks the groups in order and carries `out` from one
// to the next; here blocks take (column tile, row, group) in no order and add
// their totals with a uint32 atomicAdd, which is exact in any order because
// wrapping integer addition is associative.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // output words per block (one row)
constexpr int kMaxG = 8;        // most members per slot
constexpr int kMaxPerThread = 8;  // staged words per thread: W4 <= 2048
constexpr uint32_t kPair = 0x00FF00FFu;
constexpr uint32_t kField = 0x00010001u;

__device__ __forceinline__ uint32_t indicator(uint32_t pv) { return ((pv + kPair) >> 8) & kField; }

template <char MODE>
__global__ void __launch_bounds__(kThreads)
    exactrow_kernel(const int* __restrict__ tbl, const uint32_t* __restrict__ buf, int T, int G, int TH,
                    int W4, int SL, uint32_t* __restrict__ out) {
    // Two buffers of the staged row: the packed words (A, C) or the three
    // extracted planes (B).
    extern __shared__ uint32_t smem[];
    constexpr int kPlanes = MODE == 'B' ? 3 : 1;
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const int r = blockIdx.y;
    const int pg = blockIdx.z;
    const int* row = tbl + (size_t)pg * 3 * T;

    uint32_t acc_psi[kMaxG], acc_phi[kMaxG], acc_obs[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc_psi[gi] = acc_phi[gi] = acc_obs[gi] = 0u;

    uint32_t pre[kMaxPerThread];
    auto load = [&](int t) {
        const int rs = row[t], base = row[T + t];
        const uint32_t* src = buf + (size_t)(base + (r + rs) % SL) * W4;
#pragma unroll
        for (int k = 0; k < kMaxPerThread; ++k) {
            const int e = threadIdx.x + k * kThreads;
            if (e < W4) pre[k] = src[e];
        }
    };
    auto store = [&](int t) {
        uint32_t* dst = smem + (t & 1) * kPlanes * W4;
#pragma unroll
        for (int k = 0; k < kMaxPerThread; ++k) {
            const int e = threadIdx.x + k * kThreads;
            if (e < W4) {
                if (MODE == 'B') {
                    const uint32_t pv = pre[k] & kPair;
                    dst[e] = pv;
                    dst[W4 + e] = (pre[k] >> 8) & kPair;
                    dst[2 * W4 + e] = indicator(pv);
                } else {
                    dst[e] = pre[k];
                }
            }
        }
    };

    load(0);
    store(0);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
        if (t + 1 < T) load(t + 1);  // in flight while step t sums
        const uint32_t* w = smem + (t & 1) * kPlanes * W4;
        const int aln = row[2 * T + t];
        if (c < W4) {
            if (MODE == 'A') {
#pragma unroll
                for (int gi = 0; gi < kMaxG; ++gi) {
                    if (gi < G) {
                        const int col = ((c + aln + gi) % W4 + W4) % W4;
                        const uint32_t wm = w[col];
                        const uint32_t pv = wm & kPair, fv = (wm >> 8) & kPair;
                        acc_psi[gi] += pv;
                        acc_phi[gi] += fv;
                        acc_obs[gi] += indicator(pv);
                    }
                }
            } else {
                int col = ((c + aln) % W4 + W4) % W4;
#pragma unroll
                for (int gi = 0; gi < kMaxG; ++gi) {
                    if (gi < G) {
                        if (MODE == 'B') {
                            acc_psi[gi] += w[col];
                            acc_phi[gi] += w[W4 + col];
                            acc_obs[gi] += w[2 * W4 + col];
                        } else {
                            const uint32_t wm = w[col];
                            const uint32_t pv = wm & kPair, fv = (wm >> 8) & kPair;
                            acc_psi[gi] += pv;
                            acc_phi[gi] += fv;
                            acc_obs[gi] += indicator(pv);
                        }
                        col = col + 1 == W4 ? 0 : col + 1;
                    }
                }
            }
        }
        if (t + 1 < T) store(t + 1);  // the buffer step t - 1 read, free since the last barrier
        __syncthreads();
    }

    if (c < W4) {
        uint32_t tot = acc_psi[0];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) tot += acc_psi[gi] + acc_phi[gi] + acc_obs[gi];
        atomicAdd(out + (size_t)r * W4 + c, tot);
    }
}

}  // namespace

extern "C" {

int kb_exactrow_max_width() { return kThreads * kMaxPerThread; }

// Resident blocks per SM of the kernel in `mode` for rows of W4 words
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
int kb_exactrow_blocks_per_sm(int mode, int W4) {
    int n = -1;
    const size_t plane = (size_t)W4 * sizeof(uint32_t);
    cudaError_t err = cudaErrorInvalidValue;
    if (mode == 'A') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'A'>, kThreads, 2 * plane);
    if (mode == 'B') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'B'>, kThreads, 6 * plane);
    if (mode == 'C') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'C'>, kThreads, 2 * plane);
    return err == cudaSuccess ? n : -1;
}

// tbl: (NG, 3T) int32, per group the row rolls, the window bases and the
// lane alignments (rs in [0, SL), base in [0, rows - SL]); buf: (rows, W4)
// int32 words; out: (TH, W4) int32, zeroed by the caller, to which every
// group's total is added. mode 'A', 'B' or 'C'; G <= 8, W4 <= 2048.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for what it cannot run).
int kb_exactrow(const int* tbl, const int* buf, int NG, int T, int G, int TH, int W4, int mode, int* out,
                void* stream) {
    if (G < 1 || G > kMaxG || W4 < 1 || W4 > kThreads * kMaxPerThread || TH < 1 || NG < 1 || T < 1 ||
        NG > 65535 || TH > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W4 + kThreads - 1) / kThreads, TH, NG);
    const int SL = TH + 8;
    const uint32_t* b = reinterpret_cast<const uint32_t*>(buf);
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    cudaStream_t s = (cudaStream_t)stream;
    const size_t plane = (size_t)W4 * sizeof(uint32_t);
    if (mode == 'A') {
        exactrow_kernel<'A'><<<grid, kThreads, 2 * plane, s>>>(tbl, b, T, G, TH, W4, SL, o);
    } else if (mode == 'B') {
        exactrow_kernel<'B'><<<grid, kThreads, 6 * plane, s>>>(tbl, b, T, G, TH, W4, SL, o);
    } else if (mode == 'C') {
        exactrow_kernel<'C'><<<grid, kThreads, 2 * plane, s>>>(tbl, b, T, G, TH, W4, SL, o);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
