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
// Wrapping addition is associative, so each output word keeps one running
// sum of every member's three terms (acc_psi[0] twice) and the result is the
// script's in any order.
//
// The modes differ in where the extract and the lane roll sit:
//   A: per member, its word read from shared memory at an index taken from
//      scratch, then the extract;
//   B: the extract once per loaded word (pv, fv, the indicator), then three
//      shifted reads of registers and three adds per member;
//   C: one shared load per word, then per member a shifted read of the
//      loaded words and the extract.
//
// What bounds it on the H100: int32 operations (3 adds per slot and word at
// the least); the inputs are a few KB. The first design (a block of
// 256 threads for one row of one group, 193K blocks at NG = 3,015, each
// staging the whole row through registers, a modulo per slot or member for
// the lane roll, one word a thread and an atomicAdd per word and block)
// took 30.244 ms in mode C against a 4.536 ms bound (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md). This design:
//
// - persistent blocks: a block owns a tile of kTR rows x kTW words and walks
//   a slice of the groups, its sums in registers, with one atomicAdd per
//   word at the end; the slices make one wave of the blocks the SMs hold;
// - both rolls in the staging address: for each (group, t) the block copies,
//   with 4-byte cp.async, row r + rs (mod SL) of the window and the words
//   from column c0 + aln (mod W4) on, kTW + G - 1 of them, so member gi's
//   word for column c sits at c - c0 + gi and the loop has no modulo and no
//   wrap select; double-buffered, one barrier a step;
// - a run of kRun consecutive words a thread, loaded with 16-byte shared
//   loads, so member gi's word for run position j is loaded word j + gi:
//   B is one extract per loaded word and three adds per member-word; C
//   writes one shared load per word and an extract per member-word, but
//   members gi and gi' at run positions j and j' with j + gi = j' + gi'
//   extract the same register, and the compiler keeps one of them: C and
//   B compile to the same instructions (PERF.md). A's loads are
//   volatile, so each member-word is its own shared load, as the mode says.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                     // consecutive output words a thread
constexpr int kRowThreads = 64;             // threads along a tile row
constexpr int kTW = kRun * kRowThreads;     // words per tile row
constexpr int kTR = kThreads / kRowThreads;  // rows per tile
constexpr int kMaxG = 8;                    // most members per slot
constexpr int kStage = kTW + kMaxG - 1;     // words staged a row
constexpr int kPitch = kTW + 8;             // staged row pitch, 16-byte rows
constexpr int kSpan = kRun + 8;             // words a thread loads a row: 4 x 16 bytes
constexpr uint32_t kPair = 0x00FF00FFu;
constexpr uint32_t kField = 0x00010001u;

__device__ __forceinline__ uint32_t indicator(uint32_t pv) { return ((pv + kPair) >> 8) & kField; }

// A volatile shared load: made every time it is written, never merged with
// another load of the same word.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// One step's table entries: row roll, window base, lane alignment.
struct Step {
    int rs, base, aln;
};

__device__ __forceinline__ Step step_at(const int* __restrict__ tbl, int pg, int t, int T) {
    const int* row = tbl + (size_t)pg * 3 * T;
    return Step{row[t], row[T + t], row[2 * T + t]};
}

constexpr int kPer = (kStage + kThreads - 1) / kThreads;  // staged words a thread a row

// Issue the copies of one step into `dst`: tile row rr is window row
// (r0 + rr + rs) mod SL, from column (c0 + aln) mod W4 on. A thread copies
// words k = threadIdx.x + q kThreads of every row, their columns found once.
__device__ __forceinline__ void stage(const uint32_t* __restrict__ buf, uint32_t* dst, Step st, int TH, int W4,
                                      int SL, int r0, int c0) {
    int start = (c0 + st.aln) % W4;
    start += start < 0 ? W4 : 0;
    int col[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        int c = start + (int)threadIdx.x + q * kThreads;
        c -= c >= W4 ? W4 : 0;
        col[q] = c >= W4 ? c % W4 : c;  // only rows narrower than one staged row wrap twice
    }
#pragma unroll
    for (int rr = 0; rr < kTR; ++rr) {
        if (r0 + rr < TH) {
            int q = r0 + rr + st.rs;
            q -= q >= SL ? SL : 0;
            const uint32_t* src = buf + (size_t)(st.base + q) * W4;
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int e = (int)threadIdx.x + k * kThreads;
                if (e < kStage) cp_async4(dst + rr * kPitch + e, src + col[k]);
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

template <char MODE>
__global__ void __launch_bounds__(kThreads)
    exactrow_kernel(const int* __restrict__ tbl, const uint32_t* __restrict__ buf, int NG, int T, int G, int TH,
                    int W4, int SL, uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t stg[2][kTR * kPitch];
    const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kTR;
    const int g0 = (int)((long long)blockIdx.z * NG / gridDim.z);
    const int g1 = (int)((long long)(blockIdx.z + 1) * NG / gridDim.z);
    const int rr = threadIdx.x / kRowThreads;
    const int cl = kRun * (threadIdx.x % kRowThreads);  // the run's first word within the tile
    const bool active = r0 + rr < TH;
    const uint32_t my0 = static_cast<uint32_t>(__cvta_generic_to_shared(&stg[0][rr * kPitch + cl]));
    const uint32_t my1 = static_cast<uint32_t>(__cvta_generic_to_shared(&stg[1][rr * kPitch + cl]));

    uint32_t tot[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) tot[j] = 0u;

    // The table entries of step s + 1 are read during step s - 1, so their
    // load is not in the way of the copies they address.
    const int steps = (g1 - g0) * T;
    if (steps > 0) stage(buf, stg[0], step_at(tbl, g0, 0, T), TH, W4, SL, r0, c0);
    int pg = g0, t = 0;  // step s + 1
    if (++t == T) t = 0, ++pg;
    Step nxt = steps > 1 ? step_at(tbl, pg, t, T) : Step{0, 0, 0};
    for (int s = 0; s < steps; ++s) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();  // step s has landed; every thread is done with step s - 1
        if (s + 1 < steps) stage(buf, stg[(s + 1) & 1], nxt, TH, W4, SL, r0, c0);
        if (++t == T) t = 0, ++pg;
        if (s + 2 < steps) nxt = step_at(tbl, pg, t, T);
        if (!active) continue;
        const uint32_t my = (s & 1) ? my1 : my0;
        if (MODE == 'A') {
#pragma unroll
            for (int gi = 0; gi < kMaxG; ++gi) {
                if (gi < G) {
#pragma unroll
                    for (int j = 0; j < kRun; ++j) {
                        const uint32_t w = lds32(my + 4 * (j + gi));
                        const uint32_t pv = w & kPair, fv = (w >> 8) & kPair;
                        tot[j] += pv + fv + indicator(pv) + (gi == 0 ? pv : 0u);
                    }
                }
            }
        } else {
            uint32_t w[kSpan];
            const uint4* v = reinterpret_cast<const uint4*>(&stg[s & 1][rr * kPitch + cl]);
#pragma unroll
            for (int q = 0; q < kSpan / 4; ++q) {
                const uint4 x = v[q];
                w[4 * q] = x.x;
                w[4 * q + 1] = x.y;
                w[4 * q + 2] = x.z;
                w[4 * q + 3] = x.w;
            }
            if (MODE == 'B') {
                uint32_t pv[kSpan - 1], fv[kSpan - 1], ind[kSpan - 1];
#pragma unroll
                for (int k = 0; k < kSpan - 1; ++k) {
                    pv[k] = w[k] & kPair;
                    fv[k] = (w[k] >> 8) & kPair;
                    ind[k] = indicator(pv[k]);
                }
#pragma unroll
                for (int gi = 0; gi < kMaxG; ++gi) {
                    if (gi < G) {
#pragma unroll
                        for (int j = 0; j < kRun; ++j) {
                            tot[j] += pv[j + gi];
                            tot[j] += fv[j + gi];
                            tot[j] += ind[j + gi];
                            if (gi == 0) tot[j] += pv[j];
                        }
                    }
                }
            } else {
#pragma unroll
                for (int gi = 0; gi < kMaxG; ++gi) {
                    if (gi < G) {
#pragma unroll
                        for (int j = 0; j < kRun; ++j) {
                            const uint32_t pv = w[j + gi] & kPair, fv = (w[j + gi] >> 8) & kPair;
                            tot[j] += pv + fv + indicator(pv) + (gi == 0 ? pv : 0u);
                        }
                    }
                }
            }
        }
    }

    if (!active || steps == 0) return;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int c = c0 + cl + j;
        if (c < W4) atomicAdd(out + (size_t)(r0 + rr) * W4 + c, tot[j]);
    }
}

// The grid of `kernel`: column tiles, row tiles, and as many group slices
// as make one wave of the blocks the SMs hold at once (at most one slice a
// group), so no SM waits on a second wave.
template <typename Kernel>
dim3 grid_for(Kernel kernel, int NG, int TH, int W4) {
    int sms = 132, dev = 0, per_sm = 1;
    if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess || per_sm < 1)
        per_sm = 1;
    const int tiles = ((W4 + kTW - 1) / kTW) * ((TH + kTR - 1) / kTR);
    int slices = per_sm * sms / tiles;
    slices = slices < 1 ? 1 : (slices > NG ? NG : slices);
    slices = slices > 65535 ? 65535 : slices;
    return dim3((W4 + kTW - 1) / kTW, (TH + kTR - 1) / kTR, slices);
}

}  // namespace

extern "C" {

// Widest row the kernel takes: tiles cover any width.
int kb_exactrow_max_width() { return 1 << 24; }

// The block's tile (axis 0 its rows, axis 1 its words) and a thread's run of
// words (axis 2).
int kb_exactrow_tile(int axis) { return axis == 0 ? kTR : (axis == 1 ? kTW : kRun); }

// Resident blocks per SM of the kernel in `mode`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
int kb_exactrow_blocks_per_sm(int mode) {
    int n = -1;
    cudaError_t err = cudaErrorInvalidValue;
    if (mode == 'A') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'A'>, kThreads, 0);
    if (mode == 'B') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'B'>, kThreads, 0);
    if (mode == 'C') err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exactrow_kernel<'C'>, kThreads, 0);
    return err == cudaSuccess ? n : -1;
}

// tbl: (NG, 3T) int32, per group the row rolls, the window bases and the
// lane alignments (rs in [0, SL), base in [0, rows - SL], |aln| < 2^30);
// buf: (rows, W4) int32 words; out: (TH, W4) int32, zeroed by the caller, to
// which every group's total is added. mode 'A', 'B' or 'C'; G <= 8.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for what it cannot run).
int kb_exactrow(const int* tbl, const int* buf, int NG, int T, int G, int TH, int W4, int mode, int* out,
                void* stream) {
    if (G < 1 || G > kMaxG || W4 < 1 || W4 > kb_exactrow_max_width() || TH < 1 || NG < 1 || T < 1 ||
        TH > 65535 * kTR)
        return (int)cudaErrorInvalidValue;
    const int SL = TH + 8;
    const uint32_t* b = reinterpret_cast<const uint32_t*>(buf);
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == 'A') {
        exactrow_kernel<'A'><<<grid_for(exactrow_kernel<'A'>, NG, TH, W4), kThreads, 0, s>>>(tbl, b, NG, T, G, TH, W4, SL, o);
    } else if (mode == 'B') {
        exactrow_kernel<'B'><<<grid_for(exactrow_kernel<'B'>, NG, TH, W4), kThreads, 0, s>>>(tbl, b, NG, T, G, TH, W4, SL, o);
    } else if (mode == 'C') {
        exactrow_kernel<'C'><<<grid_for(exactrow_kernel<'C'>, NG, TH, W4), kThreads, 0, s>>>(tbl, b, NG, T, G, TH, W4, SL, o);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
