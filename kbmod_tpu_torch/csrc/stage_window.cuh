// Staging of a candidate group's windows in shared memory, shared by the
// grouped search kernels (K2 in search_topk.cu, K5 in search_topk_grouped.cu,
// K3 in search_topk_encoded_grouped.cu).
//
// A block owns a tile of the search window; for each (group, time step) it
// copies, asynchronously, the pixels every member's window of that tile
// reads. The host computes the layout (kbmod_tpu_torch/ops/search_plan.py
// `window_layout`): per (group, t) a row of kLay ints
//
//   nslab, rows, pitch, y, x
//
// nslab == 1: one box that covers every member's window, `rows` x `pitch`
//   pixels whose origin is (y, x) relative to the tile's (row, column);
// nslab == n: one slab of `rows` x `pitch` per member, the member's own
//   window, whose origin is (oy_m, ox_m rounded down to the chunk);
//
// and per (group, t, member) the offset, in pixels within the staging
// buffer, of the member's window origin. Slabs lie one under the other with
// one pitch. Columns are staged in 16-byte chunks: origins are multiples of
// the chunk and the plane's padded width is too, so a chunk lies wholly
// inside or wholly outside the plane; one outside (or on a row outside) is
// zero-filled, which is how the kernels see the edge of the image.
//
// A group's tables (window-origin offsets, layout rows, member offsets) sit
// in shared memory for kRows time steps at a time, so a block's shared
// memory does not grow with T. A stack of at most kRows steps loads them
// once a group. A longer one (the kernels' kLong instantiation) reloads
// them every kStride = kRows - 1 steps: during step t a kernel issues the
// copy of step t + 1, so the tables must hold t and t + 1; the reload at
// step t (a multiple of kStride) comes after the barrier that opens step
// t, when every thread is done with step t - 1 and with the issue of step
// t, and has a barrier of its own. Step t then sits in row t % kStride.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kb_stage {

constexpr int kLay = 5;     // ints per (group, t) layout row
constexpr int kG = 8;       // most candidates in a group
constexpr int kRows = 64;   // time steps of a group's tables resident at once
constexpr int kStride = kRows - 1;  // steps between reloads

// Shared memory of the tables: offsets (kG x kRows twice), layout rows
// (kRows x kLay) and member offsets (kRows x kG), rounded up to 16 bytes.
__host__ __device__ constexpr size_t header_bytes() {
    return ((size_t)(3 * kG + kLay) * kRows * sizeof(int) + 15) / 16 * 16;
}

// A group's tables in shared memory: row lt holds step b + lt, b the step
// of the last (re)load.
struct Tables {
    int* ox;   // (kG, kRows) window-origin columns, member-major
    int* oy;   // (kG, kRows) window-origin rows
    int* lay;  // (kRows, kLay)
    int* off;  // (kRows, kG), 16-byte aligned rows
};

__device__ __forceinline__ Tables tables_at(unsigned char* smem) {
    int* p = reinterpret_cast<int*>(smem);
    return Tables{p, p + kG * kRows, p + 2 * kG * kRows, p + (2 * kG + kLay) * kRows};
}

// The host's tables for the whole search: ox, oy (C, T) window-origin
// offsets in plan order; gstart (NG + 1,) group bounds; lay (NG, T, kLay)
// and off (NG, T, kG).
struct Plan {
    const int* ox;
    const int* oy;
    const int* gstart;
    const int* lay;
    const int* off;
    int T;
};

// Load steps [b, min(b + kRows, T)) of group g's tables into rows 0, 1, ...
// Every thread of the block takes part; NT is a multiple of kRows.
template <int NT>
__device__ __forceinline__ void load_tables(const Tables& s, const Plan& P, int g, int b) {
    static_assert(NT % kRows == 0, "a block loads whole rows of offsets");
    const int c0 = P.gstart[g], n = P.gstart[g + 1] - c0;
    const int nr = min(kRows, P.T - b);
    const int r = threadIdx.x % kRows;
    if (r < nr) {
        for (int m = threadIdx.x / kRows; m < n; m += NT / kRows) {
            const size_t src = (size_t)(c0 + m) * P.T + b + r;
            s.ox[m * kRows + r] = P.ox[src];
            s.oy[m * kRows + r] = P.oy[src];
        }
    }
    const size_t row0 = (size_t)g * P.T + b;
    for (int e = threadIdx.x; e < kLay * nr; e += NT) s.lay[e] = P.lay[row0 * kLay + e];
    for (int e = threadIdx.x; e < kG * nr; e += NT) s.off[e] = P.off[row0 * kG + e];
}

// Copy 16 bytes global -> shared without passing through registers; with
// `ok` false no byte is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait for every copy this thread has committed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Origin (plane row, plane column) of staged row `sr` at table row lt: the
// box's, or slab m's for per-member slabs.
__device__ __forceinline__ void slab_row_origin(const Tables& s, int lt, int sr, int i0, int col0, int chunk, int& y,
                                                int& x) {
    const int* lay = s.lay + lt * kLay;
    const int nslab = lay[0], rows = lay[1];
    if (nslab == 1) {
        y = i0 + lay[3] + sr;
        x = col0 + lay[4];
    } else {
        const int m = sr / rows;
        y = i0 + s.oy[m * kRows + lt] + (sr - m * rows);
        x = col0 + (s.ox[m * kRows + lt] & ~(chunk - 1));
    }
}

// Issue the copies of step t's windows of one plane of PX-sized pixels
// (T, H, Wp) into `buf`, in 16-byte chunks of 16 / sizeof(PX) pixels, a
// warp a staged row; lt is the table row that holds step t.
template <int NT, typename PX>
__device__ __forceinline__ void stage_plane(const PX* plane, int H, int Wp, PX* buf, const Tables& s, int t, int lt,
                                            int i0, int col0) {
    constexpr int kCH = 16 / sizeof(PX);
    const int* lay = s.lay + lt * kLay;
    const int nrows = lay[0] * lay[1], pitch = lay[2];
    const int per_row = pitch / kCH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int sr = warp; sr < nrows; sr += NT / 32) {
        int y, x;
        slab_row_origin(s, lt, sr, i0, col0, kCH, y, x);
        const bool yin = (unsigned)y < (unsigned)H;
        const size_t row = ((size_t)t * H + (yin ? y : 0)) * Wp;
        for (int c = lane; c < per_row; c += 32) {
            const int xs = x + kCH * c;
            const bool ok = yin && xs >= 0 && xs < Wp;
            cp_async16(buf + sr * pitch + kCH * c, plane + (ok ? row + xs : 0), ok);
        }
    }
    cp_async_commit();
}

}  // namespace kb_stage
