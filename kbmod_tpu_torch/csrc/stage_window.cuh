// Staging of a candidate group's windows in shared memory, shared by the
// grouped search kernels (K2 in search_topk.cu, K5 in search_topk_grouped.cu).
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kb_stage {

constexpr int kLay = 5;  // ints per (group, t) layout row

// Copy 16 bytes global -> shared without passing through registers; with
// `ok` false no byte is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait for every copy this thread has committed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Origin (plane row, plane column) of staged row `sr` at time step t, and
// the row within its slab: the box's, or slab s's for per-member slabs.
// s_ox/s_oy hold the group's window-origin offsets member-major (m * T + t),
// `lay` the step's layout row.
__device__ __forceinline__ void slab_row_origin(const int* lay, const int* s_ox, const int* s_oy, int T, int t,
                                                int sr, int i0, int col0, int chunk, int& y, int& x) {
    const int nslab = lay[0], rows = lay[1];
    if (nslab == 1) {
        y = i0 + lay[3] + sr;
        x = col0 + lay[4];
    } else {
        const int s = sr / rows;
        y = i0 + s_oy[s * T + t] + (sr - s * rows);
        x = col0 + (s_ox[s * T + t] & ~(chunk - 1));
    }
}

}  // namespace kb_stage
