"""The host side of the grouped search kernels K2, K3 and K5: their
grouping plan and the layout of the windows they stage in shared memory.

The layout is checked by replaying, in numpy, what a kernel does with it
(csrc/stage_window.cuh): copy each staged row in chunks from the plane,
zero-filling chunks outside it, then read every member's window at its
offset. Each read must land inside the buffer and give the plane's pixel
(0 outside the image). Exact equality throughout. The kernels hold a
group's tables for 64 steps at a time, so their shared memory does not
depend on T: the host plans are checked at long T on the 41 x 41 grid.
"""

import numpy as np
import pytest

from kbmod_tpu_torch.ops import _build, search_plan
from kbmod_tpu_torch.ops.search import trajectory_offsets
from kbmod_tpu_torch.ops.search_encoded_kernel import (
    K3_CHUNK,
    K3_MAX_T,
    K3_TILE_COLS,
    K3_TILE_ROWS,
    K5_CHUNK,
    K5_MAX_T,
    K5_TILE_COLS,
    K5_TILE_ROWS,
    PAIRED_MAX_T,
    K4_CHUNK,
    K4_TILE_COLS,
    K4_TILE_ROWS,
    k3_staging,
    k4_staging,
    k5_staging,
)
from kbmod_tpu_torch.ops.search_kernel import K2_CHUNK, K2_MAX_T, K2_TILE_COLS, K2_TILE_ROWS, k2_staging
from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

# The tables' shared memory: (3 G + 5) ints for each of 64 steps.
HEADER = (3 * 8 + 5) * 64 * 4


def _offsets(C=45, T=7, vx=12.0, vy=2.0, seed=3, dup=11):
    rng = np.random.default_rng(seed)
    vxs = rng.uniform(-vx, vx, C).astype(np.float32)
    vys = rng.uniform(-vy, vy, C).astype(np.float32)
    vxs[C - dup :], vys[C - dup :] = vxs[0], vys[0]
    return trajectory_offsets(vxs, vys, np.linspace(0.0, 2.5, T))


def _replay(plane, ox, oy, starts, lay, off, tile_rows, tile_cols, chunk, extra, i0, col0, buf_elems):
    """Stage every (group, t) as a kernel's block at (i0, col0) does and
    check every member's window read against the plane."""
    T_, H, Wp = plane.shape
    C, T = ox.shape
    n = np.diff(np.append(starts, C))
    for g, s in enumerate(starts):
        for t in range(T):
            nslab, rows, pitch, y, x = (int(v) for v in lay[g, t])
            assert pitch % chunk == 0 and nslab * rows * pitch <= buf_elems
            buf = np.full(nslab * rows * pitch, -1, dtype=np.int64)
            for sr in range(nslab * rows):
                if nslab == 1:
                    yy, xx = i0 + y + sr, col0 + x
                else:
                    m, r = divmod(sr, rows)
                    yy, xx = i0 + oy[s + m, t] + r, col0 + (ox[s + m, t] & ~(chunk - 1))
                for k in range(pitch // chunk):
                    xs = xx + k * chunk
                    ok = 0 <= yy < H and 0 <= xs < Wp
                    buf[sr * pitch + k * chunk : sr * pitch + (k + 1) * chunk] = plane[t, yy, xs : xs + chunk] if ok else 0
            r, c = np.arange(tile_rows)[:, None], np.arange(tile_cols + extra)[None, :]
            for m in range(n[g]):
                e = off[g, t, m] + r * pitch + c
                assert e.min() >= 0 and e.max() < len(buf)
                yy, xx = i0 + oy[s + m, t] + r, col0 + ox[s + m, t] + c
                inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < Wp)
                want = np.where(inside, plane[t, np.clip(yy, 0, H - 1), np.clip(xx, 0, Wp - 1)], 0)
                assert np.array_equal(buf[e], want), (g, t, m)


@pytest.mark.parametrize("case", ["groups", "uniform", "wide_spread", "negative_origins"])
def test_window_layout_replays_exactly(case):
    tile_rows, tile_cols, chunk, extra = 2, 16, 8, 1  # a small kernel tile
    vx = 40.0 if case == "wide_spread" else 6.0
    vy = 0.0 if case == "uniform" else 2.0
    dxs, dys = _offsets(C=21, T=5, vx=vx, vy=vy)
    x_min, y_min = (-9, -4) if case == "negative_origins" else (0, 0)
    (order, starts), _ = search_plan.grouped_plan(dys)
    ox, oy = dxs[order].astype(np.int64) + x_min, dys[order].astype(np.int64) + y_min
    lay, off, buf_elems = search_plan.window_layout(
        ox, oy, starts, tile_rows=tile_rows, tile_cols=tile_cols, chunk=chunk, extra=extra)
    if case == "uniform":
        assert (lay[..., 0] == 1).all() and (lay[..., 1] == tile_rows).all()
    if case == "wide_spread":
        assert (lay[..., 0] > 1).any(), "no step staged one slab per member"
    plane = np.arange(1, 5 * 12 * 40 + 1, dtype=np.int64).reshape(5, 12, 40)
    for i0, col0 in ((0, 0), (4, 16), (10, 32)):
        _replay(plane, ox, oy, starts, lay, off, tile_rows, tile_cols, chunk, extra, i0, col0, buf_elems)


@pytest.mark.parametrize("case", ["box", "slabs", "negative_origins", "far_right"])
@pytest.mark.parametrize("bits", [16, 8])
def test_k3_layout_replays_exactly(bits, case):
    """K3's own layout (an 8 x 128 tile, 16-byte chunks of 4 uint16 or 8
    uint8 pairs, no extra column) replayed at three block positions, the
    last one past the plane's right edge."""
    dxs, dys = _offsets(C=21, T=5, vx=200.0 if case == "slabs" else 6.0, vy=2.0)
    x_min, y_min = {"negative_origins": (-9, -4), "far_right": (150, 3)}.get(case, (0, 0))
    st = k3_staging(dxs, dys, x_min, y_min, bits)
    order, starts, lay = st["order"], st["starts"], st["lay"]
    if case == "slabs":
        assert (lay[..., 0] > 1).any(), "no step staged one slab per member"
    if case == "box":
        assert (lay[..., 0] == 1).all()
    ox, oy = dxs[order].astype(np.int64) + x_min, dys[order].astype(np.int64) + y_min
    plane = np.arange(1, 5 * 12 * 264 + 1, dtype=np.int64).reshape(5, 12, 264)
    for i0, col0 in ((0, 0), (4, 128), (8, 256)):
        _replay(plane, ox, oy, starts, lay, st["off"], K3_TILE_ROWS, K3_TILE_COLS, K3_CHUNK[bits], 0, i0, col0,
                st["buf_elems"])


def test_grouped_plan_groups_and_order():
    dxs, dys = _offsets(C=45)
    (order, starts), fills = search_plan.grouped_plan(dys)
    sizes = np.diff(np.append(starts, len(order)))
    assert sorted(order.tolist()) == list(range(45))
    assert starts[0] == 0 and (sizes >= 1).all() and (sizes <= 8).all()
    assert (sizes > 1).any() and fills
    # Rows within a group stay within S = 8 at every step.
    d = dys[order]
    spread = np.maximum.reduceat(d, starts) - np.minimum.reduceat(d, starts)
    assert spread.max() <= 8


def test_grouped_plan_takes_uniform_rows():
    dxs, dys = _offsets(C=40, vy=0.0, dup=0)
    (order, starts), _ = search_plan.grouped_plan(dys)
    assert len(starts) == 5  # every row sequence identical: 40 / 8 full groups
    assert np.array_equal(order, np.arange(40))


@pytest.mark.parametrize("staging", ["k2", "k5", "k3-u16", "k3-u8"])
def test_staging_layout_and_shared_memory(staging):
    dxs, dys = _offsets(C=45, T=12, vx=30.0)
    if staging == "k2":
        st = k2_staging(dxs, dys, -5, 3)
        order, starts = st["order"], st["starts"]
        rows, cols, chunk, extra, per_pixel, wide = K2_TILE_ROWS, K2_TILE_COLS, K2_CHUNK, 0, 9, 0
    elif staging.startswith("k3"):
        bits = 16 if staging == "k3-u16" else 8
        st = k3_staging(dxs, dys, -5, 3, bits)
        order, starts = st["order"], st["starts"]
        assert (order, starts) == search_plan.grouped_plan(dys)[0]
        rows, cols, chunk, extra, per_pixel, wide = K3_TILE_ROWS, K3_TILE_COLS, K3_CHUNK[bits], 0, bits // 4, 0
        assert chunk * per_pixel == 16
    else:
        plan, _ = search_plan.grouped_plan(dys)
        st = k5_staging(dxs, dys, -5, 3, plan)
        order, starts = plan
        rows, cols, chunk, extra, per_pixel, wide = K5_TILE_ROWS, K5_TILE_COLS, K5_CHUNK, 0, 2, 0
    NG, T = len(starts), dys.shape[1]
    assert st["lay"].shape == (NG, T, 5) and st["off"].shape == (NG, T, 8)
    assert st["lay"].dtype == np.int32 and st["off"].dtype == np.int32
    lay, off, buf_elems = search_plan.window_layout(
        dxs[order] - 5, dys[order] + 3, starts, tile_rows=rows, tile_cols=cols, chunk=chunk, extra=extra)
    assert np.array_equal(lay, st["lay"]) and np.array_equal(off, st["off"]) and buf_elems == st["buf_elems"]
    assert buf_elems % chunk == 0
    # A member's own slab bounds the buffer: 8 x rows x (cols + extra + chunk - 1), rounded up.
    assert buf_elems <= 8 * rows * (-(-(cols + extra + chunk - 1) // chunk) * chunk)
    assert search_plan.staging_header_bytes() == HEADER
    # K5 adds two prepared buffers (4 bytes a pixel of a prepared step, 2 of
    # any other) and a thread's long phi sums and counts.
    prepared = 2 * 2 * st["ext_elems"] + 8 * 2 * 512 * 4 if staging == "k5" else 0
    assert st["smem_bytes"] == HEADER + 2 * per_pixel * buf_elems + prepared + wide


def test_staging_caches_and_k5_counts_wide_sums():
    dxs, dys = _offsets(C=20, T=300, vx=2.0, vy=0.3)
    plan, _ = search_plan.grouped_plan(dys)
    st = k5_staging(dxs, dys, 0, 0, plan)
    assert st["smem_bytes"] == HEADER + 4 * st["buf_elems"] + 4 * st["ext_elems"] + 8 * 2 * 512 * 4 + 8 * 4 * 512 * 4
    assert k5_staging(dxs.copy(), dys.copy(), 0, 0, plan)["lay"] is st["lay"]


def _staging(name, dxs, dys):
    if name == "k4":
        return k4_staging(dxs, dys, 0, 0)
    if name == "k2":
        return k2_staging(dxs, dys, 0, 0)
    if name == "k5":
        return k5_staging(dxs, dys, 0, 0, search_plan.grouped_plan(dys)[0])
    return k3_staging(dxs, dys, 0, 0, 16 if name == "k3-u16" else 8)


@pytest.mark.parametrize("staging", ["k2", "k5", "k3-u16", "k4"])
def test_too_large_windows_raise(staging, monkeypatch):
    """The plans refuse a layout that does not fit a block's shared memory;
    with the tables' size fixed, only a smaller limit than the card's shows
    it."""
    dxs, dys = _offsets(C=10, T=30, vx=0.5, vy=0.1)
    need = _staging(staging, dxs, dys)["smem_bytes"]
    monkeypatch.setattr(_build, "MAX_SMEM_BYTES", need - 1)
    with pytest.raises(ValueError, match="shared memory"):
        _staging(staging, dxs, dys)


def _kbmodv1_offsets(times):
    """Offsets of the main stack's grid (1,681 candidates) at ``times``."""
    cands = list(KBMODV1Search(41, 5.0, 45.0, 41, -0.5, 0.5))
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    return trajectory_offsets(vxs, vys, times)


def test_long_stacks_fit_and_shared_memory_does_not_grow():
    """At T = 2,000 on the 41 x 41 grid, times spread evenly over 15.03 days,
    every plan fits (the tables of all T steps alone would need 232,000
    bytes). Over the same windows, each of 128 times repeated to make 2,000
    steps, every plan needs what it needs at T = 128, K5's 32-bit field
    sums past 257 steps aside: only the windows set the buffers."""
    wide = 8 * 4 * 512 * 4
    times = np.linspace(0.0, 15.03, 128)
    short = _kbmodv1_offsets(times)
    repeated = _kbmodv1_offsets(np.sort(np.resize(times, 2000)))
    spread = _kbmodv1_offsets(np.linspace(0.0, 15.03, 2000))
    for name in ("k2", "k5", "k3-u16", "k3-u8"):
        a, b, c = _staging(name, *short), _staging(name, *repeated), _staging(name, *spread)
        assert b["smem_bytes"] - (wide if name == "k5" else 0) == a["smem_bytes"], name
        assert c["lay"].shape[1] == 2000 and c["smem_bytes"] <= _build.MAX_SMEM_BYTES, name


@pytest.mark.parametrize("staging", ["k2", "k5", "k3-u16", "k3-u8"])
def test_plans_raise_past_the_kernels_t_limit(staging):
    limit = {"k2": K2_MAX_T, "k5": K5_MAX_T, "k3-u16": K3_MAX_T[16], "k3-u8": K3_MAX_T[8]}[staging]
    assert limit == (32768 if staging == "k3-u16" else 65535)
    dxs = np.zeros((2, limit + 1), np.int32)
    with pytest.raises(ValueError, match="above the kernel"):
        _staging(staging, dxs, dxs)


@pytest.mark.parametrize("case", ["slabs", "box", "negative_origins"])
def test_k4_layout_batches_in_index_order(case):
    """K4 takes the candidates in index order, 8 a batch (C = 45: five full
    batches and one of 5), with no plan; its layout is the window layout of
    those batches (4 x 256 tile, chunks of 8 pairs, one extra column), and
    its shared memory the tables' header and two buffers of 2 bytes a pair.
    Replayed at three block positions, the last past the plane's right edge."""
    dxs, dys = _offsets(C=45, T=6, vx=200.0 if case == "slabs" else 0.5, vy=0.3 if case == "box" else 2.0)
    x_min, y_min = (-9, -4) if case == "negative_origins" else (0, 0)
    st = k4_staging(dxs, dys, x_min, y_min)
    assert np.array_equal(st["starts"], np.arange(0, 45, 8))
    assert st["lay"].shape == (6, 6, 5) and st["off"].shape == (6, 6, 8)
    lay, off, buf_elems = search_plan.window_layout(
        dxs + x_min, dys + y_min, st["starts"], tile_rows=K4_TILE_ROWS, tile_cols=K4_TILE_COLS, chunk=K4_CHUNK,
        extra=1)
    assert np.array_equal(lay, st["lay"]) and np.array_equal(off, st["off"]) and buf_elems == st["buf_elems"]
    assert st["smem_bytes"] == HEADER + 2 * 2 * buf_elems
    assert (st["off"][-1, :, 5:] == 0).all()  # the last batch holds 5
    if case == "slabs":
        assert (lay[..., 0] > 1).any()
    if case == "box":
        assert (lay[..., 0] == 1).all()
    ox, oy = dxs.astype(np.int64) + x_min, dys.astype(np.int64) + y_min
    plane = np.arange(1, 6 * 12 * 264 + 1, dtype=np.int64).reshape(6, 12, 264)
    for i0, col0 in ((0, 0), (4, 256), (8, 512)):
        _replay(plane, ox, oy, st["starts"], lay, off, K4_TILE_ROWS, K4_TILE_COLS, K4_CHUNK, 1, i0, col0, buf_elems)


def test_k4_layout_raises_past_257_steps():
    assert PAIRED_MAX_T == 257
    k4_staging(np.zeros((2, 257), np.int32), np.zeros((2, 257), np.int32), 0, 0)
    with pytest.raises(ValueError, match="above the kernel"):
        k4_staging(np.zeros((2, 258), np.int32), np.zeros((2, 258), np.int32), 0, 0)
