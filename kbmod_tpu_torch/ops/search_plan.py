"""Host plans for the encoded search: offset-class dedup and candidate
grouping.

Port of the JAX package's plan code (ops/search_pallas.py:1254-1387 and
:2533-2651). The plans are numpy on the host, where the (C, T) offset tables
are made; the expansion of deduplicated top-K maps back to candidates runs
in PyTorch on the maps' device.

- :func:`_dedup_plan` collapses candidates whose rounded offset sequences
  are identical into offset classes, numbered by first occurrence, so each
  class is searched once; :func:`_expand_topk_classes` expands the class
  maps back, bit-exact, ties included.
- :func:`_plan_groups` sorts candidates by their last-time row offset and
  packs consecutive ones into groups of at most G whose per-time rows lie
  within S of each other; :func:`_plan_groups_uniform` groups candidates
  whose per-time rows are identical; :func:`grouped_plan` picks between
  them. Kernels K2, K3 and K5 search a group at a time.
- :func:`window_layout` lays out, for the grouped kernels, the windows a
  block stages in shared memory for each (group, time step).
"""

import hashlib

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)
# Group size and row spread of the grouped kernels' plan (K2, K3, K5).
GROUP_G = 8
GROUP_S = 8
# Time steps of a group's tables a grouped kernel holds in shared memory at
# once (kb_stage::kRows in csrc/stage_window.cuh).
STAGE_ROWS = 64

_DEDUP_CACHE = {}
_PLAN_CACHE = {}
_LAYOUT_CACHE = {}


def _content_key(*arrays):
    return tuple((hashlib.sha1(np.ascontiguousarray(a)).hexdigest(), a.shape, str(a.dtype)) for a in arrays)


def _cache_put(cache, key, value, max_entries):
    if len(cache) >= max_entries:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def _dedup_plan_cached(dxs_np, dys_np, min_factor, max_entries=8):
    """Content-keyed cache around :func:`_dedup_plan`: repeated searches
    over one grid plan once."""
    key = _content_key(dxs_np, dys_np) + (float(min_factor),)
    if key in _DEDUP_CACHE:
        return _DEDUP_CACHE[key]
    return _cache_put(_DEDUP_CACHE, key, _dedup_plan(dxs_np, dys_np, min_factor), max_entries)


def _dedup_plan(dxs_np, dys_np, min_factor):
    """Collapse candidates whose pixel-offset sequences are identical into
    offset classes. Scoring depends on the offsets alone, so each class is
    searched once and the maps expanded afterwards.

    Returns ``None`` when C / n_classes < min_factor, else
    ``(u_dxs, u_dys, members, counts)`` with classes ordered by FIRST
    OCCURRENCE (so a tie ordered by class index is ordered by each class's
    smallest candidate index); ``members`` is (n_classes, max_count) int32,
    -1 padded, each row the class's candidate indices ascending.
    """
    C, T = dys_np.shape
    dd = np.concatenate(
        [dxs_np.astype(np.int32, copy=False), dys_np.astype(np.int32, copy=False)],
        axis=1,
    )
    _, first_idx, inv = np.unique(dd, axis=0, return_index=True, return_inverse=True)
    n = len(first_idx)
    if n == C or C < min_factor * n:
        return None
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    cls = rank[inv.reshape(-1)]  # per-candidate class id, first-occurrence order
    counts = np.bincount(cls, minlength=n).astype(np.int32)
    members = np.full((n, int(counts.max())), -1, dtype=np.int32)
    by_cls = np.argsort(cls, kind="stable")  # class-major, index-ascending
    starts = np.cumsum(counts) - counts
    cols = np.arange(C) - starts[cls[by_cls]]
    members[cls[by_cls], cols] = by_cls
    reps = first_idx[order]
    return (
        np.ascontiguousarray(dxs_np[reps]),
        np.ascontiguousarray(dys_np[reps]),
        members,
        counts,
    )


def _expand_topk_classes(top_lh, top_idx, members, row_band=None):
    """Expand per-pixel top-K OFFSET-CLASS maps into top-K candidate maps
    (the inverse of :func:`_dedup_plan`). Bit-exact, ties included.

    Each class slot (lh, class) expands to the class's members, all with
    its lh, in ascending index order; the merged per-pixel list is sorted by
    (lh desc, index asc) and cut back to K. A candidate of a class outside
    the K kept classes cannot belong to the top K: each kept class has a
    member ahead of it (higher lh, or equal lh and a smaller index, by the
    first-occurrence numbering). Likewise a class's (K+1)-th member trails
    K of its own, so each class contributes at most K members.
    """
    K, SH, SW = top_lh.shape
    dev = top_lh.device
    n = members.shape[0]
    Km = min(members.shape[1], K)
    # Class -1 (an empty slot) indexes the sentinel last row: no members.
    members_t = torch.as_tensor(
        np.concatenate([members[:, :Km], np.full((1, Km), -1, np.int32)]), device=dev
    ).to(torch.int64)
    int_max = int(np.iinfo(np.int32).max)
    # Bands of rows keep each dense (K*Km, rows*SW) intermediate near 2^24
    # elements.
    if row_band is None:
        row_band = max(8, (1 << 24) // max(K * Km * SW, 1))
    out_lh, out_idx = [], []
    for y0 in range(0, SH, row_band):
        rows = top_lh[:, y0 : y0 + row_band].shape[1]
        lh = top_lh[:, y0 : y0 + row_band].reshape(K, 1, -1)
        idx = top_idx[:, y0 : y0 + row_band].reshape(K, -1).to(torch.int64)
        mem = members_t[torch.where(idx >= 0, idx, n)]  # (K, P, Km)
        mem = mem.permute(0, 2, 1)  # (K, Km, P)
        exp_lh = torch.where(mem >= 0, lh, -FLT_MAX).reshape(K * Km, -1)
        key_idx = torch.where(mem >= 0, mem, int_max).reshape(K * Km, -1)
        # (lh desc, index asc): sort by index, then stably by lh (-0.0 and
        # +0.0 tie, as in the JAX package's two-key sort).
        by_idx = torch.argsort(key_idx, dim=0, stable=True)
        exp_lh = torch.gather(exp_lh, 0, by_idx)
        key_idx = torch.gather(key_idx, 0, by_idx)
        by_lh = torch.argsort(-exp_lh, dim=0, stable=True)[:K]
        out_lh.append(torch.gather(exp_lh, 0, by_lh).reshape(K, rows, SW))
        sel = torch.gather(key_idx, 0, by_lh)
        out_idx.append(torch.where(sel == int_max, -1, sel).to(torch.int32).reshape(K, rows, SW))
    return torch.cat(out_lh, dim=1), torch.cat(out_idx, dim=1)


def _plan_groups(dys_np, G, S):
    """Sort candidates by net row motion and pack consecutive candidates
    into groups of <= G whose per-time row spread is <= S.

    Returns ``(order, starts)``: ``order`` is the (C,) processing
    permutation; ``starts`` the first slot of each group within it.
    """
    dys_np = np.asarray(dys_np)
    C, T = dys_np.shape
    key = dys_np[:, -1]
    order = np.argsort(key, kind="stable").astype(np.int32)
    d_last = key[order]
    # Greedy pass on the last-time offsets: for linear trajectories the
    # spread at any t is bounded by the last-time spread + 2 (floor
    # jitter), so a last-time bound of S-2 guarantees S overall.
    bound = max(int(S) - 2, 0)
    starts = [0]
    for i in range(1, C):
        if i - starts[-1] >= G or d_last[i] - d_last[starts[-1]] > bound:
            starts.append(i)
    starts = np.asarray(starts, dtype=np.int64)
    # Exact verification over every time step (arbitrary dys inputs need
    # not be linear): split any violating group into singletons.
    d = dys_np[order]
    gmin = np.minimum.reduceat(d, starts, axis=0)
    gmax = np.maximum.reduceat(d, starts, axis=0)
    bad = (gmax - gmin).max(axis=1) > S
    if bad.any():
        ends = np.append(starts[1:], C)
        new_starts = []
        for gi in range(len(starts)):
            if bad[gi]:
                new_starts.extend(range(int(starts[gi]), int(ends[gi])))
            else:
                new_starts.append(int(starts[gi]))
        starts = np.asarray(new_starts, dtype=np.int64)
    return order, starts


def _plan_groups_uniform(dys_np, G):
    """Group candidates whose per-time row offsets are IDENTICAL (row
    classes); groups never span two classes. Survey grids (velocity x angle
    lattices) collapse to a few hundred row sequences, so nearly every group
    is full, and a group's rows spread by 0.

    Returns ``(order, starts)`` like :func:`_plan_groups`.
    """
    dys_np = np.ascontiguousarray(np.asarray(dys_np, dtype=np.int32))
    C, T = dys_np.shape
    view = dys_np.view([("", dys_np.dtype)] * T).reshape(C)
    _, inv = np.unique(view, return_inverse=True)
    # A stable sort keeps a class's candidates in ascending index order.
    order = np.argsort(inv, kind="stable").astype(np.int32)
    cls_sorted = inv[order]
    cls_starts = np.flatnonzero(np.r_[True, cls_sorted[1:] != cls_sorted[:-1]])
    cls_ends = np.append(cls_starts[1:], C)
    starts = np.concatenate(
        [np.arange(int(s), int(e), int(G)) for s, e in zip(cls_starts, cls_ends)]
    )
    return order, starts.astype(np.int64)


def _plan_groups_cached(dys_np, G, S, max_entries=8, uniform=False):
    """Content-keyed cache around :func:`_plan_groups` /
    :func:`_plan_groups_uniform`: repeated searches over one grid pay the
    O(C log C) sort and the spread check once."""
    dys_np = np.ascontiguousarray(dys_np)
    key = _content_key(dys_np) + (int(G), int(S), bool(uniform))
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        plan = _plan_groups_uniform(dys_np, G) if uniform else _plan_groups(dys_np, G, S)
        hit = _cache_put(_PLAN_CACHE, key, plan, max_entries)
    return hit


def grouped_plan(dys_np, G=GROUP_G, S=GROUP_S):
    """The grouping plan of the grouped kernels (K2, K3, K5) and whether it
    fills.

    The spread plan fills when its slots (groups x G) stay within max(1.6 C,
    C + 4 G), i.e. its groups are mostly full. Where the uniform plan
    (members share every row, so a group's window is no taller than the
    tile) costs at most max(1.25x, +2 G) the spread plan's slots, it is
    taken instead, the JAX package's rule (ops/search_pallas.py:2113-2117,
    :2713-2738) at its G = 8. Returns ((order, starts), fills)."""
    dys_np = np.asarray(dys_np, dtype=np.int32)
    plan = _plan_groups_cached(dys_np, G, S)
    C, slots = dys_np.shape[0], len(plan[1]) * G
    fills = slots <= max(1.6 * C, C + 4 * G)
    uniform = _plan_groups_cached(dys_np, G, 0, uniform=True)
    if len(uniform[1]) * G <= max(1.25 * slots, slots + 2 * G):
        plan = uniform
    return plan, fills


def _round_up(x, m):
    return -(-x // m) * m


def staging_header_bytes():
    """Shared memory a grouped kernel (K2, K3, K5) keeps for a group's
    tables: its offsets (2 G ints a step), layout rows (5) and member
    offsets (G) for STAGE_ROWS time steps at a time, rounded up to 16
    bytes. It does not depend on T: the kernels reload the tables as the
    steps go by (csrc/stage_window.cuh)."""
    return _round_up((3 * GROUP_G + 5) * STAGE_ROWS * 4, 16)


def window_layout_cached(ox, oy, starts, max_entries=8, **kw):
    """Content-keyed cache around :func:`window_layout`: repeated searches
    over one grid lay out their windows once."""
    ox, oy, starts = (np.ascontiguousarray(a, dtype=np.int64) for a in (ox, oy, starts))
    key = _content_key(ox, oy, starts) + tuple(sorted(kw.items()))
    hit = _LAYOUT_CACHE.get(key)
    if hit is None:
        hit = _cache_put(_LAYOUT_CACHE, key, window_layout(ox, oy, starts, **kw), max_entries)
    return hit


def window_layout(ox, oy, starts, *, tile_rows, tile_cols, chunk, extra=0, G=GROUP_G):
    """Shared-memory layout of a grouped kernel's staged windows
    (csrc/stage_window.cuh).

    ox, oy: (C, T) window-origin offsets (x_min + dx, y_min + dy) in plan
    order; ``starts`` the groups' first slots. A block owns a tile of
    ``tile_rows`` x ``tile_cols`` pixels at a column that is a multiple of
    ``chunk``; a member's window is the tile moved by its offsets, plus
    ``extra`` columns on the right. For each (group, t) the kernel stages
    either one box that covers every member's window, or one slab per
    member (its own window, its column rounded down to the chunk), whichever
    holds fewer pixels.

    Returns (lay, off, buf_elems): lay (NG, T, 5) int32 rows (nslab, rows,
    pitch, y, x); off (NG, T, G) int32, each member's window origin in
    pixels within the buffer (0 past the group's size); buf_elems, the
    largest step's pixel count, the size of one staging buffer.
    """
    ox = np.asarray(ox, dtype=np.int64)
    oy = np.asarray(oy, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    C, T = ox.shape
    NG = len(starts)
    n = np.diff(np.append(starts, C))
    xmin, xmax = np.minimum.reduceat(ox, starts), np.maximum.reduceat(ox, starts)
    ymin, ymax = np.minimum.reduceat(oy, starts), np.maximum.reduceat(oy, starts)
    xlo = xmin & ~(chunk - 1)
    box_rows = tile_rows + ymax - ymin
    box_pitch = _round_up(xmax + tile_cols + extra - xlo, chunk)
    mem_pitch = _round_up(tile_cols + extra + chunk - 1, chunk)
    box = box_rows * box_pitch <= n[:, None] * tile_rows * mem_pitch
    lay = np.stack(
        [
            np.where(box, 1, n[:, None]),
            np.where(box, box_rows, tile_rows),
            np.where(box, box_pitch, mem_pitch),
            ymin,
            xlo,
        ],
        axis=-1,
    )
    grp = np.repeat(np.arange(NG), n)
    member = np.arange(C) - starts[grp]
    off_box = (oy - ymin[grp]) * box_pitch[grp] + (ox - xlo[grp])
    off_mem = member[:, None] * tile_rows * mem_pitch + (ox & (chunk - 1))
    off = np.zeros((NG, T, G), dtype=np.int64)
    off[grp[:, None], np.arange(T)[None, :], member[:, None]] = np.where(box[grp], off_box, off_mem)
    buf_elems = int((lay[..., 0] * lay[..., 1] * lay[..., 2]).max())
    if np.abs(lay).max() >= 2**31 or off.max() >= 2**31:
        raise ValueError("window_layout: offsets beyond int32")
    return lay.astype(np.int32), off.astype(np.int32), buf_elems
