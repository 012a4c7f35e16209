"""K2: the float top-K search, as a CUDA kernel and its plain PyTorch twin.

``search_topk`` replaces the TPU kernel ``_search_kernel`` (the JAX
package's ops/search_pallas.py:182, entry ``search_topk_pallas``). On a CUDA
tensor it launches ``csrc/search_topk.cu``; on a CPU tensor it runs
``search_topk_shift``, the twin with the signature and (K, SH, SW) outputs
of the JAX package's ``search_topk_shift`` (ops/search.py:853). The twin
rank-inserts each candidate, in index order, at ``p = #(top >= new)``; the
kernel takes the candidates in groups (``search_plan.grouped_plan``) and
inserts by (lh desc, index asc), which is the same order, so exact
likelihood ties keep the lower candidate index either way. The kernel stages
each group's windows in shared memory (:func:`k2_staging` computes the
layout on the host); its source note says what bounds it and what the
design does about that.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops.search_plan import GROUP_G, grouped_plan, staging_header_bytes, window_layout_cached

FLT_MAX = float(np.finfo(np.float32).max)
# The kernel's block tile (rows, columns) and staging chunk in pixels
# (kb_search_topk_tile in csrc/search_topk.cu).
K2_TILE_ROWS, K2_TILE_COLS, K2_CHUNK = 4, 256, 16
# The kernel's most time steps: two rows' counts share a 32-bit register as
# 16-bit fields.
K2_MAX_T = 65535

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kb_search_topk": (
        [_P] * 10 + [_I] * 9 + [_F, _F, _I, _I, _I, _P, _P, _P],
        ctypes.c_int,
    ),
    "kb_search_topk_smem_bytes": ([_I], ctypes.c_size_t),
    "kb_search_topk_tile": ([_I], ctypes.c_int),
    "kb_search_topk_max_group": ([], ctypes.c_int),
    "kb_search_topk_blocks_per_sm": ([_I, _I], ctypes.c_int),
}


def _lib():
    return _build.load("search_topk", _SIGNATURES)


def search_topk_shift(
    psi, phi, valid, dxs, dys, min_obs, min_lh,
    *, x_min, x_max, y_min, y_max, k_results,
    gate_min_obs=True, gate_min_lh=False, has_masked=True,
    cand_valid=None, cand_offset=0,
):
    """Plain PyTorch twin of the K2 kernel.

    psi, phi: (T, H, W) float32 zero-filled at masked pixels; valid:
    (T, H, W) uint8; dxs, dys: (C, T) int32 offsets; ``cand_valid`` (C,)
    bool marks padding candidates False. Returns top_lh (K, SH, SW) float32
    (empty = -FLT_MAX) and top_idx (K, SH, SW) int32 (empty = -1), the
    global index being ``cand_offset + c``.
    """
    search_topk_shift.calls += 1
    dev = psi.device
    T, H, W = psi.shape
    SH, SW, K = y_max - y_min, x_max - x_min, int(k_results)
    oy = (dys.to(torch.int64) + int(y_min)).cpu().numpy()
    ox = (dxs.to(torch.int64) + int(x_min)).cpu().numpy()
    c_ok = (
        np.ones(len(ox), dtype=bool) if cand_valid is None
        else torch.as_tensor(cand_valid).cpu().numpy().astype(bool).reshape(-1)
    )
    min_obs = float(min_obs)
    min_lh = float(min_lh)
    top = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32, device=dev)
    topi = torch.full((K, SH, SW), -1, dtype=torch.int32, device=dev)
    kidx = torch.arange(K, device=dev)[:, None, None]
    neg_inf = torch.full((), float("-inf"), device=dev)
    for c in range(len(ox)):
        psi_s = torch.zeros((SH, SW), dtype=torch.float32, device=dev)
        phi_s = torch.zeros_like(psi_s)
        obs = torch.zeros_like(psi_s)
        for t in range(T):
            # Window rows i with 0 <= oy + i < H, columns j with 0 <= ox + j < W.
            i0, i1 = max(0, -oy[c, t]), min(SH, H - oy[c, t])
            j0, j1 = max(0, -ox[c, t]), min(SW, W - ox[c, t])
            if i0 >= i1 or j0 >= j1:
                continue
            rows = slice(oy[c, t] + i0, oy[c, t] + i1)
            cols = slice(ox[c, t] + j0, ox[c, t] + j1)
            ps, fs = psi[t, rows, cols], phi[t, rows, cols]
            if has_masked:
                ok = valid[t, rows, cols] != 0
                ps = torch.where(ok, ps, 0.0)
                fs = torch.where(ok, fs, 0.0)
                mf = ok.to(torch.float32)
            else:
                mf = torch.ones_like(ps)
            psi_s[i0:i1, j0:j1] += ps
            phi_s[i0:i1, j0:j1] += fs
            obs[i0:i1, j0:j1] += mf
        # IEEE float32 sqrt then division, as the kernel's __fsqrt_rn and
        # __fdiv_rn. The sqrt goes through float64 (exact when rounded back to
        # float32) because PyTorch's vectorized float32 sqrt on the CPU is not
        # always correctly rounded.
        lh = torch.where(phi_s > 0, psi_s / torch.sqrt(phi_s.double()).float(), -1.0)
        ok = torch.full((SH, SW), bool(c_ok[c]), device=dev)
        if gate_min_obs:
            ok &= obs >= min_obs
        if gate_min_lh:
            ok &= lh >= min_lh
        new = torch.where(ok, lh, neg_inf)
        # Rank-insert at p = #(top >= new); slots below p shift down one.
        p = (top >= new[None]).sum(dim=0)[None]
        shifted = torch.cat([top[:1], top[:-1]])
        shiftedi = torch.cat([topi[:1], topi[:-1]])
        at_p, below = kidx == p, kidx > p
        top = torch.where(at_p, new[None], torch.where(below, shifted, top))
        topi = torch.where(at_p, int(cand_offset) + c, torch.where(below, shiftedi, topi))
    return top, topi.to(torch.int32)


search_topk_shift.calls = 0


def allocate_maps(K, SH, SW, device, name):
    """The (K, SH, SW) float32 lh and int32 index maps of a search on
    ``device``, or a ValueError that names their size when the card cannot
    hold them. The search kernels keep a list of up to 64 in registers and a
    longer one in the maps themselves, so the maps' memory is their only
    limit on K."""
    try:
        return (torch.empty((K, SH, SW), dtype=torch.float32, device=device),
                torch.empty((K, SH, SW), dtype=torch.int32, device=device))
    except torch.cuda.OutOfMemoryError as err:
        need = 8 * int(K) * int(SH) * int(SW)
        raise ValueError(
            f"{name}: the (K={K}, {SH}, {SW}) top-K maps need {need} bytes ({need / 2**30:.2f} GiB), "
            f"more than {device} can hold"
        ) from err


def k2_staging(dxs, dys, x_min, y_min):
    """The K2 kernel's host plan for (C, T) offsets: the grouping plan, the
    window layout of its staged windows and the shared memory it needs.

    Returns a dict with ``order`` (C,) and ``starts`` (NG,) (group g holds
    ``order[starts[g]:starts[g + 1]]``, 1..8 candidates), ``lay`` (NG, T,
    5) and ``off`` (NG, T, 8) (``search_plan.window_layout``),
    ``buf_elems`` (pixels of one staging buffer) and ``smem_bytes`` (the
    header of offsets and layout, which does not grow with T, plus two
    buffers of 9 bytes a pixel: psi, phi and validity). Raises ValueError
    past the kernel's T limit or when the windows exceed a block's shared
    memory.
    """
    dxs = np.asarray(dxs, dtype=np.int64)
    dys = np.asarray(dys, dtype=np.int64)
    C, T = dys.shape
    if T > K2_MAX_T:
        raise ValueError(f"search_topk: T={T} above the kernel's {K2_MAX_T}")
    (order, starts), _ = grouped_plan(dys)
    lay, off, buf_elems = window_layout_cached(
        dxs[order] + int(x_min), dys[order] + int(y_min), starts,
        tile_rows=K2_TILE_ROWS, tile_cols=K2_TILE_COLS, chunk=K2_CHUNK,
    )
    smem = staging_header_bytes() + 2 * 9 * buf_elems
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"search_topk: T={T} windows need {smem} bytes of shared memory")
    return dict(order=order, starts=starts, lay=lay, off=off, buf_elems=buf_elems, smem_bytes=smem)


def _padded_planes(psi, phi, valid, has_masked):
    """psi, phi (and valid) with rows padded with zeros to a multiple of
    16 pixels and 16-byte aligned, as the kernel's 16-byte copies need;
    unchanged where they already are."""
    W = psi.shape[2]
    Wp = -(-W // K2_CHUNK) * K2_CHUNK
    planes = [psi, phi] + ([valid] if has_masked else [])
    out = []
    for p in planes:
        p = p.contiguous()
        if Wp != W:
            p = F.pad(p, (0, Wp - W))
        elif p.data_ptr() % 16:
            p = p.clone()
        out.append(p)
    if not has_masked:
        out.append(out[0])  # not read
    return out, Wp


def search_topk(
    psi, phi, valid, dxs, dys, min_obs, min_lh,
    *, x_min, x_max, y_min, y_max, k_results,
    gate_min_obs=True, gate_min_lh=False, has_masked=True,
    cand_valid=None, cand_offset=0,
):
    """Per-pixel top-K shift-and-stack search (see search_topk_shift for the
    function and the arguments).

    CUDA tensors launch the kernel and raise if it cannot (for example when
    the (K, SH, SW) maps do not fit the card's memory); CPU tensors take the
    plain twin.
    """
    if psi.device.type == "cpu":
        return search_topk_shift(
            psi, phi, valid, dxs, dys, min_obs, min_lh,
            x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max, k_results=k_results,
            gate_min_obs=gate_min_obs, gate_min_lh=gate_min_lh, has_masked=has_masked,
            cand_valid=cand_valid, cand_offset=cand_offset,
        )
    dev = psi.device
    if dev.type != "cuda":
        raise ValueError(f"search_topk: unsupported device {dev}")
    T, H, W = psi.shape
    C = dxs.shape[0]
    SH, SW, K = int(y_max - y_min), int(x_max - x_min), int(k_results)
    if K < 1:
        raise ValueError(f"search_topk: k_results={K} must be at least 1")
    if SH <= 0 or SW <= 0:
        raise ValueError(f"search_topk: empty search window {SH}x{SW}")
    if phi.shape != psi.shape or (has_masked and valid.shape != psi.shape):
        raise ValueError("search_topk: psi, phi and valid must share one (T, H, W) shape")
    if tuple(dxs.shape) != (C, T) or tuple(dys.shape) != (C, T):
        raise ValueError(f"search_topk: offsets must be (C, T) = ({C}, {T})")
    if psi.dtype != torch.float32 or phi.dtype != torch.float32:
        raise ValueError("search_topk: psi and phi must be float32")
    top_lh, top_idx = allocate_maps(K, SH, SW, dev, "search_topk")
    if C == 0:
        top_lh.fill_(-FLT_MAX)
        top_idx.fill_(-1)
        return top_lh, top_idx
    dx_np = torch.as_tensor(dxs).cpu().numpy()
    dy_np = torch.as_tensor(dys).cpu().numpy()
    st = k2_staging(dx_np, dy_np, x_min, y_min)
    lib = _lib()
    tile = tuple(lib.kb_search_topk_tile(a) for a in range(3))
    if (tile != (K2_TILE_ROWS, K2_TILE_COLS, K2_CHUNK) or lib.kb_search_topk_max_group() != GROUP_G
            or st["smem_bytes"] != lib.kb_search_topk_smem_bytes(st["buf_elems"])):
        raise RuntimeError("search_topk: host and kernel disagree on the tile, group or shared-memory layout")
    (psi_p, phi_p, valid_p), Wp = _padded_planes(
        psi, phi, valid.to(device=dev, dtype=torch.uint8) if has_masked else None, has_masked)
    order = st["order"]
    ox = torch.as_tensor((dx_np[order] + int(x_min)).astype(np.int32), device=dev)
    oy = torch.as_tensor((dy_np[order] + int(y_min)).astype(np.int32), device=dev)
    order_t = torch.as_tensor(order.astype(np.int64), device=dev)
    gidx = (order_t.to(torch.int32) + int(cand_offset)).contiguous()
    if cand_valid is None:
        cand_ok = torch.ones(C, dtype=torch.uint8, device=dev)
    else:
        cand_ok = torch.as_tensor(cand_valid, device=dev).reshape(C).to(torch.uint8)[order_t].contiguous()
    gstart = torch.as_tensor(np.append(st["starts"], C).astype(np.int32), device=dev)
    lay = torch.as_tensor(st["lay"], device=dev)
    off = torch.as_tensor(st["off"], device=dev)
    with torch.profiler.record_function("kbmod K2 search_topk"):
        err = lib.kb_search_topk(
            psi_p.data_ptr(), phi_p.data_ptr(), valid_p.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            gidx.data_ptr(), cand_ok.data_ptr(), gstart.data_ptr(), lay.data_ptr(), off.data_ptr(),
            len(st["starts"]), T, H, W, Wp, SH, SW, K, st["buf_elems"],
            float(min_obs), float(min_lh), int(bool(gate_min_obs)), int(bool(gate_min_lh)),
            int(bool(has_masked)), top_lh.data_ptr(), top_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "search_topk")
    search_topk.launches += 1
    return top_lh, top_idx


search_topk.launches = 0
