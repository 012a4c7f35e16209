"""K3, K4 and K5: the top-K search over quantized code planes, as CUDA
kernels and their one plain PyTorch twin.

The three TPU kernels compute one function, K2's top-K search with psi and
phi stored as uint8/uint16 codes (0 = masked): for every window pixel and
candidate, the integer codes are summed over t where BOTH codes of a sample
are non-zero (the JAX package's ops/search.py:794, search_pallas.py:631),
and decoded once, ``psi = scale * sum + (min - scale) * obs`` (each product
and the sum rounded on their own, in that order), then ranked as K2 ranks.

- ``search_encoded`` replaces ``_search_kernel_encoded`` (K3,
  kbmod_tpu/ops/search_pallas.py:505): uint16 codes, and uint8 codes that
  the other two do not take. CUDA source ``csrc/search_topk_encoded.cu``.
- ``search_paired`` replaces ``_search_kernel_paired`` (K4, :916): uint8
  codes with T <= 257, two output columns per thread summed as the two
  16-bit fields of one 32-bit register. Same source.
- ``search_grouped`` replaces ``_search_kernel_paired_grouped`` (K5,
  :1493): uint8 codes, any T, candidates in groups whose rows lie close
  together (``ops/search_plan.py``), one shared-memory window per group and
  time step serving the group. CUDA source ``csrc/search_topk_grouped.cu``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs ``search_topk_encoded_shift``, the twin. Exact likelihood ties rank
by ascending global candidate index whatever order the candidates arrive in
(K5 and the twin compare (lh, index) explicitly; K3 and K4 see candidates in
index order).
"""

import ctypes

import numpy as np
import torch

from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops.psi_phi import _codes_as_int, _f32, interleave_code_pairs
from kbmod_tpu_torch.ops.search_kernel import FLT_MAX, MAX_K, _stage_candidates

# uint8 code sums fit a 16-bit field while T * 255 <= 65535.
PAIRED_MAX_T = 257

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENC_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P]
_ENC_SIGNATURES = {
    "kb_search_encoded": ([_I] + _ENC_ARGS, ctypes.c_int),
    "kb_search_paired": (_ENC_ARGS, ctypes.c_int),
    "kb_search_encoded_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "kb_search_encoded_cand_batch": ([], ctypes.c_int),
}
_GRP_SIGNATURES = {
    "kb_search_grouped": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I,
         _P, _P, _P],
        ctypes.c_int,
    ),
    "kb_search_grouped_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "kb_search_grouped_tile": ([_I], ctypes.c_int),
    "kb_search_grouped_max_group": ([], ctypes.c_int),
}


def search_topk_encoded_shift(
    psi_codes, phi_codes, dxs, dys, min_obs, min_lh, em,
    *, x_min, x_max, y_min, y_max, k_results,
    gate_min_obs=True, gate_min_lh=False, cand_valid=None, cand_offset=0,
):
    """Plain PyTorch twin of K3, K4 and K5.

    psi_codes, phi_codes: (T, H, W) uint8/uint16 codes; dxs, dys: (C, T)
    int offsets; em: [psi_min, psi_scale, phi_min, phi_scale] (float32);
    ``cand_valid`` (C,) bool marks padding candidates False. Candidates are
    ranked by (lh desc, global index asc). Returns top_lh
    (K, SH, SW) float32 (empty = -FLT_MAX) and top_idx (K, SH, SW) int32
    (empty = -1), the global index being ``cand_offset + c``.
    """
    search_topk_encoded_shift.calls += 1
    dev = psi_codes.device
    T, H, W = psi_codes.shape
    SH, SW, K = y_max - y_min, x_max - x_min, int(k_results)
    oy = (torch.as_tensor(dys).to(torch.int64) + int(y_min)).cpu().numpy()
    ox = (torch.as_tensor(dxs).to(torch.int64) + int(x_min)).cpu().numpy()
    C = len(ox)
    c_ok = (
        np.ones(C, dtype=bool) if cand_valid is None
        else torch.as_tensor(cand_valid).cpu().numpy().astype(bool).reshape(-1)
    )
    # A sample counts only where both codes are non-zero.
    pc, fc = _codes_as_int(psi_codes), _codes_as_int(phi_codes)
    both = (pc > 0) & (fc > 0)
    pc = torch.where(both, pc, 0)
    fc = torch.where(both, fc, 0)
    ob = both.to(torch.int32)
    em = np.asarray(em, dtype=np.float32).reshape(4)
    s_psi, d_psi = _f32(em[1], dev), _f32(em[0] - em[1], dev)
    s_phi, d_phi = _f32(em[3], dev), _f32(em[2] - em[3], dev)
    min_obs, min_lh = float(min_obs), float(min_lh)
    top = torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32, device=dev)
    topi = torch.full((K, SH, SW), -1, dtype=torch.int32, device=dev)
    kidx = torch.arange(K, device=dev)[:, None, None]
    neg_inf = torch.full((), float("-inf"), device=dev)
    for c in range(C):
        sp = torch.zeros((SH, SW), dtype=torch.int32, device=dev)
        sf = torch.zeros_like(sp)
        so = torch.zeros_like(sp)
        for t in range(T):
            # Window rows i with 0 <= oy + i < H, columns j with 0 <= ox + j < W.
            i0, i1 = max(0, -oy[c, t]), min(SH, H - oy[c, t])
            j0, j1 = max(0, -ox[c, t]), min(SW, W - ox[c, t])
            if i0 >= i1 or j0 >= j1:
                continue
            rows = slice(oy[c, t] + i0, oy[c, t] + i1)
            cols = slice(ox[c, t] + j0, ox[c, t] + j1)
            sp[i0:i1, j0:j1] += pc[t, rows, cols]
            sf[i0:i1, j0:j1] += fc[t, rows, cols]
            so[i0:i1, j0:j1] += ob[t, rows, cols]
        obs = so.to(torch.float32)
        psi_s = s_psi * sp.to(torch.float32) + d_psi * obs
        phi_s = s_phi * sf.to(torch.float32) + d_phi * obs
        # IEEE sqrt (through float64, exact once rounded back) and division,
        # as the kernels' __fsqrt_rn and __fdiv_rn.
        lh = torch.where(phi_s > 0, psi_s / torch.sqrt(phi_s.double()).float(), -1.0)
        ok = torch.full((SH, SW), bool(c_ok[c]), device=dev)
        if gate_min_obs:
            ok &= obs >= min_obs
        if gate_min_lh:
            ok &= lh >= min_lh
        new = torch.where(ok, lh, neg_inf)[None]
        newi = int(cand_offset) + int(c)
        # Rank-insert below every entry that is better, or equal with a
        # smaller index; slots below the insertion point shift down one.
        p = ((top > new) | ((top == new) & (topi < newi))).sum(dim=0)[None]
        shifted = torch.cat([top[:1], top[:-1]])
        shiftedi = torch.cat([topi[:1], topi[:-1]])
        at_p, below = kidx == p, kidx > p
        top = torch.where(at_p, new, torch.where(below, shifted, top))
        topi = torch.where(at_p, newi, torch.where(below, shiftedi, topi))
    return top, topi.to(torch.int32)


search_topk_encoded_shift.calls = 0


def _twin(planes, dxs, dys, min_obs, min_lh, kw):
    return search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, dxs, dys, min_obs, min_lh, planes.em, **kw)


def _pairs(planes):
    return planes.pairs if planes.pairs is not None else interleave_code_pairs(planes.psi_codes, planes.phi_codes)


def _prepare(planes, dxs, dys, kw, name):
    """Checks shared by the wrappers, and the device tensors they launch
    with: (pairs, ox, oy, cand_ok, em, sizes)."""
    dev = planes.psi_codes.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    T, H, W = planes.shape
    C = int(dxs.shape[0])
    SH, SW, K = int(kw["y_max"] - kw["y_min"]), int(kw["x_max"] - kw["x_min"]), int(kw["k_results"])
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name}: k_results={K} outside the kernel's 1..{MAX_K}")
    if SH <= 0 or SW <= 0:
        raise ValueError(f"{name}: empty search window {SH}x{SW}")
    if tuple(dxs.shape) != (C, T) or tuple(dys.shape) != (C, T):
        raise ValueError(f"{name}: offsets must be (C, T) = ({C}, {T})")
    if planes.psi_codes.dtype not in (torch.uint8, torch.uint16) or planes.phi_codes.shape != planes.psi_codes.shape:
        raise ValueError(f"{name}: psi and phi must be (T, H, W) uint8 or uint16 codes")
    pairs = _pairs(planes)
    Wp = int(pairs.shape[2])
    if tuple(pairs.shape) != (T, H, Wp, 2) or Wp % 8 or Wp < W or not pairs.is_contiguous():
        raise ValueError(f"{name}: code pairs must be a contiguous (T, H, Wp, 2) tensor, Wp a multiple of 8")
    ox = (torch.as_tensor(dxs, device=dev).to(torch.int32) + int(kw["x_min"])).contiguous()
    oy = (torch.as_tensor(dys, device=dev).to(torch.int32) + int(kw["y_min"])).contiguous()
    cand_valid = kw.get("cand_valid")
    if cand_valid is None:
        cand_ok = torch.ones(C, dtype=torch.uint8, device=dev)
    else:
        cand_ok = torch.as_tensor(cand_valid, device=dev).reshape(C).to(torch.uint8).contiguous()
    em = [float(v) for v in np.asarray(planes.em, dtype=np.float32).reshape(4)]
    return pairs, ox, oy, cand_ok, em, (C, T, H, W, Wp, SH, SW, K)


def _gate_args(min_obs, min_lh, kw):
    return float(min_obs), float(min_lh), int(bool(kw.get("gate_min_obs", True))), int(bool(kw.get("gate_min_lh", False)))


def _empty(K, SH, SW, dev):
    return (torch.full((K, SH, SW), -FLT_MAX, dtype=torch.float32, device=dev),
            torch.full((K, SH, SW), -1, dtype=torch.int32, device=dev))


def _launch_per_candidate(entry, planes, dxs, dys, min_obs, min_lh, kw, name, extra=()):
    pairs, ox, oy, cand_ok, em, (C, T, H, W, Wp, SH, SW, K) = _prepare(planes, dxs, dys, kw, name)
    dev = pairs.device
    if C == 0:
        return _empty(K, SH, SW, dev)
    lib = _build.load("search_topk_encoded", _ENC_SIGNATURES)
    cs = _stage_candidates(C, T, lib.kb_search_encoded_cand_batch())
    if lib.kb_search_encoded_smem_bytes(cs, T) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: T={T} offsets do not fit one block's shared memory")
    top_lh = torch.empty((K, SH, SW), dtype=torch.float32, device=dev)
    top_idx = torch.empty((K, SH, SW), dtype=torch.int32, device=dev)
    err = getattr(lib, entry)(
        *extra, pairs.data_ptr(), ox.data_ptr(), oy.data_ptr(), cand_ok.data_ptr(),
        C, T, H, W, Wp, SH, SW, K, cs, int(kw.get("cand_offset", 0)), *em,
        *_gate_args(min_obs, min_lh, kw), top_lh.data_ptr(), top_idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, name)
    return top_lh, top_idx


def search_encoded(planes, dxs, dys, min_obs, min_lh, **kw):
    """K3: the per-candidate encoded search over uint8 or uint16 codes.

    ``planes`` is an ``EncodedPlanes`` (ops/search.py); dxs, dys (C, T)
    int offsets; keywords as ``search_topk_encoded_shift`` takes them.
    CUDA tensors launch the kernel and raise if it cannot; CPU tensors take
    the twin."""
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    bits = 16 if planes.psi_codes.dtype == torch.uint16 else 8
    out = _launch_per_candidate("kb_search_encoded", planes, dxs, dys, min_obs, min_lh, kw, "search_encoded", (bits,))
    search_encoded.launches += 1
    return out


search_encoded.launches = 0


def search_paired(planes, dxs, dys, min_obs, min_lh, **kw):
    """K4: the uint8 search with two columns summed per 32-bit add, for
    T <= 257 (arguments as :func:`search_encoded`)."""
    T = planes.shape[0]
    if planes.psi_codes.dtype != torch.uint8 or T > PAIRED_MAX_T:
        raise ValueError(f"search_paired: needs uint8 codes and T <= {PAIRED_MAX_T}, got {planes.psi_codes.dtype}, T={T}")
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    out = _launch_per_candidate("kb_search_paired", planes, dxs, dys, min_obs, min_lh, kw, "search_paired")
    search_paired.launches += 1
    return out


search_paired.launches = 0


def search_grouped(planes, dxs, dys, min_obs, min_lh, *, plan, **kw):
    """K5: the uint8 search over candidate groups.

    ``plan`` is ``(order, starts)`` from ``ops/search_plan.py``: group g
    holds the candidates ``order[starts[g]:starts[g + 1]]`` (at most 8),
    taken in that order. Other arguments as :func:`search_encoded`. Exact
    ties still rank by ascending index, so the result is the twin's, which
    the CPU runs."""
    order, starts = (np.asarray(a, dtype=np.int64) for a in plan)
    if planes.psi_codes.dtype != torch.uint8:
        raise ValueError(f"search_grouped: needs uint8 codes, got {planes.psi_codes.dtype}")
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    pairs, ox, oy, cand_ok, em, (C, T, H, W, Wp, SH, SW, K) = _prepare(planes, dxs, dys, kw, "search_grouped")
    dev = pairs.device
    if C == 0:
        return _empty(K, SH, SW, dev)
    bounds = np.append(starts, C)
    lib = _build.load("search_topk_grouped", _GRP_SIGNATURES)
    G = lib.kb_search_grouped_max_group()
    if len(order) != C or starts[0] != 0 or (np.diff(bounds) <= 0).any() or np.diff(bounds).max() > G:
        raise ValueError(f"search_grouped: the plan must split all {C} candidates into groups of 1..{G}")
    # Shared memory: the group's offsets and, per time step, the box of code
    # pairs that covers every member's window: the row tile plus the group's
    # row spread, by the column tile plus its column spread, within the image.
    order_t = torch.as_tensor(order, device=dev)
    ox, oy = ox[order_t].contiguous(), oy[order_t].contiguous()
    dx_np = np.asarray(torch.as_tensor(dxs).cpu(), dtype=np.int64)[order]
    dy_np = np.asarray(torch.as_tensor(dys).cpu(), dtype=np.int64)[order]
    row_spread = int((np.maximum.reduceat(dy_np, starts) - np.minimum.reduceat(dy_np, starts)).max())
    col_spread = int((np.maximum.reduceat(dx_np, starts) - np.minimum.reduceat(dx_np, starts)).max())
    box_rows = min(lib.kb_search_grouped_tile(0) + row_spread, H)
    box_cols = min(-(-(lib.kb_search_grouped_tile(1) + col_spread + 7) // 8) * 8, Wp)
    smem = lib.kb_search_grouped_smem_bytes(T, box_rows, box_cols)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"search_grouped: a group's {box_rows}x{box_cols} window does not fit shared memory")
    gidx = (order_t.to(torch.int32) + int(kw.get("cand_offset", 0))).contiguous()
    cand_ok = cand_ok[order_t].contiguous()
    gstart = torch.as_tensor(bounds.astype(np.int32), device=dev)
    top_lh = torch.empty((K, SH, SW), dtype=torch.float32, device=dev)
    top_idx = torch.empty((K, SH, SW), dtype=torch.int32, device=dev)
    err = lib.kb_search_grouped(
        pairs.data_ptr(), ox.data_ptr(), oy.data_ptr(), gidx.data_ptr(), cand_ok.data_ptr(),
        gstart.data_ptr(), len(starts), T, H, W, Wp, SH, SW, K, int(smem), *em,
        *_gate_args(min_obs, min_lh, kw), top_lh.data_ptr(), top_idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "search_grouped")
    search_grouped.launches += 1
    return top_lh, top_idx


search_grouped.launches = 0
