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
  the other two do not take. It takes the candidates in the groups of
  ``search_plan.grouped_plan``, as K2 does, and stages each group's windows
  in shared memory (:func:`k3_staging` lays them out). CUDA source
  ``csrc/search_topk_encoded_grouped.cu``.
- ``search_paired`` replaces ``_search_kernel_paired`` (K4, :916): uint8
  codes with T <= 257, two output columns per thread summed as the two
  16-bit fields of one 32-bit register, candidates in index order in
  batches of 8 whose windows it stages as K5 does (:func:`k4_staging` lays
  them out). CUDA source ``csrc/search_topk_encoded.cu``.
- ``search_grouped`` replaces ``_search_kernel_paired_grouped`` (K5,
  :1493): uint8 codes, any T, candidates in groups whose rows lie close
  together (``ops/search_plan.py``), one shared-memory window per group and
  time step serving the group. CUDA source ``csrc/search_topk_grouped.cu``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs ``search_topk_encoded_shift``, the twin. Exact likelihood ties rank
by (lh desc, global index asc) in every kernel and in the twin: K3 and K5,
whose candidates arrive in plan order, compare (lh, index) explicitly; K4
sees them in index order, where the two rules agree.
"""

import ctypes

import numpy as np
import torch

from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops.psi_phi import _codes_as_int, _f32, interleave_code_pairs
from kbmod_tpu_torch.ops.search_kernel import FLT_MAX, allocate_maps
from kbmod_tpu_torch.ops.search_plan import GROUP_G, grouped_plan, staging_header_bytes, window_layout_cached

# The kernels' numbers, as the profiler's launch labels name them.
_KERNEL_TAGS = {"search_encoded": "K3", "search_paired": "K4", "search_grouped": "K5"}
# uint8 code sums fit a 16-bit field while T * 255 <= 65535.
PAIRED_MAX_T = 257

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GROUPED_ARGS = [_P] * 8 + [_I] * 8 + [_F] * 6 + [_I, _I, _P, _P, _P]
_PAIRED_SIGNATURES = {
    "kb_search_paired": (_GROUPED_ARGS, ctypes.c_int),
    "kb_search_paired_max_group": ([], ctypes.c_int),
    "kb_search_paired_max_t": ([], ctypes.c_int),
    "kb_search_paired_tile": ([_I], ctypes.c_int),
    "kb_search_paired_smem_bytes": ([_I], ctypes.c_size_t),
    "kb_search_paired_blocks_per_sm": ([_I, _I], ctypes.c_int),
}
_GRP_SIGNATURES = {
    "kb_search_grouped": (_GROUPED_ARGS, ctypes.c_int),
    "kb_search_grouped_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "kb_search_grouped_tile": ([_I], ctypes.c_int),
    "kb_search_grouped_max_group": ([], ctypes.c_int),
    "kb_search_grouped_blocks_per_sm": ([_I, _I], ctypes.c_int),
}
_K3_SIGNATURES = {
    "kb_search_encoded": ([_I] + _GROUPED_ARGS, ctypes.c_int),
    "kb_search_encoded_max_group": ([], ctypes.c_int),
    "kb_search_encoded_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "kb_search_encoded_tile": ([_I, _I], ctypes.c_int),
    "kb_search_encoded_max_t": ([_I], ctypes.c_int),
    "kb_search_encoded_blocks_per_sm": ([_I, _I, _I], ctypes.c_int),
}
# K5's block tile (rows, columns), staging chunk in code pairs and the
# steps its 16-bit fields hold before a flush (csrc/search_topk_grouped.cu).
K5_TILE_ROWS, K5_TILE_COLS, K5_CHUNK = 4, 256, 8
_K5_FLUSH = 257
K5_MAX_T = 65535
# K3's block tile (rows, columns) and its staging chunk in code pairs by code
# width (16 bytes), and its most time steps: int32 sums of uint16 codes stay
# exact up to 32,768 steps, the 16-bit count fields hold 65,535
# (csrc/search_topk_encoded_grouped.cu).
K3_TILE_ROWS, K3_TILE_COLS = 8, 128
K3_CHUNK = {8: 8, 16: 4}
K3_MAX_T = {8: 65535, 16: 32768}
# K4's block tile (rows, columns) and staging chunk in code pairs
# (csrc/search_topk_encoded.cu).
K4_TILE_ROWS, K4_TILE_COLS, K4_CHUNK = 4, 256, 8


def k4_staging(dxs, dys, x_min, y_min):
    """K4's host layout for (C, T) offsets: the candidates in index order, in
    batches of 8 (``starts`` 0, 8, 16, ...), and the window layout of their
    staged code pairs (one extra column on each window's right, which an odd
    column shift reads; one slab per member unless a box over the batch is
    smaller). Returns a dict with ``starts``, ``lay``, ``off``,
    ``buf_elems`` and ``smem_bytes`` (the tables' header and two buffers of
    2 bytes a pair). Raises ValueError past T = 257 or when that exceeds a
    block's shared memory."""
    C, T = np.shape(dxs)
    if T > PAIRED_MAX_T:
        raise ValueError(f"search_paired: T={T} above the kernel's {PAIRED_MAX_T}")
    starts = np.arange(0, C, GROUP_G, dtype=np.int64)
    lay, off, buf_elems = window_layout_cached(
        np.asarray(dxs, dtype=np.int64) + int(x_min), np.asarray(dys, dtype=np.int64) + int(y_min), starts,
        tile_rows=K4_TILE_ROWS, tile_cols=K4_TILE_COLS, chunk=K4_CHUNK, extra=1)
    smem = staging_header_bytes() + 2 * 2 * buf_elems
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"search_paired: T={T} windows need {smem} bytes of shared memory")
    return dict(starts=starts, lay=lay, off=off, buf_elems=buf_elems, smem_bytes=smem)


def k5_staging(dxs, dys, x_min, y_min, plan):
    """K5's host layout for (C, T) offsets and a grouping plan ``(order,
    starts)``: the window layout of its staged code pairs (one extra column
    on each window's right, which an odd column shift reads) and the shared
    memory it needs. Returns a dict with ``lay``, ``off``, ``buf_elems`` and
    ``smem_bytes`` (header, two buffers of 2 bytes a pair, and the 32-bit
    field sums past 257 steps). Raises ValueError when that exceeds a
    block's shared memory."""
    order, starts = (np.asarray(a, dtype=np.int64) for a in plan)
    T = np.shape(dxs)[1]
    if T > K5_MAX_T:
        raise ValueError(f"search_grouped: T={T} above the kernel's {K5_MAX_T}")
    dxs = np.asarray(dxs, dtype=np.int64)[order] + int(x_min)
    dys = np.asarray(dys, dtype=np.int64)[order] + int(y_min)
    lay, off, buf_elems = window_layout_cached(
        dxs, dys, starts, tile_rows=K5_TILE_ROWS, tile_cols=K5_TILE_COLS, chunk=K5_CHUNK, extra=1)
    # 32-bit field sums past 257 steps: G members x (psi, phi) x 2 columns
    # a thread, 512 threads, 4 bytes.
    wide = GROUP_G * 4 * 512 * 4 if T > _K5_FLUSH else 0
    smem = staging_header_bytes() + 2 * 2 * buf_elems + wide
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"search_grouped: T={T} windows need {smem} bytes of shared memory")
    return dict(lay=lay, off=off, buf_elems=buf_elems, smem_bytes=smem)


def k3_staging(dxs, dys, x_min, y_min, bits):
    """K3's host plan for (C, T) offsets over codes of ``bits`` (8 or 16):
    the grouping plan (``search_plan.grouped_plan``, taken whether or not
    it fills), the window layout of its staged code pairs (16-byte chunks:
    8 uint8 pairs or 4 uint16 pairs; no extra column, since a thread reads
    one whole pair) and the shared memory it needs. Returns a dict with
    ``order``, ``starts``, ``lay``, ``off``, ``buf_elems`` and
    ``smem_bytes`` (the tables' header and two buffers of 2 or 4 bytes a
    pair). Raises ValueError past the kernel's T limit or when the windows
    exceed a block's shared memory."""
    T = np.shape(dys)[1]
    if T > K3_MAX_T[bits]:
        raise ValueError(f"search_encoded: T={T} above the kernel's {K3_MAX_T[bits]} for uint{bits} codes")
    dxs = np.asarray(dxs, dtype=np.int64)
    dys = np.asarray(dys, dtype=np.int64)
    (order, starts), _ = grouped_plan(dys)
    lay, off, buf_elems = window_layout_cached(
        dxs[order] + int(x_min), dys[order] + int(y_min), starts,
        tile_rows=K3_TILE_ROWS, tile_cols=K3_TILE_COLS, chunk=K3_CHUNK[bits],
    )
    smem = staging_header_bytes() + 2 * (bits // 4) * buf_elems
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"search_encoded: T={T} windows need {smem} bytes of shared memory")
    return dict(order=order, starts=starts, lay=lay, off=off, buf_elems=buf_elems, smem_bytes=smem)


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
    if K < 1:
        raise ValueError(f"{name}: k_results={K} must be at least 1")
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


def _launch_grouped(lib, entry, lead, prepared, min_obs, min_lh, kw, st, order, starts, name):
    """Launch a staged kernel (K3, K4, K5) with ``_prepare``'s tensors and the
    host plan ``st`` (its layout) over the plan ``(order, starts)``, or over
    the candidates in index order when ``order`` is None; ``lead`` are the
    entry's arguments before the code pairs. The group bounds and the layout
    go to the card in one copy."""
    pairs, ox, oy, cand_ok, em, (C, T, H, W, Wp, SH, SW, K) = prepared
    dev = pairs.device
    pad = pairs[:, :, W:]
    if Wp > W and bool((pad.view(torch.int16) if pad.dtype == torch.uint16 else pad).any()):
        raise ValueError(f"{name}: the code pairs' padding columns must be zero")
    offset = int(kw.get("cand_offset", 0))
    if order is None:
        gidx = torch.arange(offset, offset + C, dtype=torch.int32, device=dev)
    else:
        order_t = torch.as_tensor(order, device=dev)
        ox, oy = ox[order_t].contiguous(), oy[order_t].contiguous()
        gidx = (order_t.to(torch.int32) + offset).contiguous()
        cand_ok = cand_ok[order_t].contiguous()
    NG, n_lay = len(starts), st["lay"].size
    tables = torch.as_tensor(
        np.concatenate([np.append(starts, C), st["lay"].ravel(), st["off"].ravel()]).astype(np.int32), device=dev)
    gstart, lay, off = tables[: NG + 1], tables[NG + 1 : NG + 1 + n_lay], tables[NG + 1 + n_lay :]
    top_lh, top_idx = allocate_maps(K, SH, SW, dev, name)
    with torch.profiler.record_function(f"kbmod {_KERNEL_TAGS[name]} {name}"):
        err = getattr(lib, entry)(
            *lead, pairs.data_ptr(), ox.data_ptr(), oy.data_ptr(), gidx.data_ptr(), cand_ok.data_ptr(),
            gstart.data_ptr(), lay.data_ptr(), off.data_ptr(), NG, T, H, Wp, SH, SW, K,
            st["buf_elems"], *em, *_gate_args(min_obs, min_lh, kw), top_lh.data_ptr(), top_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, name)
    return top_lh, top_idx


def _offsets_np(dxs, dys):
    return (np.asarray(torch.as_tensor(dxs).cpu(), dtype=np.int64),
            np.asarray(torch.as_tensor(dys).cpu(), dtype=np.int64))


def search_encoded(planes, dxs, dys, min_obs, min_lh, **kw):
    """K3: the grouped encoded search over uint16 codes, or uint8 codes
    (T up to 32,768 for uint16, 65,535 for uint8).

    ``planes`` is an ``EncodedPlanes`` (ops/search.py); dxs, dys (C, T)
    int offsets; keywords as ``search_topk_encoded_shift`` takes them. The
    candidates go in the groups of ``search_plan.grouped_plan``; the code
    pairs' padding columns must be zero, as ``interleave_code_pairs`` and
    the streaming build make them. CUDA tensors launch the kernel and raise
    if it cannot; CPU tensors take the twin."""
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    prepared = _prepare(planes, dxs, dys, kw, "search_encoded")
    C, _, _, _, _, SH, SW, K = prepared[-1]
    if C == 0:
        return _empty(K, SH, SW, prepared[0].device)
    bits = 16 if planes.psi_codes.dtype == torch.uint16 else 8
    dx_np, dy_np = _offsets_np(dxs, dys)
    st = k3_staging(dx_np, dy_np, kw["x_min"], kw["y_min"], bits)
    lib = _build.load("search_topk_encoded_grouped", _K3_SIGNATURES)
    tile = tuple(lib.kb_search_encoded_tile(bits, a) for a in range(3))
    if (tile != (K3_TILE_ROWS, K3_TILE_COLS, K3_CHUNK[bits]) or lib.kb_search_encoded_max_group() != GROUP_G
            or lib.kb_search_encoded_max_t(bits) != K3_MAX_T[bits]
            or st["smem_bytes"] != lib.kb_search_encoded_smem_bytes(bits, st["buf_elems"])):
        raise RuntimeError("search_encoded: host and kernel disagree on the tile, group, T limit or shared memory")
    out = _launch_grouped(lib, "kb_search_encoded", (bits,), prepared, min_obs, min_lh, kw, st,
                          st["order"], st["starts"], "search_encoded")
    search_encoded.launches += 1
    return out


search_encoded.launches = 0


def search_paired(planes, dxs, dys, min_obs, min_lh, **kw):
    """K4: the uint8 search with two columns summed per 32-bit add, for
    T <= 257 (arguments as :func:`search_encoded`). The candidates go in
    index order, in the batches of :func:`k4_staging`."""
    T = planes.shape[0]
    if planes.psi_codes.dtype != torch.uint8 or T > PAIRED_MAX_T:
        raise ValueError(f"search_paired: needs uint8 codes and T <= {PAIRED_MAX_T}, got {planes.psi_codes.dtype}, T={T}")
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    prepared = _prepare(planes, dxs, dys, kw, "search_paired")
    C, _, _, _, _, SH, SW, K = prepared[-1]
    if C == 0:
        return _empty(K, SH, SW, prepared[0].device)
    dx_np, dy_np = _offsets_np(dxs, dys)
    st = k4_staging(dx_np, dy_np, kw["x_min"], kw["y_min"])
    lib = _build.load("search_topk_encoded", _PAIRED_SIGNATURES)
    tile = tuple(lib.kb_search_paired_tile(a) for a in range(3))
    if (tile != (K4_TILE_ROWS, K4_TILE_COLS, K4_CHUNK) or lib.kb_search_paired_max_group() != GROUP_G
            or lib.kb_search_paired_max_t() != PAIRED_MAX_T
            or st["smem_bytes"] != lib.kb_search_paired_smem_bytes(st["buf_elems"])):
        raise RuntimeError("search_paired: host and kernel disagree on the tile, batch, T limit or shared memory")
    out = _launch_grouped(lib, "kb_search_paired", (), prepared, min_obs, min_lh, kw, st, None, st["starts"],
                          "search_paired")
    search_paired.launches += 1
    return out


search_paired.launches = 0


def search_grouped(planes, dxs, dys, min_obs, min_lh, *, plan, **kw):
    """K5: the uint8 search over candidate groups.

    ``plan`` is ``(order, starts)`` from ``ops/search_plan.py``: group g
    holds the candidates ``order[starts[g]:starts[g + 1]]`` (at most 8),
    taken in that order. Other arguments as :func:`search_encoded`; the code
    pairs' padding columns must be zero, as ``interleave_code_pairs`` and
    the streaming build make them. Exact ties still rank by ascending index,
    so the result is the twin's, which the CPU runs."""
    order, starts = (np.asarray(a, dtype=np.int64) for a in plan)
    if planes.psi_codes.dtype != torch.uint8:
        raise ValueError(f"search_grouped: needs uint8 codes, got {planes.psi_codes.dtype}")
    if planes.psi_codes.device.type == "cpu":
        return _twin(planes, dxs, dys, min_obs, min_lh, kw)
    prepared = _prepare(planes, dxs, dys, kw, "search_grouped")
    C, T, _, _, _, SH, SW, K = prepared[-1]
    if C == 0:
        return _empty(K, SH, SW, prepared[0].device)
    bounds = np.append(starts, C)
    lib = _build.load("search_topk_grouped", _GRP_SIGNATURES)
    G = lib.kb_search_grouped_max_group()
    if len(order) != C or starts[0] != 0 or (np.diff(bounds) <= 0).any() or np.diff(bounds).max() > G:
        raise ValueError(f"search_grouped: the plan must split all {C} candidates into groups of 1..{G}")
    if sorted(order.tolist()) != list(range(C)):
        raise ValueError("search_grouped: the plan's order must be a permutation of the candidates")
    dx_np, dy_np = _offsets_np(dxs, dys)
    st = k5_staging(dx_np, dy_np, kw["x_min"], kw["y_min"], (order, starts))
    tile = tuple(lib.kb_search_grouped_tile(a) for a in range(3))
    if (tile != (K5_TILE_ROWS, K5_TILE_COLS, K5_CHUNK) or G != GROUP_G
            or st["smem_bytes"] != lib.kb_search_grouped_smem_bytes(T, st["buf_elems"])):
        raise RuntimeError("search_grouped: host and kernel disagree on the tile, group or shared-memory layout")
    out = _launch_grouped(lib, "kb_search_grouped", (), prepared, min_obs, min_lh, kw, st, order, starts,
                          "search_grouped")
    search_grouped.launches += 1
    return out


search_grouped.launches = 0
