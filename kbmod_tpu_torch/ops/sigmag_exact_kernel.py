"""K7: the exact in-search sigma-G top-K as one CUDA kernel.

``sigmag_exact_topk`` launches ``csrc/sigmag_exact_topk.cu``: one thread a
start pixel scores every candidate by its clipped lh and inserts it into
that pixel's top-K in place, sorting only the curves of the pairs that pass
the unclipped gate. It takes any T and K. It replaces no TPU kernel (the JAX
package runs this search in XLA); its plain twin is
``ops.search.search_topk_sigmag_exact`` on a CPU tensor, which dispatches
here on a card (:func:`k7_route`) with the percentile indices of the
clipping as a host table, so the kernel does no float64 work.
"""

import ctypes

import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops.search_kernel import allocate_maps

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kb_sigmag_exact_topk": ([_P] * 5 + [_I] * 10 + [_F] * 3 + [_P] * 4, ctypes.c_int),
}


def _lib():
    return _build.load("sigmag_exact_topk", _SIGNATURES)


def k7_route(device_type):
    """Where the exact search of planes on ``device_type`` runs: "kernel"
    (K7) on a card, "twin" (the plain PyTorch search) elsewhere."""
    return "kernel" if device_type == "cuda" else "twin"


def sigmag_exact_topk(
    psi, phi, valid, dxs, dys, min_obs, min_lh, sigmag_coeff,
    *, x_min, x_max, y_min, y_max, k_results, pct_idx, cand_offset=0,
):
    """The exact sigma-G top-K of ``ops.search.search_topk_sigmag_exact`` (see
    there for the arguments and the (K, SH, SW) maps it returns) as one K7
    launch on the planes' card. ``pct_idx`` is the (T + 1, 3) table of the
    percentile indices (iL, iM, iH) of the clipping for each sample count
    n = 0..T, as the twin computes them. While tracing is on, the launch is
    the span ``kernel.K7.sigmag_exact`` and the pairs that passed the
    unclipped gate and were clipped add to the counter ``exact.clipped``
    (read back after the kernel, so only then does the host wait for it)."""
    dev = psi.device
    T, H, W = psi.shape
    SH, SW, K = int(y_max) - int(y_min), int(x_max) - int(x_min), int(k_results)
    if dev.type != "cuda":
        raise ValueError(f"sigmag_exact_topk: the planes are on {dev}, not on a card")
    if SH <= 0 or SW <= 0:
        raise ValueError(f"sigmag_exact_topk: empty search window {SH}x{SW}")
    if phi.shape != psi.shape or valid.shape != psi.shape:
        raise ValueError("sigmag_exact_topk: psi, phi and valid must share one (T, H, W) shape")
    if psi.dtype != torch.float32 or phi.dtype != torch.float32:
        raise ValueError("sigmag_exact_topk: psi and phi must be float32")
    if H * W >= 1 << 31:
        raise ValueError(f"sigmag_exact_topk: a {H}x{W} plane is beyond the kernel's 32-bit pixel index")
    dxs = torch.as_tensor(dxs, device=dev)
    dys = torch.as_tensor(dys, device=dev)
    C = dxs.shape[0]
    if tuple(dxs.shape) != (C, T) or tuple(dys.shape) != (C, T):
        raise ValueError(f"sigmag_exact_topk: offsets must be (C, T) = ({C}, {T})")
    if tuple(pct_idx.shape) != (T + 1, 3):
        raise ValueError(f"sigmag_exact_topk: the percentile table must be (T + 1, 3) = ({T + 1}, 3)")
    lib = _lib()
    psi, phi = psi.contiguous(), phi.contiguous()
    valid = valid.to(torch.uint8).contiguous()
    off = torch.stack([dxs, dys], dim=-1).to(torch.int32).contiguous()
    pct = pct_idx.to(device=dev, dtype=torch.int32).contiguous()
    top_lh, top_idx = allocate_maps(K, SH, SW, dev, "sigmag_exact_topk")
    clipped = torch.zeros(1, dtype=torch.int64, device=dev) if tracing.enabled() else None
    with tracing.span("kernel.K7.sigmag_exact"):
        err = lib.kb_sigmag_exact_topk(
            psi.data_ptr(), phi.data_ptr(), valid.data_ptr(), off.data_ptr(), pct.data_ptr(),
            C, T, H, W, int(x_min), int(y_min), SH, SW, K, int(cand_offset),
            float(min_obs), float(min_lh), float(sigmag_coeff), top_lh.data_ptr(), top_idx.data_ptr(),
            clipped.data_ptr() if clipped is not None else None, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "sigmag_exact_topk")
        if clipped is not None:
            tracing.count("exact.clipped", int(clipped.item()))
    sigmag_exact_topk.launches += 1
    return top_lh, top_idx


sigmag_exact_topk.launches = 0
