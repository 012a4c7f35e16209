"""K1: the fused psi/phi build, as a CUDA kernel and its plain PyTorch twin.

``psi_phi_conv`` replaces the TPU kernel ``_psi_phi_kernel`` (the JAX
package's ops/conv_pallas.py:32, entry ``psi_phi_conv_pallas``). On a CUDA
tensor it launches ``csrc/psi_phi_conv.cu``; on a CPU tensor it runs
``psi_phi_conv_plain``, which computes the same function tap by tap in
plain PyTorch. Both take their taps from one table, :func:`psf_taps`,
built on the host in one fixed order, so that the twin on the CPU equals
the kernel on the card bit for bit. The kernel is bound by instruction
issue (8 float32 operations per tap per pixel against 16 bytes of
traffic); its source note says what the design does about that.
"""

import ctypes

import numpy as np
import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops.convolve import conv_same

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_psi_phi_conv": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P], ctypes.c_int),
    "kb_psi_phi_conv_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "kb_psi_phi_conv_blocks_per_sm": ([_I, _I], ctypes.c_int),
}


def _lib():
    return _build.load("psi_phi_conv", _SIGNATURES)


# Tap tables by PSF contents, and their copies on each card.
_TAPS = {}
_TAPS_ON = {}
_MAX_CACHED = 256


def _host_kernel(psf):
    """The PSF as a float32 numpy array. A tensor on a card is copied to the
    host once and the copy kept on the tensor (until it is written to)."""
    if not isinstance(psf, torch.Tensor):
        return np.ascontiguousarray(np.asarray(psf, dtype=np.float32))
    if psf.device.type == "cpu":
        return psf.detach().to(torch.float32).contiguous().numpy()
    cached = getattr(psf, "_kb_host_kernel", None)
    if cached is None or cached[0] != psf._version:
        cached = (psf._version, psf.detach().to(torch.float32).cpu().numpy())
        psf._kb_host_kernel = cached
    return cached[1]


def _cached(cache, key, make):
    value = cache.get(key)
    if value is None:
        if len(cache) >= _MAX_CACHED:
            cache.clear()
        value = cache[key] = make()
    return value


def _tap_table(k):
    """(key, table) of a float32 numpy kernel; see :func:`psf_taps`."""
    key = (k.shape, k.tobytes())

    def make():
        flat = k.reshape(-1)
        sq = flat * flat  # float32: each square rounded once
        # Sequential float32 sums, first tap first: one order on every host.
        s1 = np.cumsum(flat, dtype=np.float32)[-1]
        s2 = np.cumsum(sq, dtype=np.float32)[-1]
        return np.concatenate([flat, sq, np.array([s1, s2], np.float32)]).astype(np.float32)

    return key, _cached(_TAPS, key, make)


def psf_taps(psf):
    """(2 kh kw + 2,) float32 numpy tap table: the kernel k row-major, then
    k * k (each rounded once), then sum(k) and sum(k * k), each a sequential
    float32 sum in row-major order. Built once a PSF on the host, so the
    kernel and its twin read the same table on every device. ``psf`` is a
    numpy array or a tensor; the table is shared, do not write to it."""
    return _tap_table(_host_kernel(psf))[1]


def psi_phi_conv_plain(sci, var, psf):
    """Plain PyTorch twin of the K1 kernel.

    sci, var: (N, H, W) float32 with NaN = masked; psf: (kh, kw) float32, a
    numpy array or a tensor (its tap table is built on the host). Returns
    psi, phi: (N, H, W) float32, NaN where the centre pixel is invalid (not
    finite, or var <= 0).
    """
    psi_phi_conv_plain.calls += 1
    zero = torch.zeros((), dtype=torch.float32, device=sci.device)
    valid = torch.isfinite(sci) & torch.isfinite(var) & (var > 0.0)
    psi_raw = torch.where(valid, sci / var, zero)
    phi_raw = torch.where(valid, 1.0 / var, zero)
    m = valid.to(torch.float32)
    kh, kw = psf.shape
    n = kh * kw
    taps = torch.tensor(psf_taps(psf), device=sci.device)
    k, k2 = taps[:n].reshape(kh, kw), taps[n : 2 * n].reshape(kh, kw)
    apsi = conv_same(psi_raw, k)
    aphi = conv_same(phi_raw, k2)
    am1 = conv_same(m, k)
    am2 = conv_same(m, k2)
    nan = torch.full((), float("nan"), device=sci.device)
    psi = torch.where(valid, apsi * (taps[2 * n] / torch.clamp_min(am1, 1e-24)), nan)
    phi = torch.where(valid, aphi * (taps[2 * n + 1] / torch.clamp_min(am2, 1e-24)), nan)
    return psi, phi


psi_phi_conv_plain.calls = 0


def psi_phi_conv(sci, var, psf):
    """Fused masked psi/phi build (see psi_phi_conv_plain for the function).

    CUDA tensors launch the kernel and raise if it cannot; CPU tensors take
    the plain twin. ``psf`` is a numpy array, a CPU tensor or a tensor on
    sci's card; its tap table is built once on the host and kept, with its
    copy on the card.
    """
    if sci.device.type == "cpu":
        return psi_phi_conv_plain(sci, var, psf)
    if sci.device.type != "cuda":
        raise ValueError(f"psi_phi_conv: unsupported device {sci.device}")
    if sci.dim() != 3 or var.shape != sci.shape or len(psf.shape) != 2:
        raise ValueError(f"psi_phi_conv: bad shapes sci {tuple(sci.shape)} var {tuple(var.shape)} psf {tuple(psf.shape)}")
    for name, t in (("sci", sci), ("var", var)):
        if t.device != sci.device or t.dtype != torch.float32:
            raise ValueError(f"psi_phi_conv: {name} must be float32 on {sci.device}")
    if isinstance(psf, torch.Tensor) and psf.device not in (sci.device, torch.device("cpu")):
        raise ValueError(f"psi_phi_conv: psf must be on the host or on {sci.device}")
    N, H, W = sci.shape
    kh, kw = psf.shape
    lib = _lib()
    if lib.kb_psi_phi_conv_smem_bytes(kh, kw) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"psi_phi_conv: PSF {kh}x{kw} too large for one block's shared memory")
    sci = sci.contiguous()
    var = var.contiguous()
    key, taps_host = _tap_table(_host_kernel(psf))
    # The common PSF sizes take their taps as kernel parameters from the
    # host table; the generic kernel reads the table's copy on the card.
    taps = _cached(_TAPS_ON, (key, sci.device), lambda: torch.tensor(taps_host, device=sci.device))
    psi = torch.empty_like(sci)
    phi = torch.empty_like(sci)
    if N * H * W:
        with tracing.span("kernel.K1.psi_phi_conv"):
            err = lib.kb_psi_phi_conv(
                sci.data_ptr(), var.data_ptr(), taps.data_ptr(), taps_host.ctypes.data, N, H, W, kh, kw,
                psi.data_ptr(), phi.data_ptr(), torch.cuda.current_stream(sci.device).cuda_stream,
            )
        _build.check(err, "psi_phi_conv")
        psi_phi_conv.launches += 1
    return psi, phi


psi_phi_conv.launches = 0
