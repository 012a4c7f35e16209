"""The plain reference of a search: the same semantics as the program,
written straight from them in PyTorch (float64 unless a precision is asked
for), with no code or state of the program.

- ``build``: psi = corr(sci / var, k) and phi = corr(1 / var, k^2), each
  renormalised by the share of its kernel that falls on valid pixels
  (sum(k) / corr(valid, k)), zero padding at the edges; NaN where the pixel
  is invalid (sci or var not finite, or var <= 0).
- ``quantize``: the configuration's encoding of a plane into ``nbits``
  codes: global finite min and max, scale = max(max - min, 1e-6) /
  (2^nbits - 1), code = clip(floor((v - min) / scale) + 1, 1, 2^nbits - 1),
  0 for NaN; a code decodes to (code - 1) * scale + min.
- ``offsets``: the pixel of a candidate at time t is x + floor(v t + 0.5),
  v the candidate's float32 velocity taken to float64.
- ``raw_scores``: lh = sum(psi) / sqrt(sum(phi)) over the valid samples
  (-1 where sum(phi) <= 0), the valid count, flux = sum(psi) / sum(phi).
- ``kernel_clip``: the in-search sigma-G filter: the valid samples' psi /
  phi sorted (stable), percentile i of n at index clamp(int(ceil(n q) +
  0.001) - 1, 0, n - 1), median +- 2 coeff (p_hi - p_lo), the kept run
  grown from the median while values stay inside.
- ``host_clip``: the results path's sigma-G filter: the light curve psi /
  sqrt(phi) (phi != 0), percentiles by linear interpolation over the finite
  values (the positive ones with ``clip_negative``), a floor of 1e-5 on the
  spread, and strict bounds median +- 2 coeff (p_hi - p_lo).
- ``coadds``: stamps of radius r centred at int(x + v t + 0.5) (truncated
  toward zero), NaN off the image, reduced over the kept times: sum
  (NaN as 0), mean over the valid count, the lower median; 0 where a pixel
  has no valid time.
"""

import math
from statistics import NormalDist

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64


def sigma_g_coeff(lo_pct, hi_pct):
    """1 / (z(hi) - z(lo)), z the inverse standard normal CDF."""
    nd = NormalDist()
    return 1.0 / (nd.inv_cdf(hi_pct / 100.0) - nd.inv_cdf(lo_pct / 100.0))


def build(sci, var, psfs, dtype=F64):
    """(psi, phi) (T, H, W) in ``dtype`` from (T, H, W) sci and var tensors
    and T PSF kernels (numpy), one 2-D correlation per image."""
    sci = sci.to(dtype)
    var = var.to(dtype)
    valid = torch.isfinite(sci) & torch.isfinite(var) & (var > 0)
    m = valid.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=sci.device)
    a = torch.where(valid, sci / torch.where(valid, var, 1.0), zero)
    b = torch.where(valid, 1.0 / torch.where(valid, var, 1.0), zero)
    psi = torch.empty_like(sci)
    phi = torch.empty_like(sci)
    nan = torch.full((), float("nan"), dtype=dtype, device=sci.device)
    groups = {}
    for t, kernel in enumerate(psfs):  # exposures that share a PSF, one batched correlation each
        kernel = np.asarray(kernel, dtype=np.float32)
        groups.setdefault((kernel.shape, kernel.tobytes()), (kernel, []))[1].append(t)
    for kernel, ts in groups.values():
        k = torch.as_tensor(kernel, device=sci.device).to(dtype)
        k2 = k * k
        pad = (k.shape[0] // 2, k.shape[1] // 2)
        idx = torch.as_tensor(ts, device=sci.device)

        def corr(x, w):
            return F.conv2d(x[idx][:, None], w[None, None], padding=pad)[:, 0]

        psi[idx] = torch.where(valid[idx], corr(a, k) * (k.sum() / corr(m, k).clamp_min(1e-24)), nan)
        phi[idx] = torch.where(valid[idx], corr(b, k2) * (k2.sum() / corr(m, k2).clamp_min(1e-24)), nan)
    return psi, phi


def quantize(plane, nbits):
    """The plane after encoding into ``nbits`` codes and decoding: NaN stays
    NaN. Returns (decoded plane, codes as int64)."""
    finite = torch.isfinite(plane)
    lo = plane[finite].min()
    hi = plane[finite].max()
    top = 2**nbits - 1
    scale = torch.clamp(hi - lo, min=1e-6) / top
    codes = torch.clamp(torch.floor((torch.where(finite, plane, lo) - lo) / scale) + 1, 1, top).to(torch.int64)
    codes = torch.where(finite, codes, torch.zeros_like(codes))
    decoded = torch.where(codes > 0, (codes - 1).to(plane.dtype) * scale + lo, torch.full_like(plane, float("nan")))
    return decoded, codes


def offsets(vxs, vys, zeroed_times, device):
    """(C, T) int64 offsets floor(v t + 0.5) of float32 velocities."""
    t = torch.as_tensor(zeroed_times, dtype=F64, device=device)
    vx = torch.as_tensor(vxs, device=device).to(torch.float32).to(F64)
    vy = torch.as_tensor(vys, device=device).to(torch.float32).to(F64)
    return torch.floor(vx[:, None] * t[None] + 0.5).to(torch.int64), torch.floor(vy[:, None] * t[None] + 0.5).to(torch.int64)


def curves(psi, phi, xs, ys, dxs, dys):
    """(N, T) psi and phi along paths (0 where the sample is invalid) and
    the (N, T) validity: on the frame and psi finite. xs, ys (N,) start
    pixels; dxs, dys (N, T) offsets; all int64 tensors on the planes'
    device."""
    T, H, W = psi.shape
    px = xs[:, None] + dxs
    py = ys[:, None] + dys
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    tt = torch.arange(T, device=psi.device)[None].expand_as(px)
    pv = psi[tt, py.clamp(0, H - 1), px.clamp(0, W - 1)]
    fv = phi[tt, py.clamp(0, H - 1), px.clamp(0, W - 1)]
    ok = inb & torch.isfinite(pv)
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
    return torch.where(ok, pv, zero), torch.where(ok & torch.isfinite(fv), fv, zero), ok


def raw_scores(psi_v, phi_v, ok):
    """(lh, obs, flux) of (N, T) curves."""
    ps, fs = psi_v.sum(1), phi_v.sum(1)
    good = fs > 0
    lh = torch.where(good, ps / torch.sqrt(torch.where(good, fs, 1.0)), -1.0)
    flux = torch.where(good, ps / torch.where(good, fs, 1.0), -1.0)
    return lh, ok.sum(1), flux


def kernel_clip(psi_v, phi_v, ok, sgl_lo, sgl_hi, coeff, width=2.0):
    """(lh, flux) of (N, T) curves after the in-search sigma-G filter."""
    N, T = psi_v.shape
    n = ok.sum(1)
    nz = phi_v != 0
    inf = torch.full((), float("inf"), dtype=psi_v.dtype, device=psi_v.device)
    lc = torch.where(ok & nz, psi_v / torch.where(nz, phi_v, 1.0), torch.where(ok, 0.0, inf))
    vals, order = torch.sort(lc, dim=1, stable=True)
    ps = torch.gather(psi_v, 1, order)
    fs = torch.gather(phi_v, 1, order)
    top = torch.clamp(n - 1, min=0)

    def pct(q):
        idx = torch.floor(torch.ceil(n.to(F64) * q) + 0.001).to(torch.int64) - 1
        return torch.minimum(torch.clamp(idx, min=0), top)

    i_lo, i_mid, i_hi = pct(max(sgl_lo, 0.0001)), pct(0.5), pct(min(sgl_hi, 0.9999))
    v_lo, v_mid, v_hi = (vals.gather(1, i[:, None])[:, 0] for i in (i_lo, i_mid, i_hi))
    reach = width * coeff * (v_hi - v_lo)
    cols = torch.arange(T, device=psi_v.device)[None]
    start = torch.minimum((vals < (v_mid - reach)[:, None]).sum(1), i_mid)
    above = (vals > (v_mid + reach)[:, None]) & (cols > i_mid[:, None])
    end = torch.where(above.any(1), above.to(torch.uint8).argmax(1), torch.clamp(n, max=T))
    end = torch.minimum(end, n)
    keep = (cols >= start[:, None]) & (cols < end[:, None]) & (n > 0)[:, None]
    psum = torch.where(keep, ps, 0.0).sum(1)
    fsum = torch.where(keep, fs, 0.0).sum(1)
    good = fsum > 0
    lh = torch.where(good, psum / torch.sqrt(torch.where(good, fsum, 1.0)), -1.0)
    flux = torch.where(good, psum / torch.where(good, fsum, 1.0), -1.0)
    return lh, flux


def ranking(psi_v, phi_v, ok, settings, coeff):
    """The search's ranking score of (N, T) curves under the configuration:
    the in-search sigma-G lh where ``gpu_filter`` and ``sigmaG_filter``
    hold, else the raw lh; -inf where the insertion gates (valid count >=
    num_obs and > 0, score >= lh_level, and before clipping raw lh >=
    lh_level) fail. Returns (gated score, ungated score, valid count)."""
    lh, obs, _ = raw_scores(psi_v, phi_v, ok)
    min_obs, min_lh = int(settings["num_obs"]), float(settings["lh_level"])
    passed = (obs >= min_obs) & (obs > 0) & (lh >= min_lh)
    score = lh
    if settings.get("gpu_filter") and settings.get("sigmaG_filter", True):
        lo, hi = settings.get("sigmaG_lims", [25, 75])
        clipped, _ = kernel_clip(psi_v, phi_v, ok, lo / 100.0, hi / 100.0, coeff)
        score = torch.where(passed, clipped, lh)
    gated = torch.where(passed & (score >= min_lh), score, torch.full_like(score, -math.inf))
    return gated, score, obs


def host_clip(psi_v, phi_v, settings, n_sigma=2.0):
    """(N, T) bool kept samples of the results path's sigma-G filter over
    curves that are 0 where invalid."""
    lo, hi = settings.get("sigmaG_lims") or [25, 75]
    coeff = sigma_g_coeff(lo, hi)
    valid = phi_v != 0
    lh = torch.where(valid, psi_v / torch.sqrt(torch.where(valid, phi_v, 1.0)), float("nan"))
    masked = torch.where(lh > 0, lh, float("nan")) if settings.get("clip_negative") else lh
    q = torch.tensor([lo / 100.0, 0.5, hi / 100.0], dtype=lh.dtype, device=lh.device)
    p_lo, med, p_hi = torch.nanquantile(masked, q, dim=1, interpolation="linear")
    reach = (n_sigma * coeff) * torch.clamp(p_hi - p_lo, min=1e-5)
    return torch.isfinite(lh) & (lh < (med + reach)[:, None]) & (lh > (med - reach)[:, None])


def stamps(sci, xs, ys, vxs, vys, zeroed_times, radius):
    """(N, T, S, S) windows of the (T, H, W) sci tensor, NaN off the image,
    centred at int(x + v t + 0.5) (truncated toward zero)."""
    T, H, W = sci.shape
    dev = sci.device
    t = torch.as_tensor(zeroed_times, dtype=F64, device=dev)
    cx = torch.trunc(torch.as_tensor(xs, dtype=F64, device=dev)[:, None] + t * torch.as_tensor(vxs, dtype=F64, device=dev)[:, None] + 0.5).to(torch.int64)
    cy = torch.trunc(torch.as_tensor(ys, dtype=F64, device=dev)[:, None] + t * torch.as_tensor(vys, dtype=F64, device=dev)[:, None] + 0.5).to(torch.int64)
    d = torch.arange(-radius, radius + 1, device=dev)
    rows = cy[:, :, None, None] + d[:, None]
    cols = cx[:, :, None, None] + d[None, :]
    inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    tt = torch.arange(T, device=dev)[None, :, None, None]
    win = sci[tt.expand_as(rows), rows.clamp(0, H - 1), cols.clamp(0, W - 1)].to(F64)
    return torch.where(inside, win, float("nan"))


def coadds(windows, kept, kinds):
    """{kind: (N, S, S)} coadds of (N, T, S, S) windows over the (N, T)
    kept times."""
    data = torch.where(kept[:, :, None, None], windows, float("nan"))
    fin = torch.isfinite(data)
    count = fin.sum(1)
    total = torch.where(fin, data, 0.0).sum(1)
    out = {}
    for kind in kinds:
        if kind == "sum":
            out[kind] = total
        elif kind == "mean":
            out[kind] = torch.where(count > 0, total / count.clamp(min=1), 0.0)
        elif kind == "median":
            srt, _ = torch.sort(torch.where(fin, data, float("inf")), dim=1)
            idx = ((count - 1).clamp(min=0) // 2)[:, None]
            med = srt.gather(1, idx)[:, 0]
            out[kind] = torch.where(count > 0, med, 0.0)
        else:
            raise ValueError(f"the reference has no {kind} coadd")
    return out
