"""Batched stamp extraction and coaddition on the device.

Port of the JAX package's ops/stamps.py. The reference extracts stamps per
trajectory with numba loops and coadds with torch (src/kbmod/core/
stamp_utils.py:241-343, filters/stamp_filters.py:72-168). Here each chunk of
results gathers its (rows, T, S, S) stamp windows from the per-time images
on the host, moves only those windows to the device, reduces them there to
the requested coadds and brings the (rows, S, S) coadds back. The JAX
package uploads the whole (T, H, W) float stack instead (its
ops/stamps.py:117-119); the windows are all the coadds read.
"""

import numpy as np
import torch

from kbmod_tpu_torch.device import resolve_device

# Bytes of stamp windows one chunk moves to the device.
_CHUNK_BYTES = 64 << 20


def gather_windows(imgs, cx, cy, radius):
    """(R, T, S, S) float32 windows of the T images ``imgs`` (a (T, H, W)
    array or a list of (H, W) arrays, on the host) centred at the (R, T)
    integer pixels (cx, cy); pixels outside an image are NaN."""
    R, T = cx.shape
    d = np.arange(-radius, radius + 1)
    out = np.empty((R, T, len(d), len(d)), dtype=np.float32)
    for t in range(T):
        img = np.asarray(imgs[t], dtype=np.float32)
        H, W = img.shape
        rows = cy[:, t, None] + d
        cols = cx[:, t, None] + d
        inside = ((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :]
        win = img[np.clip(rows, 0, H - 1)[:, :, None], np.clip(cols, 0, W - 1)[:, None, :]]
        out[:, t] = np.where(inside, win, np.float32(np.nan))
    return out


def _time_sum(x):
    """Sum over axis 1 of (R, T, S, S), one time step after another from
    +0.0 (the order of the JAX package's XLA reductions on the host)."""
    acc = torch.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        acc = acc + x[:, t]
    return acc


def _coadd_sum(data):
    return _time_sum(torch.nan_to_num(data, nan=0.0, posinf=torch.inf, neginf=-torch.inf))


def _coadd_mean(data):
    count = torch.isfinite(data).sum(dim=1, dtype=torch.int32)
    total = _coadd_sum(data)
    return torch.where(count > 0, total / count.clamp(min=1), 0.0)


def _coadd_median(data):
    """The lower median of the non-NaN values (torch.nanmedian, which the
    reference's coadd_median wraps); 0 where a pixel has none."""
    count = torch.isfinite(data).sum(dim=1)
    med = torch.nanmedian(data, dim=1).values
    return torch.where(count > 0, med, 0.0)


def _coadd_weighted(data, var_data):
    ok = torch.isfinite(data) & torch.isfinite(var_data) & (var_data != 0.0)
    one = torch.ones((), dtype=torch.float32, device=data.device)
    weights = torch.where(ok, one / torch.where(ok, var_data, one), 0.0)
    weighted_sum = _time_sum(torch.where(ok, data, 0.0) * weights)
    sum_w = _time_sum(weights)
    return weighted_sum / torch.where(sum_w == 0.0, torch.full_like(sum_w, 1e24), sum_w)


def batched_coadds(
    sci,
    var,
    zeroed_times,
    xs,
    ys,
    vxs,
    vys,
    radius,
    coadd_types,
    obs_valid=None,
    chunk=4096,
    device=None,
):
    """Compute coadded stamps for many trajectories on the device.

    Parameters
    ----------
    sci, var : the T science and variance images on the host, as a (T, H, W)
        float32 array or a list of (H, W) arrays (NaN = masked).
    zeroed_times : (T,) times.
    xs, ys, vxs, vys : (R,) trajectory parameters.
    radius : stamp radius.
    coadd_types : list of 'sum' | 'mean' | 'median' | 'weighted', and
        'all_stamps' for the (R, T, S, S) stamp cube.
    obs_valid : optional (R, T) bool, the times to include per trajectory.
    chunk : most rows a chunk takes (chunks also stay under 64 MiB of
        windows).
    device : where the coadds reduce: CUDA unless ``device="cpu"``.

    Stamp centres are int(x + v*t + 0.5) in float64 (truncation, the
    reference's stamp_utils.py:202); pixels outside the image are NaN; a row
    without a valid time gives zeros.

    Returns
    -------
    dict mapping coadd type -> (R, S, S) numpy float32, plus key
    'all_stamps' when requested in coadd_types ((R, T, S, S), NaN as 0).
    """
    dev = resolve_device(device)
    times = np.asarray(zeroed_times, dtype=np.float64)
    T = len(times)
    n = len(xs)
    S = 2 * radius + 1
    kinds = tuple(c for c in coadd_types if c != "all_stamps")
    want_all = "all_stamps" in coadd_types
    out = {c: np.zeros((n, S, S), dtype=np.float32) for c in kinds}
    if want_all:
        out["all_stamps"] = np.zeros((n, T, S, S), dtype=np.float32)

    xs, ys = np.asarray(xs, dtype=np.float64), np.asarray(ys, dtype=np.float64)
    vxs, vys = np.asarray(vxs, dtype=np.float64), np.asarray(vys, dtype=np.float64)
    rows = max(1, min(int(chunk), _CHUNK_BYTES // max(4 * T * S * S, 1)))
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        cx = (xs[lo:hi, None] + times[None, :] * vxs[lo:hi, None] + 0.5).astype(np.int32)
        cy = (ys[lo:hi, None] + times[None, :] * vys[lo:hi, None] + 0.5).astype(np.int32)
        stamps = torch.as_tensor(gather_windows(sci, cx, cy, radius), device=dev)
        if obs_valid is not None:
            valid = torch.as_tensor(np.asarray(obs_valid[lo:hi], dtype=bool), device=dev)
            data = torch.where(valid[:, :, None, None], stamps, torch.nan)
        else:
            data = stamps
        for ctype in kinds:
            if ctype == "sum":
                res = _coadd_sum(data)
            elif ctype == "mean":
                res = _coadd_mean(data)
            elif ctype == "median":
                res = _coadd_median(data)
            elif ctype == "weighted":
                var_stamps = torch.as_tensor(gather_windows(var, cx, cy, radius), device=dev)
                res = _coadd_weighted(data, var_stamps)
            else:
                raise ValueError(f"Unknown coadd type {ctype}")
            out[ctype][lo:hi] = res.cpu().numpy()
        if want_all:
            out["all_stamps"][lo:hi] = torch.nan_to_num(stamps, nan=0.0).cpu().numpy()
    return out
