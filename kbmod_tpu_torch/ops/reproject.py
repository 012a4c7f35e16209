"""Image resampling for WCS reprojection, on the caller's device.

Port of the JAX package's ops/reproject.py, which runs the interpolation as
XLA (``jax.jit``; no Pallas kernel), so it is plain PyTorch here, on CUDA
unless the caller asks for the CPU. The coordinate grids stay host numpy in
float64 (exact TAN math, ``compute_source_coordinates``), as does the
stencil radius; the layer goes to the device once, the science and variance
planes are resampled there with one set of weights, and only the outputs
come back. The copies to the device are traced as ``reproject.upload`` and
counted in ``reproject.bytes_h2d`` (``bytes.h2d`` stays the search build's
count); each resampled image adds its stencil's taps to ``reproject.taps``.

- ``method="adaptive"`` (default): a DeForest-style Gaussian-footprint
  resample. Each output pixel's kernel is shaped by the local Jacobian of
  the output->source pixel mapping (``torch.gradient`` of the coordinate
  grids, edge order 1, as ``jnp.gradient``), with its singular values
  clamped to at least one source pixel, evaluated over a static
  (2R+1)^2 tap stencil (dy outer, dx inner). ``conserve_flux=True``
  multiplies by |det J|.
- ``method="bilinear"``: the 4-tap path, taps (0,0), (0,1), (1,0), (1,1).

Every float32 operation is the reference's, in its order (the -10 and -1e6
sentinels of non-finite coordinates, the 1e-12 floors, ``torch.round``
halves to even like ``jnp.round``). XLA-CPU may fuse a multiply and add the
reference rounds twice, and its ``exp`` is not PyTorch's, so values agree
to a few float32 ulps, and a footprint within that of the threshold can
fall on the other side.
"""

import math

import numpy as np
import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.device import resolve_device


def _gather(flat, idx):
    return flat[idx.reshape(-1)].reshape(idx.shape)


def _bilinear_resample(images, valid, coords_y, coords_x):
    """Bilinear resampling with validity propagation.

    images : (P, H, W) float32 planes with 0 at invalid pixels (the science
        and variance planes, resampled with the same weights).
    valid : (H, W) float32 1/0 validity.
    coords_y, coords_x : (Ho, Wo) float32 source coordinates per output
        pixel (NaN = outside the source projection).

    Returns (out (P, Ho, Wo), footprint (Ho, Wo)): the resampled planes and
    the fraction of the interpolation weight that landed on valid source
    pixels.
    """
    P, H, W = images.shape
    finite = torch.isfinite(coords_y) & torch.isfinite(coords_x)
    cy = torch.where(finite, coords_y, torch.full_like(coords_y, -10.0))
    cx = torch.where(finite, coords_x, torch.full_like(coords_x, -10.0))

    y0f = torch.floor(cy)
    x0f = torch.floor(cx)
    fy = cy - y0f
    fx = cx - x0f
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    out = torch.zeros((P,) + tuple(coords_y.shape), dtype=torch.float32, device=images.device)
    footprint = torch.zeros(coords_y.shape, dtype=torch.float32, device=images.device)
    flat_img = images.reshape(P, -1)
    flat_val = valid.reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=images.device)

    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy = y0 + dy
        xx = x0 + dx
        w = (fy if dy else (1.0 - fy)) * (fx if dx else (1.0 - fx))
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
        v = torch.where(inb, _gather(flat_val, idx), zero)
        wv = w * v
        for p in range(P):
            out[p] = out[p] + wv * _gather(flat_img[p], idx)
        footprint = footprint + wv
    footprint = torch.where(finite, footprint, zero)
    return out, footprint


def _clamped_inverse_metric(coords_y, coords_x):
    """Per-pixel inverse metric of the output->source Jacobian.

    For output offset ``o`` the source offset is ``d = J o``; the kernel
    argument is ``|J^-1 d|^2 = d^T (J J^T)^-1 d``. The SPD matrix
    ``A = J J^T`` has its eigenvalues clamped to >= 1 (the DeForest rule:
    the kernel never shrinks below one source pixel) before inversion.

    Returns (i11, i12, i22, sqrt_det): the components of ``A'^-1`` and
    ``sqrt(det A') = |det J'|`` (source pixels per output pixel).
    """
    dy_sy, dx_sy = torch.gradient(coords_y, edge_order=1)
    dy_sx, dx_sx = torch.gradient(coords_x, edge_order=1)
    finite = (
        torch.isfinite(dy_sy) & torch.isfinite(dx_sy) & torch.isfinite(dy_sx) & torch.isfinite(dx_sx)
    )
    one = torch.ones((), dtype=torch.float32, device=coords_y.device)
    zero = torch.zeros((), dtype=torch.float32, device=coords_y.device)
    dy_sy = torch.where(finite, dy_sy, one)
    dx_sy = torch.where(finite, dx_sy, zero)
    dy_sx = torch.where(finite, dy_sx, zero)
    dx_sx = torch.where(finite, dx_sx, one)

    a11 = dy_sy * dy_sy + dx_sy * dx_sy
    a12 = dy_sy * dy_sx + dx_sy * dx_sx
    a22 = dy_sx * dy_sx + dx_sx * dx_sx

    # Analytic 2x2 SPD eigen-clamp: A = m*I + B, eig(B) = +-disc.
    m = 0.5 * (a11 + a22)
    d = 0.5 * (a11 - a22)
    disc = torch.sqrt(d * d + a12 * a12)
    lo = torch.clamp_min(m - disc, 1.0)
    hi = torch.clamp_min(m + disc, 1.0)
    m2 = 0.5 * (hi + lo)
    scale = torch.where(disc > 1e-12, 0.5 * (hi - lo) / torch.clamp_min(disc, 1e-12), zero)
    c11 = m2 + d * scale
    c12 = a12 * scale
    c22 = m2 - d * scale

    det = c11 * c22 - c12 * c12
    inv_det = 1.0 / torch.clamp_min(det, 1e-12)
    return c22 * inv_det, -c12 * inv_det, c11 * inv_det, torch.sqrt(torch.clamp_min(det, 0.0))


def _adaptive_resample(images, valid, coords_y, coords_x, radius, sigma2, trunc2, conserve_flux):
    """DeForest-style Gaussian-footprint resampling with validity
    propagation over a static (2*radius+1)^2 tap stencil.

    images : (P, H, W) float32 planes sharing the stencil's weights.
    Returns (out (P, Ho, Wo), footprint (Ho, Wo)): the kernel-weighted mean
    over valid source pixels, and the fraction of total kernel weight that
    landed on valid in-bounds source data.
    """
    P, H, W = images.shape
    dev = images.device
    finite = torch.isfinite(coords_y) & torch.isfinite(coords_x)
    cy = torch.where(finite, coords_y, torch.full_like(coords_y, -1e6))
    cx = torch.where(finite, coords_x, torch.full_like(coords_x, -1e6))
    i11, i12, i22, sqrt_det = _clamped_inverse_metric(cy, cx)

    yc = torch.round(cy).to(torch.int64)
    xc = torch.round(cx).to(torch.int64)
    flat_img = images.reshape(P, -1)
    flat_val = valid.reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    out = torch.zeros((P,) + tuple(coords_y.shape), dtype=torch.float32, device=dev)
    w_valid = torch.zeros(coords_y.shape, dtype=torch.float32, device=dev)
    w_all = torch.zeros(coords_y.shape, dtype=torch.float32, device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yy = yc + dy
            xx = xc + dx
            ddy = yy.to(torch.float32) - cy
            ddx = xx.to(torch.float32) - cx
            q = i11 * ddy * ddy + 2.0 * i12 * ddy * ddx + i22 * ddx * ddx
            w = torch.where(q <= trunc2, torch.exp(-0.5 * q / sigma2), zero)
            inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
            v = torch.where(inb, _gather(flat_val, idx), zero)
            wv = w * v
            for p in range(P):
                out[p] = out[p] + wv * _gather(flat_img[p], idx)
            w_valid = w_valid + wv
            w_all = w_all + w
    out = out / torch.clamp_min(w_valid, 1e-12)
    if conserve_flux:
        out = out * sqrt_det
    footprint = torch.where(finite, w_valid / torch.clamp_min(w_all, 1e-12), zero)
    return out, footprint


# DeForest/reproject-style defaults: a Gaussian of FWHM 1.3 output pixels
# truncated at +-2.6 output pixels (reproject.adaptive kernel_width=1.3,
# sample_region_width=4).
DEFAULT_KERNEL_WIDTH = 1.3
DEFAULT_SAMPLE_REGION_WIDTH = 4.0
_MAX_STENCIL_RADIUS = 8


def _stencil_radius(src_coords, trunc):
    """Static tap radius in source pixels: the truncation half-width in
    output pixels times the largest (clamped) singular value of the
    output->source Jacobian over the grid (host numpy, float64)."""
    cy = np.asarray(src_coords[0], dtype=np.float64)
    cx = np.asarray(src_coords[1], dtype=np.float64)
    dy_sy, dx_sy = np.gradient(cy)
    dy_sx, dx_sx = np.gradient(cx)
    a11 = dy_sy**2 + dx_sy**2
    a12 = dy_sy * dy_sx + dx_sy * dx_sx
    a22 = dy_sx**2 + dx_sx**2
    lam_max = 0.5 * (a11 + a22) + np.sqrt((0.5 * (a11 - a22)) ** 2 + a12**2)
    with np.errstate(invalid="ignore"):
        s_max = math.sqrt(max(float(np.nanmax(lam_max)), 1.0))
    return max(1, min(_MAX_STENCIL_RADIUS, int(math.ceil(trunc * s_max))))


def resample_layer(
    sci,
    var,
    src_coords,
    footprint_threshold=0.999,
    method="adaptive",
    kernel_width=DEFAULT_KERNEL_WIDTH,
    sample_region_width=DEFAULT_SAMPLE_REGION_WIDTH,
    conserve_flux=False,
    device=None,
):
    """Reproject one science/variance pair through precomputed source
    coordinates (2, Ho, Wo) on ``device`` (None: CUDA; "cpu" on the host).
    Output pixels touching any invalid source data are NaN-masked
    (conservative footprint, matching the masked-collision behavior of the
    reference mosaicking). Returns host numpy (sci, var, good).

    method : "adaptive" (anti-aliased Gaussian footprint, the reference's
        reproject_adaptive fidelity) or "bilinear" (fast 4-tap).
    kernel_width : Gaussian FWHM in output pixels (adaptive only).
    sample_region_width : truncation width in units of kernel_width.
    conserve_flux : multiply by |det J| so total flux (not surface
        brightness) is preserved under rescaling (adaptive only).
    """
    if method not in ("adaptive", "bilinear"):
        raise ValueError(f"Unknown resampling method {method!r}")
    dev = resolve_device(device)
    sci = np.asarray(sci, dtype=np.float32)
    var = np.asarray(var, dtype=np.float32)
    # The reference casts the float64 coordinates to float32 before the
    # device sees them.
    coords = np.asarray(src_coords, dtype=np.float32)
    if method == "adaptive":
        sigma = float(kernel_width) / (2.0 * math.sqrt(2.0 * math.log(2.0)))
        trunc = 0.5 * float(kernel_width) * float(sample_region_width)
        radius = _stencil_radius(src_coords, trunc)

    with tracing.span("reproject.upload"):
        planes_h = np.stack([sci, var])
        tracing.count("reproject.bytes_h2d", planes_h.nbytes + coords.nbytes)
        planes = torch.from_numpy(planes_h).to(dev)
        cy = torch.from_numpy(coords[0]).to(dev)
        cx = torch.from_numpy(coords[1]).to(dev)
    ok = torch.isfinite(planes[0]) & torch.isfinite(planes[1])
    planes = torch.where(ok, planes, torch.zeros((), dtype=torch.float32, device=dev))
    val = ok.to(torch.float32)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)

    tracing.count("reproject.taps", 4 if method == "bilinear" else (2 * radius + 1) ** 2)
    if method == "bilinear":
        out, foot = _bilinear_resample(planes, val, cy, cx)
        good = foot >= footprint_threshold
        out = torch.where(good, out / torch.clamp_min(foot, 1e-12), nan)
    else:
        out, foot = _adaptive_resample(planes, val, cy, cx, radius, sigma * sigma, trunc * trunc,
                                       bool(conserve_flux))
        good = foot >= footprint_threshold
        out = torch.where(good, out, nan)
    out = out.cpu().numpy()
    return out[0], out[1], good.cpu().numpy()


def compute_source_coordinates(src_wcs, dst_wcs, dst_shape):
    """(2, Ho, Wo) float64 source pixel coordinates for each target pixel:
    target pixel -> sky (dst WCS) -> source pixel (src WCS). Host math in
    float64 for sub-milliarcsecond accuracy."""
    Ho, Wo = dst_shape
    xx, yy = np.meshgrid(np.arange(Wo, dtype=np.float64), np.arange(Ho, dtype=np.float64))
    ra, dec = dst_wcs.pixel_to_world_values(xx, yy)
    sx, sy = src_wcs.world_to_pixel_values(ra, dec)
    return np.stack([sy, sx])
