"""Stamp (cutout) extraction and coaddition.

Port of the JAX package's core/stamp_utils.py (host numpy), API-compatible
with the reference's kbmod.core.stamp_utils (src/kbmod/core/stamp_utils.py),
replacing its numba kernels with vectorized numpy; the batched device path
used by the stamp filters lives in kbmod_tpu_torch.ops.stamps.

Stamps are (2R+1)^2 cutouts centered on a trajectory's predicted position
at each time; pixels beyond the image edge are NaN-padded. Note the
reference predicts stamp centers with ``int(x + v*t + 0.5)`` (truncation,
stamp_utils.py:202-203), not floor; we preserve that.
"""

import warnings

import numpy as np

from kbmod_tpu_torch.core.image_stack_py import ImageStackPy


def _resolve_time_mask(to_include, num_times):
    if to_include is None:
        return None
    to_include = np.asarray(to_include)
    if to_include.dtype == bool:
        if len(to_include) != num_times:
            raise ValueError("Time mask must have the same length as the number of times.")
        return to_include
    mask = np.full(num_times, False)
    mask[to_include.astype(int)] = True
    return mask


def extract_stamp(img, x_val, y_val, radius):
    """Extract a single (2R+1)x(2R+1) stamp centered at (x_val, y_val),
    NaN-padded outside the image."""
    img = np.asarray(img)
    H, W = img.shape
    size = 2 * radius + 1
    stamp = np.full((size, size), np.nan, dtype=img.dtype)
    y_lo, y_hi = y_val - radius, y_val + radius + 1
    x_lo, x_hi = x_val - radius, x_val + radius + 1
    iy_lo, iy_hi = max(y_lo, 0), min(y_hi, H)
    ix_lo, ix_hi = max(x_lo, 0), min(x_hi, W)
    if iy_lo < iy_hi and ix_lo < ix_hi:
        stamp[iy_lo - y_lo : iy_hi - y_lo, ix_lo - x_lo : ix_hi - x_lo] = img[iy_lo:iy_hi, ix_lo:ix_hi]
    return stamp


def extract_stamp_stack(imgs, x_vals, y_vals, radius, to_include=None):
    """Stamps at per-time centers for one trajectory.

    imgs may be a (T, H, W) array or a length-T list of (H, W) arrays;
    returns the matching container type of (2R+1)^2 stamps for the selected
    times."""
    num_times = len(imgs)
    if radius < 1:
        raise ValueError("Radius must be at least 1.")
    if len(x_vals) != num_times or len(y_vals) != num_times:
        raise ValueError("X and Y values must have the same length as the number of times.")

    time_mask = _resolve_time_mask(to_include, num_times)
    if num_times == 0 or (time_mask is not None and np.count_nonzero(time_mask) == 0):
        warnings.warn("No images selected in to_include; returning empty stamp stack.")
        return [] if isinstance(imgs, list) else np.empty((0, 2 * radius + 1, 2 * radius + 1))

    x_vals = np.asarray(x_vals, dtype=int)
    y_vals = np.asarray(y_vals, dtype=int)
    indices = np.arange(num_times) if time_mask is None else np.nonzero(time_mask)[0]

    stamps = [extract_stamp(imgs[t], x_vals[t], y_vals[t], radius) for t in indices]
    if isinstance(imgs, list):
        return stamps
    return np.stack(stamps) if stamps else np.empty((0, 2 * radius + 1, 2 * radius + 1))


def extract_curve_values(imgs, x_vals, y_vals):
    """Pixel values at predicted positions; NaN outside the image.

    x_vals/y_vals: length-T arrays or (R, T) matrices; returns matching
    shape."""
    num_times = len(imgs)
    x_vals = np.asanyarray(x_vals, dtype=int)
    squeeze = x_vals.ndim == 1
    if x_vals.ndim == 1:
        x_vals = x_vals[None, :]
    y_vals = np.asanyarray(y_vals, dtype=int)
    if y_vals.ndim == 1:
        y_vals = y_vals[None, :]
    if x_vals.shape[1] != num_times:
        raise ValueError(f"X values must have the same length as times ({num_times}).")
    if y_vals.shape[1] != num_times:
        raise ValueError(f"Y values must have the same length as times ({num_times}).")
    if x_vals.shape[0] != y_vals.shape[0]:
        raise ValueError("X and Y values must have the same number of results.")

    if isinstance(imgs, list):
        H, W = imgs[0].shape
        stack = None
    else:
        stack = np.asarray(imgs)
        _, H, W = stack.shape

    values = np.full(x_vals.shape, np.nan, dtype=np.float32)
    for t in range(num_times):
        img = imgs[t] if stack is None else stack[t]
        xs = x_vals[:, t]
        ys = y_vals[:, t]
        inb = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        values[inb, t] = img[ys[inb], xs[inb]]
    return values.flatten() if squeeze else values


def predict_stamp_centers(trj, zeroed_times):
    """Integer stamp centers for a trajectory: int(x + v*t + 0.5) with the
    reference's truncation semantics (stamp_utils.py:202-203)."""
    xvals = (trj.x + np.asarray(zeroed_times) * trj.vx + 0.5).astype(int)
    yvals = (trj.y + np.asarray(zeroed_times) * trj.vy + 0.5).astype(int)
    return xvals, yvals


def create_stamps_from_image_stack_xy(stack, radius, xvals, yvals, to_include=None):
    """Stamps from an ImageStackPy's science layers at given centers."""
    if not isinstance(stack, ImageStackPy):
        raise ValueError("Invalid image stack type.")
    return extract_stamp_stack(stack.sci, xvals, yvals, radius, to_include=to_include)


def create_stamps_from_image_stack(stack, trj, radius, to_include=None):
    """Stamps from an ImageStackPy along a trajectory's predicted path."""
    xvals, yvals = predict_stamp_centers(trj, stack.zeroed_times)
    return create_stamps_from_image_stack_xy(stack, radius, xvals, yvals, to_include=to_include)


# ----------------------------------------------------------------------
# Coadds
# ----------------------------------------------------------------------

def _mask_all_nans(stack):
    """Zero out pixels that are NaN at every time (so nan-reducers return 0
    instead of warning)."""
    stack = np.asarray(stack)
    never_valid = np.all(np.isnan(stack), axis=0)
    if np.any(never_valid):
        stack = stack.copy()
        stack[:, never_valid] = 0.0
    return stack


def coadd_sum(stack):
    """NaN-ignoring sum over the time axis."""
    return np.nansum(stack, axis=0)


def coadd_mean(stack):
    """NaN-ignoring mean over the time axis (all-NaN pixels -> 0)."""
    stack = np.asarray(stack)
    if stack.shape[0] == 0:
        return np.zeros(stack.shape[1:], dtype=stack.dtype)
    return np.nanmean(_mask_all_nans(stack), axis=0)


def coadd_median(stack, device=None):
    """NaN-ignoring median over the time axis (all-NaN pixels -> 0).

    Uses the *lower* median for even counts, matching the torch.nanmedian
    semantics of the reference (stamp_utils.py:300-303)."""
    stack = np.asarray(stack)
    if stack.shape[0] == 0:
        return np.zeros(stack.shape[1:], dtype=stack.dtype)
    sorted_vals = np.sort(stack, axis=0)  # NaNs sort to the end
    count = np.sum(np.isfinite(stack), axis=0)
    idx = np.maximum((count - 1) // 2, 0)
    med = np.take_along_axis(sorted_vals, idx[None, ...], axis=0)[0]
    return np.where(count > 0, med, 0.0)


def coadd_weighted(stack, var_stack):
    """Inverse-variance weighted mean over the time axis."""
    stack = _mask_all_nans(stack)
    var_stack = np.asarray(var_stack)
    valid = ~(np.isnan(stack) | np.isnan(var_stack) | (var_stack == 0.0))
    weights = np.where(valid, 1.0 / np.where(valid, var_stack, 1.0), 0.0)
    weighted_sum = np.sum(np.where(valid, stack, 0.0) * weights, axis=0)
    sum_of_weights = np.sum(weights, axis=0)
    sum_of_weights[sum_of_weights == 0.0] = 1e24
    return weighted_sum / sum_of_weights
