"""Brightness-consistency filtering.

Port of the JAX package's filters/brightness_filters.py, behavior-compatible
with the reference's kbmod.filters.brightness_filters
(src/kbmod/filters/brightness_filters.py, adapted there from W. Fraser's
pkbmod): score constant-brightness hypotheses against each candidate's
science/variance pixel curves with a variance-weighted squared distance,
and drop candidates whose best brightness lands on an extreme multiplier
(a sign the flux estimate is outlier-driven). The curves are read on the
host; the (R, C) scores are computed in torch on the device (CUDA unless
``device="cpu"``).
"""

import numpy as np
import torch

from kbmod_tpu_torch.core.stamp_utils import extract_curve_values
from kbmod_tpu_torch.device import resolve_device


def extract_sci_var_curves(res, stack, keep_nans=True, append=True):
    """Science/variance pixel curves at each candidate's predicted
    positions; NaN (or 0 / 1e10) outside the image."""
    zt = np.asarray(stack.zeroed_times)
    x_pos = (np.asarray(res["x"])[:, None] + zt * np.asarray(res["vx"])[:, None] + 0.5).astype(int)
    y_pos = (np.asarray(res["y"])[:, None] + zt * np.asarray(res["vy"])[:, None] + 0.5).astype(int)

    sci_curves = extract_curve_values(stack.sci, x_pos, y_pos)
    var_curves = extract_curve_values(stack.var, x_pos, y_pos)
    if not keep_nans:
        sci_curves[np.isnan(sci_curves)] = 0
        var_curves[np.isnan(var_curves)] = 1e10

    if append:
        res.table["sci_curve"] = sci_curves
        res.table["var_curve"] = var_curves
    return sci_curves, var_curves


def _scores(sci, var, candidates):
    """sci, var: (R, T); candidates: (R, C), float32 tensors on one device.
    Returns the (R, C) scores sum_t (sci - c)^2 / var over unmasked samples
    (masked: NaN sci or var, or var <= 0, which score 0)."""
    masked = torch.isnan(sci) | (var <= 0) | torch.isnan(var)
    zero = torch.zeros((), dtype=torch.float32, device=sci.device)
    big = torch.full((), 1e10, dtype=torch.float32, device=sci.device)
    sci_c = torch.where(masked, zero, sci)[:, :, None]
    var_c = torch.where(masked, big, var)[:, :, None]
    diff = sci_c - candidates[:, None, :]
    return (diff * diff / var_c).sum(dim=1)


def score_brightness_candidates(sci_curves, var_curves, brightness_candidates, device=None):
    """Variance-weighted squared-distance scores for brightness hypotheses.

    brightness_candidates: (C,) shared across results or (R, C) per-result.
    Returns (R, C) scores as numpy (lower = better fit).
    """
    dev = resolve_device(device)
    sci = torch.as_tensor(np.asarray(sci_curves, dtype=np.float32), device=dev)
    var = torch.as_tensor(np.asarray(var_curves, dtype=np.float32), device=dev)
    cand = np.asanyarray(brightness_candidates, dtype=np.float32)
    if cand.ndim == 1:
        cand = np.broadcast_to(cand[None, :], (sci.shape[0], len(cand)))
    elif len(cand) != sci.shape[0]:
        raise ValueError("Brightness candidates must have the same number of results as sci_curves.")
    return _scores(sci, var, torch.as_tensor(np.ascontiguousarray(cand), device=dev)).cpu().numpy()


def local_search_brightness(
    sci_curves,
    var_curves,
    brightness=None,
    offsets=[0.5, 0.75, 0.9, 0.95, 0.99, 1.0, 1.01, 1.05, 1.1, 1.25, 1.5],
    device=None,
):
    """Search multiplicative offsets of a center brightness for the best fit
    per result. Returns (best_brightness, best_idx)."""
    sci_curves = np.asanyarray(sci_curves)
    var_curves = np.asanyarray(var_curves)
    num_results = sci_curves.shape[0]
    if sci_curves.shape != var_curves.shape:
        raise ValueError(
            f"var_curves and sci_curves must have the same shape: {var_curves.shape} vs {sci_curves.shape}."
        )
    if brightness is None:
        brightness = np.nanmedian(sci_curves, axis=1)
    elif len(brightness) != num_results:
        raise ValueError(f"Brightness must have the same number of elements as sci_curves ({num_results}).")
    else:
        brightness = np.asanyarray(brightness)

    candidates = brightness[:, None] * np.asanyarray(offsets)[None, :]
    scores = score_brightness_candidates(sci_curves, var_curves, candidates, device=device)
    best_idx = np.argmin(scores, axis=1)
    best_brightness = candidates[np.arange(num_results), best_idx]
    return best_brightness, best_idx


def apply_brightness_search_filter(
    results, im_stack, offsets=[0.2, 0.9, 1.0, 1.1, 5.0], save_curves=True, device=None
):
    """Drop results whose best-fit brightness is an extreme multiplier of
    the estimated flux (outlier-driven flux)."""
    if "sci_curve" in results.colnames and "var_curve" in results.colnames:
        sci_curves = np.asarray(results["sci_curve"])
        var_curves = np.asarray(results["var_curve"])
    else:
        sci_curves, var_curves = extract_sci_var_curves(results, im_stack, append=save_curves)

    _, best_idx = local_search_brightness(
        sci_curves, var_curves, brightness=np.asarray(results["flux"]), offsets=offsets, device=device
    )
    keep_mask = np.isin(best_idx, [0, len(offsets) - 1], invert=True)
    results.filter_rows(keep_mask, "local_brightness_search")
