"""Stamp-based result augmentation and CNN vetting.

Port of the JAX package's filters/stamp_filters.py (API-compatible with the
reference's kbmod.filters.stamp_filters): ``append_coadds`` adds coadd_*
stamp columns (optionally per calendar night), ``append_all_stamps`` adds
the (R, T, S, S) stamp cube, and ``filter_stamps_by_cnn`` classifies each
result's coadd with the ResNet of ``kbmod_tpu_torch.models.cnn`` (the
stamps normalized on the host, the network on the device).

The coadds are computed by ``kbmod_tpu_torch.ops.stamps.batched_coadds``:
the stamp windows are gathered from the per-time images on the host and
reduced on the device, one chunk of results at a time.
"""

import logging

import numpy as np

from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.ops.stamps import batched_coadds
from kbmod_tpu_torch.util_functions import mjd_to_day
from kbmod_tpu_torch.utils.debug_timer import DebugTimer

logger = logging.getLogger(__name__)


def _stack_arrays(im_stack):
    """The stack's per-time science and variance images, not stacked: the
    coadds gather their windows from them."""
    if not isinstance(im_stack, ImageStackPy):
        raise TypeError("im_stack must be an ImageStackPy")
    return im_stack.sci, im_stack.var


def append_coadds(result_data, im_stack, coadd_types, radius, valid_only=True, nightly=False, device=None):
    """Append coadd_{type} stamp columns (and coadd_{type}_{day} when
    ``nightly``) for every result, reduced on ``device`` (CUDA unless
    ``device="cpu"``). Modifies result_data in place."""
    if radius <= 0:
        raise ValueError(f"Invalid stamp radius {radius}")
    width = 2 * radius + 1
    num_res = len(result_data)

    valid_only = valid_only and "obs_valid" in result_data.colnames
    logger.info(f"Appending coadds {coadd_types} to results (radius={radius}, valid_only={valid_only})")
    stamp_timer = DebugTimer("computing extra coadds", logger)

    sci, var = _stack_arrays(im_stack)
    obs_valid = np.asarray(result_data["obs_valid"], dtype=bool) if valid_only else None

    if num_res == 0:
        for coadd_type in coadd_types:
            result_data.table[f"coadd_{coadd_type}"] = np.zeros((0, width, width), dtype=np.float32)
        stamp_timer.stop()
        return

    coadds = batched_coadds(
        sci, var, im_stack.zeroed_times,
        np.asarray(result_data["x"]), np.asarray(result_data["y"]),
        np.asarray(result_data["vx"]), np.asarray(result_data["vy"]),
        radius, list(coadd_types), obs_valid=obs_valid, device=device,
    )
    for coadd_type in coadd_types:
        result_data.table[f"coadd_{coadd_type}"] = coadds[coadd_type]

    if nightly:
        day_strs = np.array([f"_{mjd_to_day(t)}" for t in im_stack.times])
        for day in np.unique(day_strs):
            day_mask = day_strs == day
            if obs_valid is not None:
                night_valid = obs_valid & day_mask[None, :]
            else:
                night_valid = np.broadcast_to(day_mask[None, :], (num_res, len(day_strs))).copy()
            night_coadds = batched_coadds(
                sci, var, im_stack.zeroed_times,
                np.asarray(result_data["x"]), np.asarray(result_data["y"]),
                np.asarray(result_data["vx"]), np.asarray(result_data["vy"]),
                radius, list(coadd_types), obs_valid=night_valid, device=device,
            )
            for coadd_type in coadd_types:
                result_data.table[f"coadd_{coadd_type}{day}"] = night_coadds[coadd_type]
    stamp_timer.stop()


def append_all_stamps(result_data, im_stack, stamp_radius, device=None):
    """Append the full (R, T, S, S) stamp cube as the all_stamps column."""
    logger.info(f"Appending all stamps for {len(result_data)} results")
    stamp_timer = DebugTimer("computing all stamps", logger)
    if stamp_radius < 1:
        raise ValueError(f"Invalid stamp radius: {stamp_radius}")

    sci, var = _stack_arrays(im_stack)
    num_res = len(result_data)
    width = 2 * stamp_radius + 1
    if num_res == 0:
        result_data.table["all_stamps"] = np.zeros((0, im_stack.num_times, width, width), dtype=np.float32)
        stamp_timer.stop()
        return

    stamps = batched_coadds(
        sci, var, im_stack.zeroed_times,
        np.asarray(result_data["x"]), np.asarray(result_data["y"]),
        np.asarray(result_data["vx"]), np.asarray(result_data["vy"]),
        stamp_radius, ["all_stamps"], device=device,
    )
    result_data.table["all_stamps"] = stamps["all_stamps"]
    stamp_timer.stop()


def _normalize_stamps(stamps, stamp_dimm):
    """Normalize stamps for CNN input: clip the low tail at median -
    2*sigma_G, subtract the min, normalize to unit sum (reference
    stamp_filters.py:213-229)."""
    normed = []
    sigma_g_coeff = 0.7413
    for stamp in stamps:
        stamp = np.nan_to_num(np.copy(stamp), nan=0.0)
        per25, per50, per75 = np.percentile(stamp, [25, 50, 75])
        sigma_g = sigma_g_coeff * (per75 - per25)
        low = per50 - 2 * sigma_g
        stamp[stamp < low] = low
        stamp -= np.min(stamp)
        total = np.sum(stamp)
        if total != 0:
            stamp /= total
        stamp = np.nan_to_num(stamp, nan=0.0)
        normed.append(stamp.reshape(stamp_dimm, stamp_dimm))
    return np.array(normed)


def filter_stamps_by_cnn(
    result_data,
    model_path,
    model_type="resnet18",
    coadd_type="mean",
    stamp_radius=10,
    coadd_radius=11,
    verbose=False,
    device=None,
):
    """Classify each result's coadd stamp with the CNN on ``device`` (CUDA
    unless ``device="cpu"``), appending prob_real / prob_bogus / cnn_class
    columns. ``model_path`` is a weights file (see ``StampClassifier``);
    None runs an untrained network."""
    from kbmod_tpu_torch.models.cnn import StampClassifier

    coadd_column = f"coadd_{coadd_type}"
    if coadd_column not in result_data.colnames:
        raise ValueError("result_data does not have provided coadd type as a column.")

    stamps = np.asarray(result_data.table[coadd_column])
    if stamps.ndim < 3:
        stamps = np.array([s.reshape((coadd_radius * 2) + 1, (coadd_radius * 2) + 1) for s in stamps])

    dimm_diff = coadd_radius - stamp_radius
    if dimm_diff < 0:
        raise ValueError(f"Provided stamp_radius {stamp_radius} is too large for the coadd size {stamps.shape}")
    if dimm_diff > 0:
        stamps = stamps[:, dimm_diff:-dimm_diff, dimm_diff:-dimm_diff]

    stamp_dimm = (stamp_radius * 2) + 1
    normalized = _normalize_stamps(stamps, stamp_dimm)

    classifier = StampClassifier(model_type=model_type, stamp_width=stamp_dimm, model_path=model_path, device=device)
    predictions = classifier.predict(normalized)

    prob_real = predictions[:, 1]
    prob_bogus = predictions[:, 0]
    classifications = np.argmax(predictions, axis=1)
    result_data.table["prob_real"] = prob_real
    result_data.table["prob_bogus"] = prob_bogus
    result_data.table["cnn_class"] = classifications != 0
