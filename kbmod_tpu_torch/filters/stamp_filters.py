"""Stamp-based result augmentation (and, later, CNN vetting).

Port of the JAX package's filters/stamp_filters.py (API-compatible with the
reference's kbmod.filters.stamp_filters): ``append_coadds`` adds coadd_*
stamp columns (optionally per calendar night) and ``append_all_stamps``
adds the (R, T, S, S) stamp cube. ``filter_stamps_by_cnn`` waits for the
port of the CNN (ROADMAP Queue 1 item 4) and raises NotImplementedError.

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


def filter_stamps_by_cnn(
    result_data,
    model_path,
    model_type="resnet18",
    coadd_type="mean",
    stamp_radius=10,
    coadd_radius=11,
    verbose=False,
):
    """Classify each result's coadd stamp with the CNN (not ported yet: the
    CNN is ROADMAP Queue 1 item 4)."""
    raise NotImplementedError(
        "filter_stamps_by_cnn: the CNN stamp classifier is not ported to kbmod_tpu_torch yet "
        "(ROADMAP Queue 1 item 4, stamp vetting)"
    )
