"""WorkUnit reprojection to a common WCS.

Port of the JAX package's reprojection.py, API-compatible with the
reference's kbmod.reprojection (src/kbmod/reprojection.py): reproject every
image of a WorkUnit onto a common WCS, mosaicking same-obstime images into
single layers (overlap collisions masked), with optional "ebd" frame
(per-image barycentric parallax-corrected WCSes). The resampling runs on
``device`` (kbmod_tpu_torch.ops.reproject; None means CUDA, "cpu" the host)
one layer at a time, instead of a host process pool; the coordinates and
the mosaic are host numpy.
"""

import logging

import numpy as np

from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.ops.reproject import compute_source_coordinates, resample_layer
from kbmod_tpu_torch.reprojection_utils import transform_wcses_to_ebd
from kbmod_tpu_torch.work_unit import WorkUnit

logger = logging.getLogger(__name__)

__all__ = ["reproject_work_unit", "reproject_lazy_work_unit"]


def _get_combined_psf(psfs):
    """One PSF for a mosaicked layer: the first constituent's kernel,
    exactly as the reference does (reprojection.py:260 uses
    ``psfs[indices[0]]``; its lazy path's ``_get_first_psf_at_time``,
    reprojection.py:613-641, likewise returns the first PSF at the
    obstime). Constituents of a mosaic come from the same instrument and
    epoch, so their PSFs agree in practice."""
    return psfs[0]


def reproject_work_unit(
    work_unit,
    common_wcs,
    frame="original",
    parallelize=True,
    max_parallel_processes=8,
    write_output=False,
    directory=None,
    filename=None,
    show_progress=None,
    device=None,
):
    """Reproject a WorkUnit onto ``common_wcs``.

    Parameters
    ----------
    work_unit : `WorkUnit`
        The input (must not already be reprojected).
    common_wcs : `WCS`
        The target WCS; its array_shape sets the output image size.
    frame : `str`
        "original" reprojects from each image's own WCS; "ebd" first fits
        per-image barycentric (EBD) WCSes at the WorkUnit's
        barycentric_distance and reprojects from those.
    parallelize, max_parallel_processes : kept for API parity — the device
        resampling replaces host process-pool parallelism.
    write_output : bool
        When True, write the result to sharded FITS instead of returning.
    device : where the resampling runs (None: CUDA; "cpu": the host).

    Returns
    -------
    `WorkUnit` or None (when write_output).
    """
    if work_unit.reprojected:
        raise ValueError("Unable to reproject a reprojected WorkUnit.")
    if common_wcs.array_shape is None:
        raise ValueError("common_wcs must carry an array shape.")
    height, width = common_wcs.array_shape
    device = resolve_device(device)

    stack = work_unit.im_stack
    obstimes = np.asarray(work_unit.get_all_obstimes())
    per_image_wcs = [work_unit.get_wcs(i) for i in range(stack.num_times)]
    if any(w is None for w in per_image_wcs):
        raise ValueError("Every image needs a WCS to reproject.")

    # In the EBD frame, source coordinates run through the fitted
    # barycentric WCSes instead of the original ones.
    if frame == "ebd":
        if work_unit.barycentric_distance is None:
            raise ValueError("barycentric_distance is required for EBD reprojection.")
        src_wcs_list, geo_dists = transform_wcses_to_ebd(
            per_image_wcs,
            stack.width,
            stack.height,
            work_unit.barycentric_distance,
            obstimes,
            point_on_earth=work_unit.observatory,
            npoints=10,
            seed=101,
        )
        work_unit.org_img_meta["ebd_wcs"] = np.array(src_wcs_list, dtype=object)
        work_unit.org_img_meta["geocentric_distance"] = np.array(geo_dists, dtype=object)
    elif frame == "original":
        src_wcs_list = per_image_wcs
    else:
        raise ValueError(f"Invalid projection frame {frame}.")

    # Group images that share an obstime into mosaicked output layers.
    from kbmod_tpu_torch.util_functions import unique_obstimes_and_indices

    unique_times, groups = unique_obstimes_and_indices(obstimes)

    new_stack = ImageStackPy()
    per_image_indices = []
    for time, group in zip(unique_times, groups):
        mosaic_sci, mosaic_var = _mosaic_group(
            [stack.sci[idx] for idx in group],
            [stack.var[idx] for idx in group],
            [src_wcs_list[idx] for idx in group],
            common_wcs,
            (height, width),
            device,
        )
        psf = _get_combined_psf([stack.psfs[idx] for idx in group])
        new_stack.append_image(time, mosaic_sci, mosaic_var, psf=psf)
        per_image_indices.append(list(group))

    result = WorkUnit(
        im_stack=new_stack,
        config=work_unit.config,
        wcs=common_wcs,
        reprojected=True,
        reprojection_frame=frame,
        per_image_indices=per_image_indices,
        obstimes=obstimes,
        barycentric_distance=work_unit.barycentric_distance,
        org_image_meta=work_unit.org_img_meta,
        observatory=work_unit.observatory,
    )

    if write_output:
        if directory is None or filename is None:
            raise ValueError("write_output requires directory and filename.")
        result.to_sharded_fits(filename, directory, overwrite=True)
        return None
    return result


def _mosaic_group(sci_list, var_list, wcs_list, common_wcs, out_shape, device):
    """Reproject a group of same-obstime images onto ``common_wcs`` and
    mosaic them into one layer; pixels covered by more than one
    constituent (footprint collisions) are masked."""
    height, width = out_shape
    mosaic_sci = np.full((height, width), np.nan, dtype=np.float32)
    mosaic_var = np.full((height, width), np.nan, dtype=np.float32)
    n_contrib = np.zeros((height, width), dtype=np.int32)
    for sci, var, src_wcs in zip(sci_list, var_list, wcs_list):
        coords = compute_source_coordinates(src_wcs, common_wcs, (height, width))
        sci_r, var_r, good = resample_layer(sci, var, coords, device=device)
        mosaic_sci[good] = sci_r[good]
        mosaic_var[good] = var_r[good]
        n_contrib += good
    collision = n_contrib > 1
    mosaic_sci[collision] = np.nan
    mosaic_var[collision] = np.nan
    return mosaic_sci, mosaic_var


def reproject_lazy_work_unit(
    work_unit, common_wcs, directory, filename, frame="original", max_parallel_processes=8, order=None,
    device=None,
):
    """Reproject a lazy (sharded) WorkUnit, writing sharded output.

    Streams one unique-obstime group at a time (reference
    reprojection.py:470-565): only the shard files of the current group
    are loaded, the mosaicked layer is written to its output shard
    immediately, and the images are released before the next group —
    peak memory is bounded by one group plus one output layer, not the
    full stack. The resampling runs on ``device`` (None: CUDA).
    """
    import os
    from copy import copy

    from kbmod_tpu_torch.io import fits_io
    from kbmod_tpu_torch.work_unit import load_layered_image_from_shard

    if not work_unit.lazy:
        raise ValueError("Expected a lazy WorkUnit.")
    if common_wcs.array_shape is None:
        raise ValueError("common_wcs must carry an array shape.")
    height, width = common_wcs.array_shape
    device = resolve_device(device)

    obstimes = np.asarray(work_unit.get_all_obstimes())
    n_img = len(work_unit.file_paths)
    per_image_wcs = [work_unit.get_wcs(i) for i in range(n_img)]
    if any(w is None for w in per_image_wcs):
        raise ValueError("Every image needs a WCS to reproject.")

    if frame == "ebd":
        if work_unit.barycentric_distance is None:
            raise ValueError("barycentric_distance is required for EBD reprojection.")
        # WCS fitting needs image dimensions, not pixels: use the WCS
        # shape when present, else peek at the first shard's header.
        shape = per_image_wcs[0].array_shape
        if shape is None:
            first = load_layered_image_from_shard(work_unit.file_paths[0])
            shape = first.sci.shape
            del first
        src_wcs_list, geo_dists = transform_wcses_to_ebd(
            per_image_wcs,
            shape[1],
            shape[0],
            work_unit.barycentric_distance,
            obstimes,
            point_on_earth=work_unit.observatory,
            npoints=10,
            seed=101,
        )
        work_unit.org_img_meta["ebd_wcs"] = np.array(src_wcs_list, dtype=object)
        work_unit.org_img_meta["geocentric_distance"] = np.array(geo_dists, dtype=object)
    elif frame == "original":
        src_wcs_list = per_image_wcs
    else:
        raise ValueError(f"Invalid projection frame {frame}.")

    unique_times, groups = work_unit.get_unique_obstimes_and_indices()

    os.makedirs(directory, exist_ok=True)
    for layer_idx, (time, group) in enumerate(zip(unique_times, groups)):
        # Load ONLY this group's shards.
        images = [load_layered_image_from_shard(work_unit.file_paths[i]) for i in group]
        mosaic_sci, mosaic_var = _mosaic_group(
            [img.sci for img in images],
            [img.var for img in images],
            [src_wcs_list[i] for i in group],
            common_wcs,
            (height, width),
            device,
        )
        psf = _get_combined_psf([img.psf for img in images])

        sci_hdu = fits_io.ImageHDU(mosaic_sci.astype(np.float32), name=f"SCI_{layer_idx}")
        sci_hdu.header["MJD"] = float(time)
        shard = fits_io.HDUList(
            [
                fits_io.ImageHDU(name="PRIMARY"),
                sci_hdu,
                fits_io.ImageHDU(mosaic_var.astype(np.float32), name=f"VAR_{layer_idx}"),
                fits_io.ImageHDU(np.asarray(psf, dtype=np.float32), name=f"PSF_{layer_idx}"),
            ]
        )
        shard.writeto(os.path.join(directory, f"{layer_idx}_{filename}"), overwrite=True)
        del images, mosaic_sci, mosaic_var, shard  # release before the next group

    # Head file: the metadata of the (still image-less) WorkUnit with the
    # reprojection state applied; NUMIMG is the output layer count.
    head_unit = copy(work_unit)
    head_unit._per_image_indices = [list(g) for g in groups]
    head_unit.wcs = common_wcs
    head_unit.reprojected = True
    head_unit.reprojection_frame = frame
    hdul = head_unit.metadata_to_hdul()
    hdul["METADATA"].header["NUMIMG"] = len(groups)
    hdul.writeto(os.path.join(directory, filename), overwrite=True)
