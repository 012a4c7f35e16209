"""Small shared utility functions: a copy of the JAX package's
util_functions.py (reference: src/kbmod/util_functions.py). pandas is
imported only by ``unravel_results`` and ``make_manual_tracklets``."""

import numpy as np

__all__ = [
    "get_matched_obstimes",
    "mjd_to_day",
    "load_deccam_layered_image",
    "get_unique_obstimes",
    "unique_obstimes_and_indices",
    "get_magnitude",
    "unravel_results",
    "make_manual_tracklets",
]


def get_matched_obstimes(obstimes, query_times, threshold=0.0007):
    """For each query time, the index of the closest obstime within
    ``threshold`` days, or -1.

    Parameters
    ----------
    obstimes : array-like
        The observation times (MJD), assumed sorted ascending.
    query_times : array-like
        The times to match.
    threshold : float
        Maximum allowed difference in days (default ~1 minute).
    """
    obstimes = np.asarray(obstimes, dtype=float)
    query_times = np.atleast_1d(np.asarray(query_times, dtype=float))

    # Bound the array by +/- inf so every query has neighbors on both sides.
    all_times = np.concatenate([[-np.inf], obstimes, [np.inf]])
    right = np.searchsorted(all_times, query_times, side="left")
    right_dist = np.abs(all_times[right] - query_times)
    left_dist = np.abs(all_times[right - 1] - query_times)

    use_right = left_dist > right_dist
    min_dist = np.where(use_right, right_dist, left_dist)
    min_inds = np.where(use_right, right, right - 1)

    # Shift back for the -inf sentinel; -1 marks no match within threshold.
    return np.where(min_dist <= threshold, min_inds - 1, -1)


def mjd_to_day(mjd):
    """Convert an MJD timestamp to a YYYY-MM-DD day string (UTC)."""
    from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime

    return mjd_to_datetime(mjd).strftime("%Y-%m-%d")


def load_deccam_layered_image(filename, psf):
    """Load a legacy DECam FITS file (HDUs: header, science, mask,
    variance) into a LayeredImagePy (reference util_functions.py:68-118)."""
    import os
    from itertools import product

    from kbmod_tpu_torch.core.image_stack_py import LayeredImagePy
    from kbmod_tpu_torch.io import fits_io

    if not os.path.isfile(filename):
        raise FileNotFoundError(f"{filename} not found")

    hdul = fits_io.read_fits(filename)
    if len(hdul) < 4:
        raise ValueError("Not enough extensions for legacy deccam format")

    # Key-major sweep over a few header keys and the first two extensions,
    # matching the reference's ``product(keys, exts)`` resolution order.
    obstime = -1.0
    for key, ext in product(("MJD", "DATE-AVG", "MJD-OBS"), (0, 1)):
        header = hdul[ext].header
        if key in header:
            value = header[key]
            if isinstance(value, float):
                obstime = float(value)
                break
            if isinstance(value, str):
                import datetime as dt

                from kbmod_tpu_torch.geom.time_utils import datetime_to_mjd

                obstime = datetime_to_mjd(dt.datetime.fromisoformat(value))
                break

    return LayeredImagePy(
        np.asarray(hdul[1].data, dtype=np.float32),
        np.asarray(hdul[3].data, dtype=np.float32),
        mask=np.asarray(hdul[2].data, dtype=np.float32),
        time=obstime,
        psf=getattr(psf, "kernel", psf),
    )


def get_unique_obstimes(all_obstimes):
    """Unique observation times and the index groups sharing each time."""
    all_obstimes = np.asarray(all_obstimes)
    unique_obstimes = np.unique(all_obstimes)
    unique_indices = [list(np.where(all_obstimes == t)[0]) for t in unique_obstimes]
    return unique_obstimes, unique_indices


def unique_obstimes_and_indices(obstimes, threshold=0.0007):
    """Group observation times that fall within ``threshold`` days.

    Returns (unique_times, per_time_index_groups)."""
    obstimes = np.asarray(obstimes, dtype=float)
    order = np.argsort(obstimes)
    unique_times = []
    groups = []
    for idx in order:
        t = obstimes[idx]
        if unique_times and abs(t - unique_times[-1]) <= threshold:
            groups[-1].append(int(idx))
        else:
            unique_times.append(float(t))
            groups.append([int(idx)])
    return unique_times, groups


def get_magnitude(flux, zero_point):
    """flux -> magnitude with the given zero point."""
    return -2.5 * np.log10(flux) + zero_point


def unravel_results(results, image_collection=None, obscode="X05", batch_id=None, first_and_last=False):
    """Flatten a Results table into one row per (result, valid observation)
    with sky positions and magnitudes — tracklet-style output.

    Requires img_ra/img_dec columns (from append_positions_to_results) and
    mjd_mid metadata; the zero point comes from the image collection's
    zeroPoint column when available (default 31.0).

    Returns a pandas DataFrame with columns id, ra, dec, magnitude, mjd,
    band, obscode.
    """
    import pandas as pd

    if "img_ra" not in results.colnames or "img_dec" not in results.colnames:
        raise ValueError("Results must have img_ra/img_dec columns (run append_positions_to_results).")
    if results.mjd_mid is None:
        raise ValueError("Results must carry mjd_mid metadata.")

    zp = 31.0
    bands = None
    if image_collection is not None:
        if "zeroPoint" in image_collection.columns:
            zp = float(np.mean(np.asarray(image_collection["zeroPoint"], dtype=float)))
        if "filter" in image_collection.columns:
            bands = [str(b) for b in image_collection["filter"]]

    mjds = np.asarray(results.mjd_mid)
    num_times = len(mjds)
    rows = []
    for res_idx in range(len(results)):
        valid = (
            np.asarray(results["obs_valid"][res_idx], dtype=bool)
            if "obs_valid" in results.colnames
            else np.ones(num_times, dtype=bool)
        )
        obs_inds = np.nonzero(valid)[0]
        if first_and_last and len(obs_inds) > 2:
            obs_inds = [obs_inds[0], obs_inds[-1]]
        mag = get_magnitude(max(float(results["flux"][res_idx]), 1e-12), zp)
        for obs_idx in obs_inds:
            prefix = f"{batch_id}-" if batch_id is not None else ""
            rows.append(
                {
                    "id": f"{prefix}{res_idx}-{obs_idx}",
                    "ra": float(results["img_ra"][res_idx][obs_idx]),
                    "dec": float(results["img_dec"][res_idx][obs_idx]),
                    "magnitude": mag,
                    "mjd": float(mjds[obs_idx]),
                    "band": bands[obs_idx] if bands is not None and obs_idx < len(bands) else "r",
                    "obscode": obscode,
                }
            )
    return pd.DataFrame(rows)


def make_manual_tracklets(df):
    """Build tracklet pairing rows (first/last observation per object) from
    an unravelled observation DataFrame."""
    import pandas as pd

    groups = {}
    for _, row in df.iterrows():
        obj = str(row["id"]).rsplit("-", 1)[0]
        groups.setdefault(obj, []).append(row)
    out = []
    for obj, rows in groups.items():
        rows = sorted(rows, key=lambda r: r["mjd"])
        out.append(
            {
                "object": obj,
                "mjd_start": rows[0]["mjd"],
                "mjd_end": rows[-1]["mjd"],
                "ra_start": rows[0]["ra"],
                "dec_start": rows[0]["dec"],
                "ra_end": rows[-1]["ra"],
                "dec_end": rows[-1]["dec"],
                "num_obs": len(rows),
            }
        )
    return pd.DataFrame(out)
