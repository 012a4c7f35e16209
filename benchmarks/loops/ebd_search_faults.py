"""The faults of the reflex-corrected WorkUnit search loop, planted in the
program underneath a run for the check that ``correct`` comes out false
(``benchmarks/faults.py`` plants them; ``ebd_search`` names them as its
``FAULTS`` and ``CELL_SIZE_FAULTS``). Each takes an object with
``setattr(target, name, value)``, as pytest's monkeypatch fixture is.
The stack search's faults are the loop's too: the cell runs the same
search and results path after its reprojection.
"""

import numpy as np

from benchmarks.loops import stack_search_faults


def _frame_original(monkeypatch):
    """The reprojection runs in the original frame where the EBD frame was
    asked for: no reflex correction."""
    from kbmod_tpu_torch import reprojection

    reproject = reprojection.reproject_work_unit

    def faulty(work_unit, common_wcs, frame="original", **kwargs):
        return reproject(work_unit, common_wcs, frame="original", **kwargs)

    monkeypatch.setattr(reprojection, "reproject_work_unit", faulty)


def _positions_not_inverted(monkeypatch):
    """The results' per-image positions stay in the EBD frame: the inverse
    parallax returns its input."""
    from kbmod_tpu_torch import reprojection_utils
    from kbmod_tpu_torch.geom.wcs import SkyCoordLite

    def faulty(coords, obstimes, point_on_earth=None):
        return SkyCoordLite(np.asarray(coords.ra_deg), np.asarray(coords.dec_deg))

    monkeypatch.setattr(reprojection_utils, "invert_correct_parallax_vectorized", faulty)


def _overlaps_not_masked(monkeypatch):
    """The mosaic lays each constituent in, the later over the earlier, and
    masks no pixel that two of them cover."""
    from kbmod_tpu_torch import reprojection

    def faulty(sci_list, var_list, wcs_list, common_wcs, out_shape, device):
        sci_out = np.full(out_shape, np.nan, dtype=np.float32)
        var_out = np.full(out_shape, np.nan, dtype=np.float32)
        for sci, var, src_wcs in zip(sci_list, var_list, wcs_list):
            coords = reprojection.compute_source_coordinates(src_wcs, common_wcs, out_shape)
            s, v, good = reprojection.resample_layer(sci, var, coords, device=device)
            sci_out[good], var_out[good] = s[good], v[good]
        return sci_out, var_out

    monkeypatch.setattr(reprojection, "_mosaic_group", faulty)


def _coordinates_shifted(monkeypatch):
    """Every source coordinate of the resampling is half a pixel off on
    both axes."""
    from kbmod_tpu_torch import reprojection

    coords = reprojection.compute_source_coordinates

    def faulty(src_wcs, dst_wcs, dst_shape):
        return coords(src_wcs, dst_wcs, dst_shape) + 0.5

    monkeypatch.setattr(reprojection, "compute_source_coordinates", faulty)


def _fit_shifted(monkeypatch):
    """Every fitted EBD WCS is one pixel off in x."""
    from kbmod_tpu_torch import reprojection
    from kbmod_tpu_torch.geom.wcs import WCS

    fit = reprojection.transform_wcses_to_ebd

    def faulty(*args, **kwargs):
        wcses, dists = fit(*args, **kwargs)
        return [WCS(w.crpix + np.array([1.0, 0.0]), w.crval, w.cd, shape=w.array_shape) for w in wcses], dists

    monkeypatch.setattr(reprojection, "transform_wcses_to_ebd", faulty)


def _positions_shifted(monkeypatch):
    """The results' per-image positions are one pixel (0.263 arcsec) off in
    declination."""
    from kbmod_tpu_torch import reprojection_utils
    from kbmod_tpu_torch.geom.wcs import SkyCoordLite

    invert = reprojection_utils.invert_correct_parallax_vectorized

    def faulty(coords, obstimes, point_on_earth=None):
        out = invert(coords, obstimes, point_on_earth)
        return SkyCoordLite(np.asarray(out.ra_deg), np.asarray(out.dec_deg) + 0.263 / 3600.0)

    monkeypatch.setattr(reprojection_utils, "invert_correct_parallax_vectorized", faulty)


def _observer_heliocentric(monkeypatch):
    """The observer is placed from the Sun, not from the barycentre: the
    Sun's barycentric offset is left out."""
    from kbmod_tpu_torch.geom import ecliptic

    monkeypatch.setattr(ecliptic, "sun_barycentric_position", lambda mjd: np.zeros(np.shape(mjd) + (3,)))


FAULTS = dict(stack_search_faults.FAULTS, **{
    "frame original": _frame_original,
    "positions not inverted": _positions_not_inverted,
    "overlaps not masked": _overlaps_not_masked,
    "coordinates shifted by half a pixel": _coordinates_shifted,
    "EBD fit shifted by one pixel": _fit_shifted,
    "positions shifted by one pixel": _positions_shifted,
    "observer from the Sun": _observer_heliocentric,
})
CELL_SIZE_FAULTS = dict(stack_search_faults.CELL_SIZE_FAULTS)
