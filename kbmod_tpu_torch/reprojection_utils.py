"""Parallax (reflex) correction geometry: a copy of the JAX package's
reprojection_utils.py (host numpy, scipy for the minimizer).

API-compatible with the reference's kbmod.reprojection_utils
(src/kbmod/reprojection_utils.py): correct observed sky positions to the
view from the solar-system barycenter assuming a guessed barycentric
distance ("EBD" frame), the vectorized inverse, and barycentric WCS
fitting — implemented on kbmod_tpu_torch.geom (no astropy).

Geometry: with the Earth at equatorial position E (AU) and the observed
line-of-sight unit vector u, the object at assumed barycentric distance d
sits at P = E + s*u where |P| = d:

    s = -E.u + sqrt((E.u)^2 + d^2 - |E|^2)

(real for d greater than the Earth-barycenter distance, ~1.02 AU; the
reference falls back to a minimizer inside that radius,
reprojection_utils.py:25-260). The inverse projects P = d * unit(ra, dec)
back to the Earth's view.

Note: the Earth position comes from the self-contained barycentric
ephemeris (kbmod_tpu_torch.geom.ecliptic: geometric J2000 solar series plus the
Keplerian giant-planet Sun-barycenter offset), validated against the
reference's astropy/DE432s golden values to ~0.1 arcsec
(tests/test_reprojection.py::TestParallaxGoldenValues). When a
``point_on_earth`` site is given (geocentric meters, e.g.
WorkUnit.observatory) the observer is topocentric: the ITRS site vector
is rotated into J2000 via GMST + precession
(kbmod_tpu_torch.geom.ecliptic.observer_position_equatorial) — the diurnal
parallax this captures is up to ~8.8 arcsec/d_AU.
"""

import numpy as np

from kbmod_tpu_torch.geom.ecliptic import (
    earth_position_equatorial,
    observer_position_equatorial,
    radec_unit_vector,
    unit_vector_radec,
)
from kbmod_tpu_torch.geom.wcs import WCS, SkyCoordLite


def correct_parallax_geometrically_vectorized(ra, dec, mjds, heliocentric_distance, point_on_earth=None):
    """Correct observed (RA, Dec) for parallax at an assumed barycentric
    distance, vectorized.

    Parameters
    ----------
    ra, dec : array (N,) degrees — observed positions.
    mjds : array (N,) MJD times.
    heliocentric_distance : float — assumed barycentric distance (AU).
    point_on_earth : (x, y, z) geocentric meters or None
        The observing site (the reference passes an EarthLocation,
        reprojection_utils.py:25-120); None uses the geocenter.

    Returns
    -------
    (coord, geo_dists) : (SkyCoordLite of corrected positions with
        .distance_au set, np.ndarray of Earth-object distances in AU).
        Positions where no geometric solution exists return NaN.
    """
    ra = np.atleast_1d(np.asarray(ra, dtype=float))
    dec = np.atleast_1d(np.asarray(dec, dtype=float))
    mjds = np.atleast_1d(np.asarray(mjds, dtype=float))
    if len(mjds) == 1 and len(ra) > 1:
        mjds = np.full(len(ra), mjds[0])

    earth = observer_position_equatorial(mjds, point_on_earth)  # (N, 3)
    los = radec_unit_vector(ra, dec)  # (N, 3)

    e_dot_u = np.sum(earth * los, axis=-1)
    e_sq = np.sum(earth * earth, axis=-1)
    disc = e_dot_u**2 + heliocentric_distance**2 - e_sq
    valid = disc >= 0.0
    s = np.where(valid, -e_dot_u + np.sqrt(np.where(valid, disc, 0.0)), np.nan)
    # The object must be in front of the observer.
    valid &= s > 0.0
    s = np.where(valid, s, np.nan)

    obj = earth + s[..., None] * los
    out_ra, out_dec = unit_vector_radec(obj)
    out_ra = np.where(valid, out_ra, np.nan)
    out_dec = np.where(valid, out_dec, np.nan)

    coord = SkyCoordLite(out_ra, out_dec)
    coord.distance_au = np.full_like(out_ra, heliocentric_distance)
    return coord, s


def correct_parallax(coord, obstime, point_on_earth, heliocentric_distance, **kwargs):
    """Single-position parallax correction (reference
    reprojection_utils.py:25-120 interface).

    coord may be a SkyCoordLite or an (ra, dec) tuple in degrees.
    Returns (corrected SkyCoordLite, geocentric distance in AU).
    """
    if hasattr(coord, "ra_deg"):
        ra, dec = float(np.asarray(coord.ra_deg)), float(np.asarray(coord.dec_deg))
    else:
        ra, dec = coord
    out, s = correct_parallax_geometrically_vectorized(
        [ra], [dec], [float(obstime)], heliocentric_distance, point_on_earth
    )
    return SkyCoordLite(out.ra_deg[0], out.dec_deg[0]), float(s[0])


def invert_correct_parallax_vectorized(coords, obstimes, point_on_earth=None):
    """Invert the parallax correction: from barycentric positions (with
    .distance_au or astropy-style .distance) back to the geocentric view at
    ``obstimes``. Vectorized over coords.
    """
    ra = np.atleast_1d(np.asarray(coords.ra_deg if hasattr(coords, "ra_deg") else coords.ra.deg, dtype=float))
    dec = np.atleast_1d(np.asarray(coords.dec_deg if hasattr(coords, "dec_deg") else coords.dec.deg, dtype=float))
    if hasattr(coords, "distance_au"):
        dist = np.atleast_1d(np.asarray(coords.distance_au, dtype=float))
    else:
        dist = np.atleast_1d(np.asarray(coords.distance.value, dtype=float))
    mjds = np.atleast_1d(np.asarray(obstimes, dtype=float))
    if len(mjds) == 1 and len(ra) > 1:
        mjds = np.full(len(ra), mjds[0])

    obj = dist[..., None] * radec_unit_vector(ra, dec)  # barycentric position
    earth = observer_position_equatorial(mjds, point_on_earth)
    rel = obj - earth
    out_ra, out_dec = unit_vector_radec(rel)
    return SkyCoordLite(out_ra, out_dec)


def invert_correct_parallax(coord, obstime, point_on_earth=None, geocentric_distance=None, heliocentric_distance=None):
    """Single-position inverse parallax correction."""
    dist = heliocentric_distance
    if dist is None and hasattr(coord, "distance_au"):
        dist = coord.distance_au
    ra = float(np.asarray(coord.ra_deg))
    dec = float(np.asarray(coord.dec_deg))
    c = SkyCoordLite([ra], [dec])
    c.distance_au = np.array([dist])
    out = invert_correct_parallax_vectorized(c, [float(obstime)], point_on_earth)
    return SkyCoordLite(out.ra_deg[0], out.dec_deg[0])


def fit_barycentric_wcs(
    original_wcs, width, height, heliocentric_distance, obstime, point_on_earth=None, npoints=10, seed=None
):
    """Fit a TAN WCS describing the image in the barycentric ("EBD") frame:
    sample image pixels, parallax-correct their sky positions, and fit a
    new WCS to the corrected grid (reference reprojection_utils.py:434-520).

    Returns (ebd_wcs, geocentric_distance).
    """
    rng = np.random.default_rng(seed)
    # A deterministic grid plus random jitter of sample points.
    xs = np.concatenate([np.linspace(0, width - 1, npoints), rng.uniform(0, width - 1, npoints)])
    ys = np.concatenate([np.linspace(0, height - 1, npoints), rng.uniform(0, height - 1, npoints)])
    ra, dec = original_wcs.pixel_to_world_values(xs, ys)
    corrected, geo_dists = correct_parallax_geometrically_vectorized(
        ra, dec, np.full(len(xs), float(obstime)), heliocentric_distance, point_on_earth
    )

    # Fit crval from the center pixel and the CD matrix by least squares on
    # the tangent-plane offsets.
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    cra, cdec = original_wcs.pixel_to_world_values(cx, cy)
    ccoord, _ = correct_parallax_geometrically_vectorized(
        [cra], [cdec], [float(obstime)], heliocentric_distance, point_on_earth
    )
    crval = [float(ccoord.ra_deg[0]), float(ccoord.dec_deg[0])]

    # Build a trial WCS with the original CD and refine by solving the
    # linear map from pixel offsets to tangent-plane coordinates.
    trial = WCS([cx + 1.0, cy + 1.0], crval, original_wcs.cd, shape=(height, width))
    # Tangent-plane coordinates of the corrected sample points.
    u, v = trial.world_to_pixel_values(corrected.ra_deg, corrected.dec_deg)
    du = np.stack([xs - cx, ys - cy], axis=1)
    dv = np.stack([u - cx, v - cy], axis=1)
    # Solve dv = du @ M for M (2x2); new CD = M^T applied after original.
    M, *_ = np.linalg.lstsq(du, dv, rcond=None)
    new_cd = trial.cd @ M.T
    ebd_wcs = WCS([cx + 1.0, cy + 1.0], crval, new_cd, shape=(height, width))
    return ebd_wcs, float(np.nanmean(geo_dists))


def transform_wcses_to_ebd(wcs_list, width, height, heliocentric_distance, obstimes, point_on_earth=None, npoints=10, seed=None):
    """Fit EBD WCSes for a list of per-image WCSes.

    Returns (list of ebd WCS, list of geocentric distances)."""
    ebd_wcs_list = []
    geo_dists = []
    for wcs, t in zip(wcs_list, obstimes):
        ebd_wcs, dist = fit_barycentric_wcs(wcs, width, height, heliocentric_distance, t, point_on_earth, npoints, seed)
        ebd_wcs_list.append(ebd_wcs)
        geo_dists.append(dist)
    return ebd_wcs_list, geo_dists


def correct_parallax_geometrically(coord, obstime, point_on_earth, barycentric_distance):
    """Scalar geometric parallax correction (reprojection_utils.py:185-243):
    alias of correct_parallax, valid for distances beyond the Earth's
    barycentric radius (~1.02 AU)."""
    return correct_parallax(coord, obstime, point_on_earth, barycentric_distance)


def correct_parallax_with_minimizer(
    coord, obstime, point_on_earth, barycentric_distance, geocentric_distance=None, **kwargs
):
    """Minimizer-based parallax correction (reprojection_utils.py:91-183):
    finds the observer-object range ``s`` whose implied barycentric radius
    best matches ``barycentric_distance``. Handles distances inside the
    Earth's orbit, where the geometric solution has no real root."""
    from scipy.optimize import minimize_scalar

    if hasattr(coord, "ra_deg"):
        ra, dec = float(np.asarray(coord.ra_deg)), float(np.asarray(coord.dec_deg))
    else:
        ra, dec = coord
    earth = earth_position_equatorial(float(obstime))
    u = radec_unit_vector(ra, dec)

    def loss(s):
        return abs(np.linalg.norm(earth + s * u) - barycentric_distance)

    upper = barycentric_distance + 2.0
    res = minimize_scalar(loss, bounds=(0.0, upper), method="bounded")
    s = float(res.x)
    pos = earth + s * u
    ra_c, dec_c = unit_vector_radec(pos / np.linalg.norm(pos))
    out = SkyCoordLite(float(ra_c), float(dec_c))
    out.distance_au = float(np.linalg.norm(pos))
    return out, s


def image_positions_to_original_icrs(
    image_indices,
    positions,
    reprojected_wcs,
    original_wcses,
    all_times,
    observatory=None,
    input_format="xy",
    output_format="xy",
    filter_in_frame=True,
    reprojection_frame="original",
    barycentric_distance=None,
    geocentric_distances=None,
    per_image_indices=None,
    image_locations=None,
):
    """Module-level position inverse mapping (reprojection_utils.py:543+):
    common-frame (possibly EBD) positions back to the original per-image
    ICRS frames. The WorkUnit method wraps this for its own metadata."""
    if input_format not in ("xy", "radec"):
        raise ValueError(f"Input format {input_format} not supported.")
    if output_format not in ("xy", "radec"):
        raise ValueError(f"Output format {output_format} not supported.")
    all_times = np.asarray(all_times, dtype=float)
    if per_image_indices is None:
        per_image_indices = [[i] for i in range(len(original_wcses))]

    results = []
    for idx, pos in zip(np.atleast_1d(image_indices), positions):
        idx = int(idx)
        if input_format == "xy":
            ra, dec = reprojected_wcs.pixel_to_world_values(float(pos[0]), float(pos[1]))
        else:
            ra, dec = float(pos.ra_deg), float(pos.dec_deg)
        ra, dec = float(ra), float(dec)

        if reprojection_frame == "ebd":
            if barycentric_distance is None:
                raise ValueError("EBD inversion requires barycentric_distance.")
            coord = SkyCoordLite(ra, dec)
            coord.distance_au = float(barycentric_distance)
            c = SkyCoordLite(np.array([ra]), np.array([dec]))
            c.distance_au = np.array([float(barycentric_distance)])
            inv = invert_correct_parallax_vectorized(c, np.array([all_times[idx]]))
            ra, dec = float(np.asarray(inv.ra_deg)[0]), float(np.asarray(inv.dec_deg)[0])

        entry = None
        for const in per_image_indices[idx]:
            wcs = original_wcses[const]
            if wcs is None:
                continue
            x, y = wcs.world_to_pixel_values(ra, dec)
            h = int(2 * wcs.crpix[1])
            w = int(2 * wcs.crpix[0])
            in_frame = 0 <= x < w and 0 <= y < h
            if in_frame or not filter_in_frame:
                entry = (float(x), float(y)) if output_format == "xy" else (ra, dec)
                break
        results.append(entry)
    return results
