"""Synthetic source injection and recovery matching.

Behavior-compatible with the reference's kbmod.injection
(src/kbmod/injection.py): generate ecliptic-aligned synthetic catalogs
with sub-pixel/velocity jitter (optionally inverse-EBD-corrected), inject
them into image data, and match search results against the injected
catalog to measure recovery rates. The Rubin ``VisitInjectTask`` path is
replaced by direct PSF-shaped injection into ImageStackPy/WorkUnit data
(the LSST-pipeline path requires the optional LSST stack).

Copy of the JAX package's injection.py (host code): the same seed gives the
same catalogs, and the injection writes into the host image stack, before
the search builds its planes on the card.
"""

import logging

import numpy as np

from kbmod_tpu_torch.geom.ecliptic import ecliptic_to_equatorial, equatorial_to_ecliptic
from kbmod_tpu_torch.table import Table

logger = logging.getLogger(__name__)

__all__ = [
    "generate_injection_catalog",
    "generate_ic_injection_catalog",
    "inject_sources_into_work_unit",
    "inject_sources_into_ic",
    "match_injection_results",
]


def generate_injection_catalog(
    num_objects,
    center_ra,
    center_dec,
    mjd0,
    *,
    ra_spread_deg=0.1,
    dec_spread_deg=0.1,
    vel_min=2.0,
    vel_max=500.0,
    mag_min=20.0,
    mag_max=26.0,
    angle_jitter=0.1,
    barycentric_distance=None,
    seed=None,
):
    """Generate a catalog of synthetic moving objects aligned with the
    ecliptic.

    Each object gets a random start near (center_ra, center_dec), a
    velocity magnitude in [vel_min, vel_max] arcsec/day directed along the
    local ecliptic (plus ``angle_jitter`` radians of jitter), and a
    magnitude in [mag_min, mag_max]. When ``barycentric_distance`` is
    given, positions are inverse-EBD-corrected so that injection into
    original-frame images produces objects that move linearly in the EBD
    frame.

    Returns a Table with columns: object_id, ra, dec, v_ra, v_dec
    (deg/day), mag, mjd0.
    """
    rng = np.random.default_rng(seed)
    ra = center_ra + rng.uniform(-ra_spread_deg, ra_spread_deg, num_objects)
    dec = center_dec + rng.uniform(-dec_spread_deg, dec_spread_deg, num_objects)

    # Direction of increasing ecliptic longitude at each position.
    lon, lat = equatorial_to_ecliptic(ra, dec)
    d_lon = 1e-4
    ra2, dec2 = ecliptic_to_equatorial(lon + d_lon, lat)
    dir_ra = ra2 - ra
    dir_dec = dec2 - dec
    norm = np.hypot(dir_ra, dir_dec)
    dir_ra /= norm
    dir_dec /= norm

    angle = rng.uniform(-angle_jitter, angle_jitter, num_objects)
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    jra = dir_ra * cos_a - dir_dec * sin_a
    jdec = dir_ra * sin_a + dir_dec * cos_a

    vel_deg = rng.uniform(vel_min, vel_max, num_objects) / 3600.0  # deg/day
    v_ra = jra * vel_deg
    v_dec = jdec * vel_deg
    mag = rng.uniform(mag_min, mag_max, num_objects)

    if barycentric_distance is not None:
        from kbmod_tpu_torch.reprojection_utils import invert_correct_parallax_vectorized
        from kbmod_tpu_torch.geom.wcs import SkyCoordLite

        coords = SkyCoordLite(ra, dec)
        coords.distance_au = np.full(num_objects, barycentric_distance)
        original = invert_correct_parallax_vectorized(coords, np.full(num_objects, mjd0))
        ra, dec = original.ra_deg, original.dec_deg

    return Table(
        {
            "object_id": np.arange(num_objects),
            "ra": ra,
            "dec": dec,
            "v_ra": v_ra,
            "v_dec": v_dec,
            "mag": mag,
            "mjd0": np.full(num_objects, float(mjd0)),
        }
    )


def generate_ic_injection_catalog(
    ic,
    search_config,
    global_wcs,
    n_objs_per_ic=50,
    guess_distance=None,
    mag_range=(19.0, 26.0),
    source_type="Star",
    seed=None,
):
    """Generate a per-epoch injection catalog for an ImageCollection, the
    input to :func:`inject_sources_into_ic` (reference injection.py:31-203).

    Trajectories are drawn from the search's own candidate generator at
    the image's ecliptic angle with sub-pixel / sub-velocity-resolution
    jitter, propagated linearly in the global WCS frame across the
    collection's unique obstimes; with ``guess_distance`` the positions
    are inverse-parallax-corrected so the injected (original-frame)
    sources move in straight lines after EBD resampling.

    Returns a Table with injection_id / ra / dec / mag / guess_distance /
    source_type / obj_ids / obstime / plot_x / plot_y (+ ra_<d>/dec_<d>
    straight-line columns when a guess distance is given).
    """
    from kbmod_tpu_torch.trajectory_generator import create_trajectory_generator
    from kbmod_tpu_torch.wcs_utils import calc_ecliptic_angle

    rng = np.random.default_rng(seed)
    n = int(n_objs_per_ic)

    eclip_angle = calc_ecliptic_angle(global_wcs)
    gen_config = search_config["generator_config"] if hasattr(search_config, "__getitem__") else search_config
    trjgen = create_trajectory_generator(gen_config, given_ecliptic=eclip_angle)
    candidates = list(trjgen)
    picks = rng.integers(0, len(candidates), n)
    vx_arr = np.array([candidates[i].vx for i in picks], dtype=float)
    vy_arr = np.array([candidates[i].vy for i in picks], dtype=float)

    # Sub-velocity-resolution jitter (mean grid spacing per axis).
    unique_vx = np.unique([t.vx for t in candidates])
    unique_vy = np.unique([t.vy for t in candidates])
    dvx = float(np.diff(unique_vx).mean()) if len(unique_vx) > 1 else 0.0
    dvy = float(np.diff(unique_vy).mean()) if len(unique_vy) > 1 else 0.0
    if dvx > 0:
        vx_arr += rng.uniform(0, dvx, n)
    if dvy > 0:
        vy_arr += rng.uniform(0, dvy, n)

    # Starting pixels inside the global frame, with sub-pixel jitter.
    if global_wcs.pixel_shape is not None:
        max_x, max_y = int(global_wcs.pixel_shape[0]), int(global_wcs.pixel_shape[1])
    elif global_wcs.array_shape is not None:
        max_y, max_x = (int(s) for s in global_wcs.array_shape)
    else:
        raise ValueError(
            "WCS does not have sufficient information to compute pixel "
            "boundaries (missing array_shape or pixel_shape)."
        )
    xs = rng.integers(0, max(max_x, 1), n) + rng.uniform(0, 1, n)
    ys = rng.integers(0, max(max_y, 1), n) + rng.uniform(0, 1, n)

    obstimes = np.sort(np.asarray(ic["mjd_mid"], dtype=float))
    unique_obstimes = np.unique(obstimes)
    dts = unique_obstimes - unique_obstimes[0]
    xs_t = xs[:, None] + dts[None, :] * vx_arr[:, None]
    ys_t = ys[:, None] + dts[None, :] * vy_arr[:, None]

    ra_orig, dec_orig = global_wcs.pixel_to_world_values(xs_t.ravel(), ys_t.ravel())

    if guess_distance is None:
        ra_inj, dec_inj = ra_orig, dec_orig
    else:
        from kbmod_tpu_torch.geom.geodesy import geodetic_to_geocentric
        from kbmod_tpu_torch.geom.wcs import SkyCoordLite
        from kbmod_tpu_torch.reprojection_utils import invert_correct_parallax_vectorized

        loc = ic.get_observatory()
        if loc is None:
            raise ValueError("Observatory location not found in ImageCollection.")
        site = geodetic_to_geocentric(*loc)
        coords = SkyCoordLite(ra_orig, dec_orig)
        coords.distance_au = np.full(ra_orig.size, float(guess_distance))
        t_all = np.tile(unique_obstimes, n)
        inverted = invert_correct_parallax_vectorized(coords, t_all, site)
        ra_inj, dec_inj = inverted.ra_deg, inverted.dec_deg

    n_epochs = len(unique_obstimes)
    mags = np.repeat(rng.uniform(mag_range[0], mag_range[1], n), n_epochs)
    catalog = {
        "injection_id": np.arange(n * n_epochs),
        "ra": ra_inj,
        "dec": dec_inj,
        "mag": mags,
        "guess_distance": np.full(n * n_epochs, np.nan if guess_distance is None else guess_distance),
        "source_type": np.array([source_type] * (n * n_epochs), dtype=object),
        "obj_ids": np.repeat(np.arange(n), n_epochs),
        "obstime": np.tile(unique_obstimes, n),
        "plot_x": xs_t.ravel(),
        "plot_y": ys_t.ravel(),
    }
    if guess_distance is not None:
        catalog[f"ra_{float(guess_distance)}"] = ra_orig
        catalog[f"dec_{float(guess_distance)}"] = dec_orig
    return Table(catalog)


def inject_sources_into_ic(ic, catalog, butler, inject_config=None, inject_task=None):
    """Inject simulated objects into the exposures behind a Butler-backed
    ImageCollection via the (LSST) VisitInjectTask and rebuild the
    collection from the injected exposures (reference injection.py:204-322).

    ``inject_task`` may supply a task instance directly (tests use a mock
    of VisitInjectTask); otherwise the real LSST task is constructed —
    requiring the LSST Science Pipelines.

    Returns (new ImageCollection, stacked output catalogs).
    """
    import copy
    import warnings

    from kbmod_tpu_torch.image_collection import ImageCollection

    required_cols = ["dataId", "mjd_mid"]
    missing = [c for c in required_cols if c not in ic.data.colnames]
    if missing:
        raise ValueError(
            "inject_sources_into_ic requires a Butler-backed ImageCollection "
            f"with columns: {required_cols}. Missing: {missing}"
        )

    if inject_task is None:
        try:
            from lsst.source.injection import VisitInjectConfig, VisitInjectTask
        except ImportError as err:
            raise ImportError("LSST Science Pipelines must be installed to inject sources.") from err
        inject_task = VisitInjectTask(config=inject_config or VisitInjectConfig())

    obstime = np.asarray(catalog["obstime"], dtype=float)
    empty_catalog = {name: np.asarray(catalog[name])[:0] for name in catalog.colnames}

    references, exposures, injected_cats = [], [], []
    injected_cnt = 0
    for i in range(len(ic)):
        mjd_mid = float(ic.data["mjd_mid"][i])
        entry = ic.get_standardizer(i, butler=butler)
        std = entry["std"]
        imdiff = std.exposure
        ref = std.ref

        mask = obstime == mjd_mid
        if not mask.any():
            exposures.append(imdiff)
            injected_cats.append(Table(dict(empty_catalog)))
            references.append(ref)
            continue
        srccat = catalog[np.nonzero(mask)[0].tolist()]
        try:
            result = inject_task.run(
                injection_catalogs=srccat,
                input_exposure=imdiff,
                psf=imdiff.getPsf(),
                photo_calib=getattr(imdiff, "photoCalib", None),
                wcs=imdiff.getWcs(),
            )
            exposures.append(result.output_exposure)
            injected_cats.append(result.output_catalog)
            injected_cnt += 1
        except RuntimeError:
            warnings.warn(
                f"Exposure {i}/{len(ic)} had no objects successfully rendered within bounds."
            )
            exposures.append(imdiff)
            injected_cats.append(Table(dict(empty_catalog)))
        references.append(ref)

    if injected_cnt == 0:
        warnings.warn("No objects were successfully rendered within bounds.")
    else:
        logger.info(f"Successfully injected sources into {injected_cnt}/{len(ic)} exposures.")

    from kbmod_tpu_torch.table import vstack as _vstack

    stacked = _vstack(injected_cats) if injected_cats else Table({})

    new_standardizers = []
    for i in range(len(ic)):
        std = ic.get_standardizer(i, butler=butler)["std"]
        new_std = copy.deepcopy(std)
        new_std.exposure = exposures[i]
        new_std.processable = [exposures[i]]
        new_std.ref = references[i]
        new_standardizers.append(new_std)

    new_ic = ImageCollection.fromStandardizers(new_standardizers)
    return new_ic, stacked


def _mag_to_flux(mag, zero_point=27.0):
    return 10.0 ** (-0.4 * (np.asarray(mag) - zero_point))


def inject_sources_into_work_unit(work_unit, catalog, zero_point=27.0):
    """Inject every catalog object into the WorkUnit's images.

    Positions are propagated linearly in sky coordinates from mjd0 and
    mapped into pixels through ``work_unit.get_wcs(0)``, for every image:
    this assumes one WCS for the whole WorkUnit (a reprojected one, or one
    with a common ``wcs``), as the JAX package does. Fluxes are
    PSF-convolved. Returns the list of pixel-space trajectories actually
    injected.
    """
    from kbmod_tpu_torch.fake_data.fake_data_creator import image_stack_add_fake_object
    from kbmod_tpu_torch.search import Trajectory

    stack = work_unit.im_stack
    obstimes = np.asarray(work_unit.get_all_obstimes())
    t0 = obstimes[0]
    injected = []
    for i in range(len(catalog)):
        ra0 = float(catalog["ra"][i])
        dec0 = float(catalog["dec"][i])
        v_ra = float(catalog["v_ra"][i])
        v_dec = float(catalog["v_dec"][i])
        mjd0 = float(catalog["mjd0"][i])
        flux = float(_mag_to_flux(catalog["mag"][i], zero_point))

        wcs = work_unit.get_wcs(0)
        if wcs is None:
            raise ValueError("Injection requires a WCS.")
        # Pixel trajectory via the WCS at the stack start time.
        ra_start = ra0 + v_ra * (t0 - mjd0)
        dec_start = dec0 + v_dec * (t0 - mjd0)
        x0, y0 = wcs.world_to_pixel_values(ra_start, dec_start)
        x1, y1 = wcs.world_to_pixel_values(ra_start + v_ra, dec_start + v_dec)
        trj = Trajectory(x=int(np.round(x0)), y=int(np.round(y0)), vx=float(x1 - x0), vy=float(y1 - y0), flux=flux)
        image_stack_add_fake_object(stack, trj.x, trj.y, trj.vx, trj.vy, flux=flux)
        injected.append(trj)
    return injected


def match_injection_results(catalog, results, work_unit, threshold_pixels=5.0):
    """Match search results back to the injected catalog.

    Returns a Table with object_id, recovered (bool), match_idx (row in
    ``results`` or -1), and distance (pixels).
    """
    from kbmod_tpu_torch.trajectory_utils import match_trajectory_sets
    from kbmod_tpu_torch.search import Trajectory

    stack_times = np.asarray(work_unit.get_all_obstimes())
    zeroed = stack_times - stack_times[0]
    wcs = work_unit.get_wcs(0)

    queries = []
    for i in range(len(catalog)):
        ra0 = float(catalog["ra"][i]) + float(catalog["v_ra"][i]) * (stack_times[0] - float(catalog["mjd0"][i]))
        dec0 = float(catalog["dec"][i]) + float(catalog["v_dec"][i]) * (stack_times[0] - float(catalog["mjd0"][i]))
        x0, y0 = wcs.world_to_pixel_values(ra0, dec0)
        x1, y1 = wcs.world_to_pixel_values(ra0 + float(catalog["v_ra"][i]), dec0 + float(catalog["v_dec"][i]))
        queries.append(Trajectory(x=int(np.round(x0)), y=int(np.round(y0)), vx=float(x1 - x0), vy=float(y1 - y0)))

    base = results.make_trajectory_list()
    if len(base) == 0:
        return Table(
            {
                "object_id": np.asarray(catalog["object_id"]),
                "recovered": np.zeros(len(catalog), dtype=bool),
                "match_idx": np.full(len(catalog), -1),
            }
        )

    sample_times = [0.0, float(zeroed[-1] / 2), float(zeroed[-1])]
    matches = match_trajectory_sets(queries, base, threshold_pixels, times=sample_times)
    return Table(
        {
            "object_id": np.asarray(catalog["object_id"]),
            "recovered": matches >= 0,
            "match_idx": matches,
        }
    )
