"""The reflex-corrected ("EBD") WorkUnit path of the port against the
benchmark's plain reference (``benchmarks/reference/ebd.py``, PyTorch
float64, no code of either package), on the CPU at a small size: 48 x 48
CCDs, six exposures over two nights, one exposure a mosaic of two CCDs that
overlap (a collision), then the search and the positions of its rows; and
the reprojection's spans and counters.

Tolerances, each with its reason:
- EBD WCSes and sky positions, judged from the port's own observer
  positions: 1e-3 arcsec. The EBD WCS fit's residual is under 1e-6 arcsec
  on a 48 x 48 CCD (about 3e-3 on a whole DECam CCD), the positions'
  float64 rounding under 1e-9; a WCS one pixel off reads 0.26 arcsec, a
  reprojection in the original frame tens of arcseconds.
- the observer: 1.5e-4 AU (0.77 arcsec at 40 AU). The port's Earth (a
  low-precision solar series and the giant planets' pull, equal to the JAX
  package's) sits 9.1e-5-9.4e-5 AU from the reference's (VSOP87, within
  about 0.06 arcsec of DE432s at 50 AU) on these nights; the Sun's
  barycentric offset alone is about 5e-3 AU.
- layers: 1e-4 of the noise's sigma for the science, of the level for the
  variance. The port resamples in float32 with the coordinates cast to
  float32 and its Jacobian from differences one pixel apart, the reference
  in float64 with differences half a pixel apart; coordinates half a pixel
  off move the science by about a sigma.
- masks: equal, but at pixels whose reference footprint lies within 1e-5
  of the 0.999 threshold (a float32 footprint can fall on the other side).
"""

import ast
import copy
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.loops import ebd_search
from benchmarks.reference import ebd
from benchmarks.tests.ebd_cases import tiny_cell
from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.geom.ecliptic import observer_position_equatorial
from kbmod_tpu_torch.geom.wcs import WCS
from kbmod_tpu_torch.reprojection import reproject_work_unit
from kbmod_tpu_torch.run_search import SearchRunner
from kbmod_tpu_torch.work_unit import WorkUnit

ARCSEC = 1e-3
OBSERVER_AU = 1.5e-4
LAYER = 1e-4
FOOT_NEAR = 1e-5
# The patch's last column lies at CCD A's column 39 + dx; CCD B starts at
# A's column 38, so only the third exposure (dx = 4) reaches B.
DITHERS = [(-6.0, 1.0), (-5.0, -2.0), (4.0, 0.5), (-4.0, 2.0), (-6.0, -1.0), (-5.0, 0.0)]


def _traffic():
    _, _, config, traffic = tiny_cell()
    traffic = copy.deepcopy(traffic)
    traffic["stack"].update(height=24, width=32)
    traffic["ccd"].update(height=48, width=48, gap=-10, patch_origin=[8, 12])
    traffic["objects"]["random"].update(tiers=[[1, 400.0]], margin=4)
    config = copy.deepcopy(config)
    config["search"].update(num_obs=4, result_filename=None)
    return config, traffic


def _unit(seed=5):
    config, traffic = _traffic()
    exposures = ebd_search.pointings(traffic, DITHERS)
    unit = ebd_search.make_unit(traffic, seed, 0, "cpu", exposures=exposures)
    return config, traffic, unit


def _work_unit(config, traffic, unit):
    h, w = unit.sci[0].shape
    wcses = [WCS(e.crpix, e.crval, e.cd, shape=(h, w)) for e in unit.exposures]
    site_m = tuple(float(v) * ebd.AU_M for v in ebd_search.site(traffic))
    search = SearchConfiguration.from_dict(dict(config["search"], generator_config=dict(traffic["grid"])))
    stack = ImageStackPy([e.time for e in unit.exposures], [s.copy() for s in unit.sci], unit.var, psfs=unit.psfs)
    return WorkUnit(im_stack=stack, config=search, per_image_wcs=wcses, barycentric_distance=40.0,
                    observatory=site_m)


def _common(traffic):
    spec = traffic["stack"]
    c = ebd_search.common_tan(traffic)
    return WCS(c.crpix.tolist(), traffic["field"]["center"], c.cd.tolist(), shape=(spec["height"], spec["width"]))


@pytest.fixture(scope="module")
def reprojected():
    config, traffic, unit = _unit()
    work = _work_unit(config, traffic, unit)
    return traffic, unit, work, reproject_work_unit(work, _common(traffic), frame="ebd", device="cpu")


def test_the_case_has_one_mosaic():
    _, _, unit = _unit()
    assert len(unit.exposures) == 7 and [e.ccd for e in unit.exposures].count(1) == 1
    assert unit.exposures[3].ccd == 1 and unit.exposures[3].time == unit.exposures[2].time


def _observer(traffic, times):
    """The port's barycentric observer positions at the MJDs, in AU."""
    site_m = tuple(float(v) * ebd.AU_M for v in ebd_search.site(traffic))
    return torch.as_tensor(observer_position_equatorial(np.asarray(times, np.float64), site_m)).reshape(-1, 3)


def test_observer_against_the_reference():
    config, traffic, unit = _unit()
    times = [e.time for e in unit.exposures]
    gap = torch.linalg.vector_norm(_observer(traffic, times) - ebd.observer(torch.as_tensor(times),
                                                                           ebd_search.site(traffic)), dim=-1)
    assert float(gap.max()) < OBSERVER_AU
    without_site = ebd.observer(torch.as_tensor(times))
    assert float(torch.linalg.vector_norm(_observer(traffic, times) - without_site, dim=-1).min()) > 2e-5


def test_ebd_wcses_against_the_reference(reprojected):
    traffic, unit, work, out = reprojected
    seen_from = _observer(traffic, [e.time for e in unit.exposures])
    h, w = unit.sci[0].shape
    ys, xs = np.meshgrid(np.arange(0, h, 3.0), np.arange(0, w, 3.0), indexing="ij")
    uncorrected = 0.0
    for i, e in enumerate(unit.exposures):
        fitted = work.org_img_meta["ebd_wcs"][i]
        original = ebd.Tan(e.crpix, e.crval, e.cd)
        got = ebd.Tan(fitted.crpix, fitted.crval, fitted.cd).pixel_to_vec(xs, ys)
        want = ebd.correct(original.pixel_to_vec(xs, ys), e.time, 40.0, observer_au=seen_from[i])
        assert float(ebd.separation_arcsec(got, want).max()) < ARCSEC, i
        uncorrected = max(uncorrected, float(ebd.separation_arcsec(original.pixel_to_vec(xs, ys), want).max()))
    # The original WCSes themselves are far off: the correction is there
    # (a few arcsec at opposition on the first night, more a night later).
    assert uncorrected > 1.0


def test_layers_against_the_reference(reprojected):
    traffic, unit, work, out = reprojected
    spec = traffic["stack"]
    H, W = spec["height"], spec["width"]
    ys, xs = (v.reshape(-1) for v in np.meshgrid(np.arange(H), np.arange(W), indexing="ij"))
    common = ebd_search.common_tan(traffic)
    assert out.im_stack.num_times == 6 and out._per_image_indices[2] == [2, 3]
    collisions = 0
    for layer, group in enumerate(out._per_image_indices):
        parts, near = [], torch.zeros(H * W, dtype=torch.bool)
        for i in group:
            f = work.org_img_meta["ebd_wcs"][i]
            sy, sx, J = ebd.source_coordinates(common, ebd.Tan(f.crpix, f.crval, f.cd), ys, xs)
            sci, var = (torch.as_tensor(a, dtype=torch.float64) for a in (unit.sci[i], unit.var[i]))
            parts.append(ebd.resample(sci, var, sy, sx, J))
            near |= _near_threshold(sci, sy, sx, J)
        ref_s, ref_v, hit = ebd.mosaic(parts)
        collisions += hit
        got_s = torch.as_tensor(out.im_stack.sci[layer].reshape(-1), dtype=torch.float64)
        got_v = torch.as_tensor(out.im_stack.var[layer].reshape(-1), dtype=torch.float64)
        flips = torch.isnan(ref_s) != torch.isnan(got_s)
        assert not (flips & ~near).any(), (layer, int(flips.sum()))
        both = ~torch.isnan(ref_s) & ~torch.isnan(got_s)
        sigma = float(spec["variance"]) ** 0.5
        assert float((got_s - ref_s)[both].abs().max()) / sigma < LAYER
        assert float((got_v - ref_v)[both].abs().max()) / float(spec["variance"]) < LAYER
        assert both.sum() > H * W // 2
    assert collisions > 0
    # The collision pixels of the mosaic are masked in the port's layer.
    assert np.isnan(out.im_stack.sci[2]).sum() >= collisions


def _near_threshold(sci, sy, sx, J):
    """Pixels whose reference footprint lies within FOOT_NEAR of 0.999."""
    ones = torch.ones_like(sci)
    _, _, kept_lo = ebd.resample(sci, ones, sy, sx, J, threshold=ebd.FOOTPRINT_THRESHOLD - FOOT_NEAR)
    _, _, kept_hi = ebd.resample(sci, ones, sy, sx, J, threshold=ebd.FOOTPRINT_THRESHOLD + FOOT_NEAR)
    return kept_lo != kept_hi


def test_search_and_positions_against_the_reference(tmp_path):
    config, traffic, unit = _unit()
    work = _work_unit(config, traffic, unit)
    work.config.set("result_filename", str(tmp_path / "ebd_results.ecsv"))
    out = reproject_work_unit(work, _common(traffic), frame="ebd", device="cpu")
    results = SearchRunner(device="cpu").run_search_from_work_unit(out)
    assert len(results) >= 1
    (x0, y0, vx0, vy0, _), = unit.objects
    best = int(np.argmax(results["likelihood"]))
    assert abs(results["x"][best] - x0) <= 2 and abs(results["y"][best] - y0) <= 2
    times = np.asarray(out.im_stack.times)
    z = torch.as_tensor(times - times[0])
    col = lambda k: torch.as_tensor(np.asarray(results[k], np.float64))[:, None]
    glob = ebd_search.common_tan(traffic).pixel_to_vec(col("x") + col("vx") * z, col("y") + col("vy") * z)
    seen = ebd.invert(glob, times, 40.0, observer_au=_observer(traffic, times).expand(glob.shape))
    for (ra, dec), want in ((("global_ra", "global_dec"), glob), (("img_ra", "img_dec"), seen)):
        got = ebd.unit(np.asarray(results.table[ra]), np.asarray(results.table[dec]))
        assert got.shape == want.shape
        assert float(ebd.separation_arcsec(got, want).max()) < ARCSEC, ra


def test_image_qa_keeps_the_constituents_times():
    """Dropping the mosaicked layer drops both of its constituents' times."""
    config, traffic, unit = _unit()
    work = _work_unit(config, traffic, unit)
    out = reproject_work_unit(work, _common(traffic), frame="ebd", device="cpu")
    assert len(out.get_all_obstimes()) == 7
    keep = np.ones(6, dtype=bool)
    keep[2] = False
    out.filter_images(keep)
    times = [e.time for i, e in enumerate(unit.exposures) if i not in (2, 3)]
    assert list(out.get_all_obstimes()) == times and out.n_constituents == 5
    assert out._per_image_indices == [[0], [1], [2], [3], [4]]


def test_reprojection_spans_and_counters():
    config, traffic, unit = _unit()
    tracing.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = reproject_work_unit(_work_unit(config, traffic, unit), _common(traffic), frame="ebd", device="cpu")
    finally:
        prof.stop()
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    parent = lambda r: by_id[r.parent].name if r.parent else None
    names = [r.name for r in recs]
    assert names.count("reproject") == 1 and names.count("reproject.ebd_fit") == 1
    assert names.count("reproject.layer") == 6 and names.count("reproject.mosaic") == 6
    assert names.count("reproject.coords") == names.count("reproject.resample") == names.count("reproject.upload") == 7
    want = {"reproject.ebd_fit": "reproject", "reproject.layer": "reproject", "reproject.coords": "reproject.layer",
            "reproject.resample": "reproject.layer", "reproject.mosaic": "reproject.layer",
            "reproject.upload": "reproject.resample"}
    for r in recs:
        if r.name in want:
            assert parent(r) == want[r.name], r
    totals = tracing.totals()
    assert totals["reproject.images"] == len(unit.exposures) and totals["reproject.layers"] == out.im_stack.num_times
    assert totals["reproject.taps"] == 7 * 7 * 7  # radius 3 at the common frame's scale
    assert totals["reproject.collisions"] > 0
    H, W = traffic["stack"]["height"], traffic["stack"]["width"]
    # Each CCD's science and variance, and its float32 coordinates; the
    # search build's counter holds none of them.
    assert totals["reproject.bytes_h2d"] == sum(2 * s.nbytes + 2 * H * W * 4 for s in unit.sci)
    assert "bytes.h2d" not in totals
    tracing.reset()
    reproject_work_unit(_work_unit(config, traffic, unit), _common(traffic), frame="ebd", device="cpu")
    assert tracing.records() == [] and tracing.totals() == {}


def test_the_reference_imports_neither_package():
    path = pathlib.Path(ebd.__file__)
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"math", "torch"}, tops
