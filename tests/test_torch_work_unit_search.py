"""``run_search_from_work_unit`` of the port against the JAX package's, on
the CPU: a small fake WorkUnit with a WCS per image, reprojected onto a
common WCS in the ``original`` and ``ebd`` frames, then searched with the
ecliptic angle taken from the WorkUnit's WCS and sky positions on.

- handed over: the JAX package reprojects and writes the WorkUnit (GZIP_1,
  lossless); each package reads that file and searches it, the port on the
  JAX package's own psi/phi planes (test_torch_run_search's ``_HandedOver``,
  so the convolution's rounding does not enter). Rows equal (x, y, vx, vy,
  obs_count, order), likelihood and flux within 1e-5 * max(1, |value|),
  coadds exact, ``pred_x``/``pred_y`` exact, ``global_ra``/``global_dec``
  and ``img_ra``/``img_dec`` within 1e-9 degrees;
- the whole slice: the port reprojects and builds its own planes; the
  object's row and its sky path agree with the JAX package's run within the
  same bounds (lh within 1e-4: two ulp-level differences, the resampling
  and the convolution, compound);
- ``kbmod_search`` through ``runpy`` with a configuration file: the rows of
  the direct run;
- the ``color_scale`` departure: the JAX package's
  ``run_search_from_work_unit`` raises AttributeError (its image stack has
  no ``apply_color_scaling``); the port's rows equal those of the JAX
  package's ``work.apply_color_scale`` followed by ``run_search``.
"""

import runpy
import sys

import numpy as np
import pytest
import torch

from kbmod_tpu.configuration import SearchConfiguration as JConfig
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
from kbmod_tpu.fake_data.fake_data_creator import create_fake_times
from kbmod_tpu.reprojection import reproject_work_unit as j_reproject
from kbmod_tpu.reprojection_utils import fit_barycentric_wcs as j_fit_ebd
from kbmod_tpu.run_search import SearchRunner as JSearchRunner
from kbmod_tpu.search import Trajectory
from kbmod_tpu.table import Table as JTable
from kbmod_tpu.trajectory_generator import create_trajectory_generator as j_create_generator
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs
from kbmod_tpu.work_unit import WorkUnit as JWorkUnit

import kbmod_tpu_torch.run_search as port_run_search
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.configuration import SearchConfiguration as TConfig
from kbmod_tpu_torch.reprojection import reproject_work_unit
from kbmod_tpu_torch.reprojection_utils import fit_barycentric_wcs
from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.table import Table as TTable
from kbmod_tpu_torch.wcs_utils import make_fake_wcs
from kbmod_tpu_torch.work_unit import WorkUnit

from test_torch_run_search import _assert_tables_match, _close, _HandedOver

SKY_TOL = 1e-9
KEY = ("x", "y", "vx", "vy", "obs_count")
H, W, T = 40, 48, 10
DEG_PP = 1.0 / 3600.0
# The barycentric distance of the ebd frame: far enough that five nights of
# parallax move these 48-pixel images by a few pixels, not off the frame.
BARY_AU = 2000.0
BASE = dict(num_obs=5, lh_level=2.0, near_dup_thresh=3, cluster_eps=1.5, save_config=False, coadds=["mean"],
            generator_config={"name": "EclipticCenteredSearch", "velocities": [2.0, 6.0, 9],
                              "angles": [-0.6, 0.6, 9], "angle_units": "radian", "velocity_units": "pix / d"})


def _image_wcs(make):
    return make(200.0, -7.0, H, W, DEG_PP)


def _common_wcs(make):
    wcs = make(200.0, -7.0, H, W, DEG_PP)
    wcs.crpix = wcs.crpix + np.array([0.3, 0.2])
    return wcs


def _object(angle):
    """The object on a point of the generator's grid (speed 4.0, 0.15 rad
    off the ecliptic angle ``angle``)."""
    a = angle + 0.15
    return Trajectory(x=17, y=21, vx=float(4.0 * np.cos(a)), vy=float(4.0 * np.sin(a)), flux=350.0)


def _jax_unit(meta=None):
    """The JAX package's WorkUnit: a fake stack with the object on the
    generator's grid (the ecliptic angle of the common WCS), one WCS per
    image, a barycentric distance for the ebd frame."""
    times = create_fake_times(T, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = JFakeDataSet(W, H, times, psf_val=1.0, mask_fraction=0.03, use_seed=7)
    ds.insert_object(_object(JWorkUnit(im_stack=ds.stack_py, wcs=_common_wcs(j_make_fake_wcs)).compute_ecliptic_angle()))
    return JWorkUnit(im_stack=ds.stack_py, config=JConfig(dict(BASE)), obstimes=ds.times, barycentric_distance=BARY_AU,
                     per_image_wcs=[_image_wcs(j_make_fake_wcs) for _ in range(T)],
                     org_image_meta=None if meta is None else JTable(meta))


def _port_unit(jwu):
    """The same WorkUnit in the port."""
    st = jwu.im_stack
    meta = {c: list(jwu.org_img_meta[c]) for c in jwu.org_img_meta.colnames
            if not all(v is None or hasattr(v, "crval") for v in jwu.org_img_meta[c])}
    return WorkUnit(im_stack=TImageStackPy(times=list(st.times), sci=[np.array(s) for s in st.sci],
                                           var=[np.array(v) for v in st.var], psfs=[np.array(p) for p in st.psfs]),
                    config=TConfig(jwu.config.to_dict()), obstimes=np.array(jwu.get_all_obstimes()),
                    barycentric_distance=jwu.barycentric_distance,
                    per_image_wcs=[_image_wcs(make_fake_wcs) for _ in range(T)],
                    org_image_meta=TTable(meta) if meta else None)


def _commons(frame, jwu):
    if frame == "original":
        return _common_wcs(j_make_fake_wcs), _common_wcs(make_fake_wcs)
    t0 = jwu.get_all_obstimes()[0]
    return (j_fit_ebd(_image_wcs(j_make_fake_wcs), W, H, BARY_AU, t0, jwu.observatory, 10, 101)[0],
            fit_barycentric_wcs(_image_wcs(make_fake_wcs), W, H, BARY_AU, t0, jwu.observatory, 10, 101)[0])


def _assert_positions_match(ref, got, rows=None):
    rows = slice(None) if rows is None else rows
    for k in ("pred_x", "pred_y"):
        np.testing.assert_array_equal(np.asarray(got[k])[rows], np.asarray(ref[k])[rows], err_msg=k)
    for k in ("global_ra", "global_dec", "img_ra", "img_dec"):
        np.testing.assert_allclose(np.asarray(got[k])[rows], np.asarray(ref[k])[rows], rtol=0, atol=SKY_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("frame", ["original", "ebd"])
def test_handed_over_rows_and_sky_positions(tmp_path, monkeypatch, frame):
    jwu = _jax_unit()
    jcommon, _ = _commons(frame, jwu)
    j_reproject(jwu, jcommon, frame=frame).to_fits(str(tmp_path / "wu.fits"))
    jwork = JWorkUnit.from_fits(str(tmp_path / "wu.fits"))
    twork = WorkUnit.from_fits(str(tmp_path / "wu.fits"))
    assert twork.reprojection_frame == frame and twork.barycentric_distance == BARY_AU
    monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")
    monkeypatch.setattr(port_run_search, "StackSearch", _HandedOver)
    _HandedOver.substituted = _HandedOver.reordered = 0
    ref = JSearchRunner().run_search_from_work_unit(jwork)
    got = port_run_search.SearchRunner(device="cpu").run_search_from_work_unit(twork)
    _assert_tables_match(ref, got)
    assert _HandedOver.substituted == _HandedOver.reordered == 0
    _assert_positions_match(ref, got)
    if frame == "original":
        np.testing.assert_array_equal(got["img_ra"], got["global_ra"])
    else:
        assert np.abs(np.asarray(got["img_ra"]) - np.asarray(got["global_ra"])).max() > 1e-5
    assert got.wcs is not None and got.wcs.crval.tolist() == twork.wcs.crval.tolist()
    assert twork.im_stack.num_times == jwork.im_stack.num_times >= T - 1


@pytest.mark.parametrize("frame", ["original", "ebd"])
def test_whole_slice_matches_jax(frame):
    """The port reprojects the original images itself and searches its own
    planes: the object's row (row 0 on both sides) agrees."""
    jwu = _jax_unit()
    twu = _port_unit(jwu)
    jcommon, common = _commons(frame, jwu)
    jres = j_reproject(jwu, jcommon, frame=frame)
    tres = reproject_work_unit(twu, common, frame=frame, device="cpu")
    ref = JSearchRunner().run_search_from_work_unit(jres)
    got = port_run_search.SearchRunner(device="cpu").run_search_from_work_unit(tres)
    assert abs(tres.compute_ecliptic_angle() - jres.compute_ecliptic_angle()) <= SKY_TOL
    for k in KEY:
        assert got[k][0] == ref[k][0], k
    assert abs(got["likelihood"][0] - ref["likelihood"][0]) <= 1e-4 * max(1.0, abs(ref["likelihood"][0]))
    _assert_positions_match(ref, got, rows=slice(0, 1))
    obj = _object(jres.compute_ecliptic_angle())
    if frame == "original":
        assert abs(got["x"][0] - obj.x) <= 1 and abs(got["y"][0] - obj.y) <= 1


def _runpy_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["kbmod_search", *argv])
    runpy.run_module("kbmod_tpu_torch.cmdline.kbmod_search", run_name="__main__", alter_sys=False)


def test_kbmod_search_command_line(tmp_path, monkeypatch, capsys):
    jwu = _jax_unit()
    twu = _port_unit(jwu)
    _, common = _commons("original", jwu)
    work = reproject_work_unit(twu, common, device="cpu")
    work.to_fits(str(tmp_path / "wu.fits"))
    config = TConfig(dict(BASE, num_obs=6))
    config.to_file(str(tmp_path / "cfg.yaml"))
    out = tmp_path / "res.ecsv"
    _runpy_main(["--workunit", str(tmp_path / "wu.fits"), "--outfile", str(out), "--config",
                 str(tmp_path / "cfg.yaml"), "--device", "cpu"], monkeypatch)
    assert "Search produced" in capsys.readouterr().out
    back = TResults.read_table(str(out))
    direct = WorkUnit.from_fits(str(tmp_path / "wu.fits"))
    direct.config = TConfig(dict(BASE, num_obs=6))
    want = port_run_search.SearchRunner(device="cpu").run_search_from_work_unit(direct)
    assert len(back) == len(want) > 0
    for k in KEY:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert _close(back["likelihood"], want["likelihood"])
    np.testing.assert_allclose(np.asarray(back["global_ra"]), np.asarray(want["global_ra"]), rtol=0, atol=SKY_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _runpy_main(["--workunit", str(tmp_path / "wu.fits")], monkeypatch)


def test_color_scale_departure(monkeypatch):
    """The JAX package's run_search_from_work_unit raises where color_scale
    is set; the port applies WorkUnit.apply_color_scale, and its rows equal
    the JAX package's apply_color_scale followed by run_search."""
    meta = {"filter": ["r", "g"] * (T // 2)}
    color_scale = {"g": 0.2, "r": 0.0}
    jwu = _jax_unit(meta=meta)
    jwu.wcs = _common_wcs(j_make_fake_wcs)
    jwu.config.set("color_scale", color_scale)
    with pytest.raises(AttributeError, match="apply_color_scaling"):
        JSearchRunner().run_search_from_work_unit(jwu)

    jwu = _jax_unit(meta=meta)
    jwu.wcs = _common_wcs(j_make_fake_wcs)
    jwu.config.set("color_scale", color_scale)
    twu = _port_unit(jwu)
    twu.wcs = _common_wcs(make_fake_wcs)

    monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")
    monkeypatch.setattr(port_run_search, "StackSearch", _HandedOver)
    jwu.apply_color_scale(jwu.config["color_scale"])
    ref = JSearchRunner().run_search(jwu.config, jwu.im_stack, trj_generator=j_create_generator(jwu.config,
                                                                                                 work_unit=jwu),
                                     workunit=jwu)
    got = port_run_search.SearchRunner(device="cpu").run_search_from_work_unit(twu)
    _assert_tables_match(ref, got)
    _assert_positions_match(ref, got)
    np.testing.assert_array_equal(np.asarray(twu.org_img_meta["color_scale"], float),
                                  np.asarray(jwu.org_img_meta["color_scale"], float))
    for i in range(T):
        np.testing.assert_array_equal(twu.im_stack.sci[i], jwu.im_stack.sci[i])
