"""The port's WorkUnit against the JAX package's, on the CPU.

The cases of tests/test_work_unit.py and tests/test_work_unit_geom.py run
again against kbmod_tpu_torch.work_unit, each held to the JAX package's
result on the same seeded data; then the files: the reference single-file
layout (GZIP_1 and RICE_1), the metadata layout and the sharded and lazy
forms, written by each package and read by the other, byte-equal where both
write the same WorkUnit, and the configuration's three FITS forms.

Tolerances: none for arrays, times, PSFs, WCS (serialized strings equal),
configurations and metadata; RICE_1 pixels within half a quantum of the
input (0.0051 at quantize_level -0.01); float64 sky and pixel positions
within 1e-9 (the same host arithmetic, different only by import path).
"""

import numpy as np
import pytest

from kbmod_tpu.configuration import SearchConfiguration as JConfig
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
from kbmod_tpu.fake_data.fake_data_creator import create_fake_times
from kbmod_tpu.table import Table as JTable
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs
from kbmod_tpu.work_unit import WorkUnit as JWorkUnit

from kbmod_tpu_torch.configuration import SearchConfiguration as TConfig
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet as TFakeDataSet
from kbmod_tpu_torch.io import fits_io as t_fits
from kbmod_tpu_torch.table import Table as TTable
from kbmod_tpu_torch.wcs_utils import make_fake_wcs, serialize_wcs
from kbmod_tpu_torch.work_unit import RUBIN_LOCATION_M, WorkUnit, create_image_metadata

QUANT_ATOL = 0.0051
POS_TOL = 1e-9


def _port_stack(st):
    return TImageStackPy(times=list(st.times), sci=[np.array(s) for s in st.sci],
                         var=[np.array(v) for v in st.var], psfs=[np.array(p) for p in st.psfs])


def _pair(n=4, width=24, height=20, seed=8, t0=59000.0, wcs=True, meta=None, config=None):
    """The same WorkUnit in both packages: the JAX package's fake stack,
    copied into the port's."""
    ds = JFakeDataSet(width, height, create_fake_times(n, t0), use_seed=seed, mask_fraction=0.02)
    jwu = ds.get_work_unit(dict(config or {}))
    twu = WorkUnit(im_stack=_port_stack(ds.stack_py), config=TConfig(dict(config or {})), obstimes=ds.times)
    if meta is not None:
        jwu = JWorkUnit(im_stack=jwu.im_stack, config=jwu.config, org_image_meta=JTable(meta), obstimes=ds.times)
        twu = WorkUnit(im_stack=twu.im_stack, config=twu.config, org_image_meta=TTable(meta), obstimes=ds.times)
    if wcs:
        jwu.wcs = j_make_fake_wcs(200.6, -7.8, height, width, deg_per_pixel=0.001)
        twu.wcs = make_fake_wcs(200.6, -7.8, height, width, deg_per_pixel=0.001)
    return jwu, twu


def _assert_same_unit(a, b, atol=0.0):
    """Two WorkUnits (of either package) hold the same data."""
    assert a.im_stack.num_times == b.im_stack.num_times
    np.testing.assert_array_equal(np.asarray(a.im_stack.times), np.asarray(b.im_stack.times))
    for t in range(a.im_stack.num_times):
        for plane in ("sci", "var"):
            x, y = np.asarray(getattr(a.im_stack, plane)[t]), np.asarray(getattr(b.im_stack, plane)[t])
            assert (np.isfinite(x) == np.isfinite(y)).all()
            np.testing.assert_allclose(x[np.isfinite(x)], y[np.isfinite(y)], atol=atol, rtol=0)
        np.testing.assert_array_equal(np.asarray(a.im_stack.psfs[t]), np.asarray(b.im_stack.psfs[t]))
    assert a.config.to_dict() == b.config.to_dict()
    assert (a.wcs is None) == (b.wcs is None)
    if a.wcs is not None:
        assert serialize_wcs(a.wcs) == serialize_wcs(b.wcs)
    assert a.reprojected == b.reprojected and a.reprojection_frame == b.reprojection_frame
    assert a.barycentric_distance == b.barycentric_distance
    np.testing.assert_array_equal(np.asarray(a.observatory, float), np.asarray(b.observatory, float))
    assert [list(map(int, g)) for g in a._per_image_indices] == [list(map(int, g)) for g in b._per_image_indices]
    assert a.n_constituents == b.n_constituents
    assert set(a.org_img_meta.colnames) == set(b.org_img_meta.colnames)
    for col in a.org_img_meta.colnames:
        for u, v in zip(a.org_img_meta[col], b.org_img_meta[col]):
            if hasattr(u, "crval") or hasattr(v, "crval"):
                assert (u is None) == (v is None)
            else:
                assert (u == v) or (u != u and v != v), col


class TestCreateImageMetadata:
    def test_empty(self):
        meta = create_image_metadata(3, data=None)
        assert len(meta) == 3
        for col in ("data_loc", "ebd_wcs", "geocentric_distance", "per_image_wcs"):
            assert col in meta.colnames

    def test_from_table(self):
        data = TTable({"uri": ["f1", "f2", "f3"], "geocentric_distance": [1.0, 2.0, 3.0]})
        meta = create_image_metadata(3, data)
        assert len(meta) == 3 and "uri" in meta.colnames
        np.testing.assert_array_equal(meta["geocentric_distance"], [1.0, 2.0, 3.0])
        assert all(v is None for v in meta["per_image_wcs"])

    def test_validation(self):
        with pytest.raises(ValueError):
            create_image_metadata(-1, None)
        with pytest.raises(ValueError):
            create_image_metadata(2, TTable({"uri": ["f1", "f2", "f3"]}))


class TestApplyColorScale:
    def test_scales_by_filter(self):
        meta = {"filter": ["r", "r", "g", "g", "r"]}
        jwu, twu = _pair(n=5, width=16, height=16, seed=2, wcs=False, meta=meta)
        org_sci = [np.array(s) for s in twu.im_stack.sci]
        color_scale = {"g": 0.0, "r": 2.5 * np.log10(2.0)}
        twu.apply_color_scale(color_scale)
        jwu.apply_color_scale(color_scale)
        np.testing.assert_array_equal(np.asarray(twu.org_img_meta["color_scale"], dtype=float),
                                      np.asarray(jwu.org_img_meta["color_scale"], dtype=float))
        _assert_same_unit(twu, jwu)
        for i, f in enumerate(meta["filter"]):
            want = org_sci[i] / 2.0 if f == "r" else org_sci[i]
            np.testing.assert_allclose(twu.im_stack.sci[i], want, rtol=1e-6)

    def test_missing_filter_raises(self):
        _, twu = _pair(n=2, width=8, height=8, seed=2, wcs=False, meta={"filter": ["r", "g"]})
        with pytest.raises(ValueError):
            twu.apply_color_scale({"z": 1.0})

    def test_scalar_and_alias(self):
        jwu, twu = _pair(n=3, width=8, height=8, seed=4, wcs=False)
        twu.apply_color_scaling(0.5)
        jwu.apply_color_scaling(0.5)
        _assert_same_unit(twu, jwu)


class TestDisorderObstimes:
    @pytest.mark.parametrize(
        "times",
        [
            [59001.0, 59003.0, 59005.0, 59007.0, 59009.0],
            [59000.0, 59001.0, 59002.0, 59003.0, 59004.0],
            [59000.0, 59004.0, 59002.0, 59001.0, 59004.0],
            [59000.0, 59001.62, 59002.0, 59001.62, 59002.8],
        ],
    )
    def test_disorder(self, times):
        units = []
        for ds_cls, wu_cls, cfg in ((JFakeDataSet, JWorkUnit, JConfig), (TFakeDataSet, WorkUnit, TConfig)):
            ds = ds_cls(12, 12, create_fake_times(5, 59000.0), use_seed=4)
            ds.stack_py.times = np.asarray(times, dtype=float)
            ds.stack_py.zeroed_times = ds.stack_py.times - ds.stack_py.times[0]
            work = wu_cls(im_stack=ds.stack_py, config=cfg())
            work._per_image_indices[3] = [3, 4]
            np.random.seed(0)
            work.disorder_obstimes()
            units.append(work)
        jwu, twu = units
        new_times = np.array(twu.get_all_obstimes())
        np.testing.assert_array_equal(new_times, np.array(jwu.get_all_obstimes()))
        assert not np.array_equal(new_times, times)
        assert np.array_equal(sorted(new_times), new_times)
        assert sorted(np.unique(times, return_counts=True)[1]) == sorted(np.unique(new_times, return_counts=True)[1])
        assert twu._per_image_indices == jwu._per_image_indices

    def test_empty_raises(self):
        _, twu = _pair(n=1, wcs=False)
        twu.im_stack.times = np.array([])
        twu._obstimes = None
        with pytest.raises(ValueError):
            twu.disorder_obstimes()


class TestObservatoryAndPositions:
    def test_default_is_rubin(self):
        _, twu = _pair()
        assert twu.observatory == RUBIN_LOCATION_M
        assert 6.3e6 < np.linalg.norm(np.asarray(twu.observatory, dtype=float)) < 6.4e6

    def test_custom_roundtrip(self, tmp_path):
        jwu, twu = _pair(n=2)
        for wu in (jwu, twu):
            wu.observatory = (1000.0, 2000.0, 3000.0)
        twu.to_fits(str(tmp_path / "t.fits"))
        jwu.to_fits(str(tmp_path / "j.fits"))
        assert (tmp_path / "t.fits").read_bytes() == (tmp_path / "j.fits").read_bytes()
        back = WorkUnit.from_fits(str(tmp_path / "t.fits"))
        np.testing.assert_allclose(np.asarray(back.observatory, dtype=float), [1000.0, 2000.0, 3000.0])

    def test_bad_output_format(self):
        _, twu = _pair(n=2)
        with pytest.raises(ValueError):
            twu.image_positions_to_original_icrs([0], [(1.0, 2.0)], output_format="bananas")


def _geom_pair(n=4, with_wcs=True):
    ds = JFakeDataSet(64, 80, create_fake_times(n, 57130.0), use_seed=3)
    jwu = ds.get_work_unit()
    twu = WorkUnit(im_stack=_port_stack(ds.stack_py), config=TConfig(), obstimes=ds.times)
    if with_wcs:
        jwu.wcs = j_make_fake_wcs(200.0, -7.0, 64, 80, 1.0 / 3600.0)
        twu.wcs = make_fake_wcs(200.0, -7.0, 64, 80, 1.0 / 3600.0)
    return jwu, twu


class TestWorkUnitGeometry:
    def test_get_pixel_coordinates(self):
        jwu, twu = _geom_pair()
        ra, dec = twu.wcs.pixel_to_world_values([10.0, 30.0], [20.0, 40.0])
        x, y = twu.get_pixel_coordinates(ra, dec)
        np.testing.assert_allclose(x, [10.0, 30.0], atol=1e-6)
        np.testing.assert_allclose(y, [20.0, 40.0], atol=1e-6)
        jx, jy = jwu.get_pixel_coordinates(ra, dec)
        np.testing.assert_allclose(x, jx, rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(y, jy, rtol=0, atol=POS_TOL)

    def test_get_pixel_coordinates_with_times(self):
        jwu, twu = _geom_pair()
        times = twu.get_all_obstimes()
        ra, dec = twu.wcs.pixel_to_world_values([5.0], [6.0])
        x, _ = twu.get_pixel_coordinates(ra, dec, times=[times[1]])
        np.testing.assert_allclose(x, [5.0], atol=1e-6)
        with pytest.raises(ValueError):
            twu.get_pixel_coordinates(ra, dec, times=[times[1] + 0.5])

    def test_compute_ecliptic_angle(self):
        jwu, twu = _geom_pair()
        angle = twu.compute_ecliptic_angle()
        assert np.isfinite(angle)
        assert abs(angle - jwu.compute_ecliptic_angle()) <= POS_TOL
        assert _geom_pair(with_wcs=False)[1].compute_ecliptic_angle() == 0.0

    @pytest.mark.parametrize("fmt", ["radec", "xy"])
    def test_image_positions_to_original_icrs(self, fmt):
        jwu, twu = _geom_pair()
        for wu in (jwu, twu):
            wu.reprojected = True
            wu.reprojection_frame = "ebd"
            wu.barycentric_distance = 40.0
        out = twu.image_positions_to_original_icrs([0, 2], [(10.0, 20.0), (30.0, 5.0)], output_format=fmt)
        ref = jwu.image_positions_to_original_icrs([0, 2], [(10.0, 20.0), (30.0, 5.0)], output_format=fmt)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=POS_TOL)
        if fmt == "radec":
            ra0, _ = twu.wcs.pixel_to_world_values(10.0, 20.0)
            assert 0 < abs(out[0][0] - float(ra0)) < 1.0

    def test_unique_obstimes(self):
        _, twu = _geom_pair()
        times, groups = twu.get_unique_obstimes_and_indices()
        assert len(times) == 4 and all(len(g) == 1 for g in groups)

    def test_filter_images_keeps_metadata(self):
        meta = {"filter": ["r", "g", "r", "i"], "visit": [1, 2, 3, 4]}
        jwu, twu = _pair(n=4, meta=meta)
        for wu in (jwu, twu):
            wu._per_image_indices = [[0], [1, 2], [3], []][:3] + [[3]]
            wu.filter_images([True, False, True, True])
        _assert_same_unit(twu, jwu)
        assert list(twu.org_img_meta["visit"]) == [1, 4]


class TestReferenceFormat:
    """The reference's single-file layout: the port writes the JAX package's
    bytes and each reads the other's file."""

    @pytest.mark.parametrize("ctype", ["GZIP_1", "RICE_1"])
    def test_roundtrip_and_interop(self, tmp_path, ctype):
        meta = {"visit": [11, 12, 13, 14], "filter": ["r", "r", "g", "g"]}
        jwu, twu = _pair(meta=meta, config={"results_per_pixel": 6, "num_obs": 3})
        for wu in (jwu, twu):
            # The MSK layer masks both planes where either is not finite.
            wu.im_stack.sci[1][3, 4] = wu.im_stack.var[1][3, 4] = np.nan
            wu.org_img_meta["per_image_wcs"][2] = wu.wcs
        tpath, jpath = str(tmp_path / "t.wu"), str(tmp_path / "j.wu")
        twu.to_fits(tpath, format="reference", compression_type=ctype)
        jwu.to_fits(jpath, format="reference", compression_type=ctype)
        assert open(tpath, "rb").read() == open(jpath, "rb").read()
        atol = 0.0 if ctype == "GZIP_1" else QUANT_ATOL
        back = WorkUnit.from_fits(jpath)
        jback = JWorkUnit.from_fits(tpath)
        assert back.config["results_per_pixel"] == 6
        _assert_same_unit(back, jback)
        _assert_same_unit(back, twu, atol=atol)
        assert list(back.org_img_meta["visit"]) == [11.0, 12.0, 13.0, 14.0]
        assert back.org_img_meta["per_image_wcs"][2] is not None

    def test_primary_layout_matches_reference(self, tmp_path):
        _, twu = _pair()
        path = str(tmp_path / "layout.wu")
        twu.to_fits(path, format="reference")
        hdus = t_fits.read_fits(path)
        pri = hdus[0].header
        for key in ("NUMIMG", "NCON", "REPRJCTD", "REPFRAME", "BARY", "OBS_LAT", "OBS_LON", "OBS_ELEV",
                    "CRVAL1", "CRPIX1"):
            assert key in pri, key
        assert "KBMOD_CONFIG" in hdus and "IMG_META" in hdus
        sci = hdus["SCI_0"]
        assert "MJD" in sci.header and "NIND" in sci.header and "IND_0" in sci.header

    def test_observatory_geodetic_roundtrip(self, tmp_path):
        from kbmod_tpu_torch.geom.geodesy import geocentric_to_geodetic, geodetic_to_geocentric
        from kbmod_tpu.geom import geodesy as j_geodesy

        _, twu = _pair()
        path = str(tmp_path / "obs.wu")
        twu.to_fits(path, format="reference")
        back = WorkUnit.from_fits(path)
        np.testing.assert_allclose(back.observatory, twu.observatory, atol=1e-3)
        lat, lon, elev = geocentric_to_geodetic(*back.observatory)
        assert -31 < lat < -29 and -72 < lon < -70
        assert (lat, lon, elev) == j_geodesy.geocentric_to_geodetic(*back.observatory)
        assert geodetic_to_geocentric(lat, lon, elev) == j_geodesy.geodetic_to_geocentric(lat, lon, elev)


class TestMetadataAndShardedFormats:
    def _reprojected_pair(self):
        jwu, twu = _pair(n=4, meta={"visit": [1, 2, 3, 4]})
        for wu in (jwu, twu):
            wu.reprojected = True
            wu.reprojection_frame = "ebd"
            wu.barycentric_distance = 41.5
            wu._per_image_indices = [[0], [1], [2], [3]]
        return jwu, twu

    def test_metadata_format_interop(self, tmp_path):
        jwu, twu = self._reprojected_pair()
        twu.to_fits(str(tmp_path / "t.fits"), format="kbmod_tpu")
        jwu.to_fits(str(tmp_path / "j.fits"), format="kbmod_tpu")
        assert (tmp_path / "t.fits").read_bytes() == (tmp_path / "j.fits").read_bytes()
        _assert_same_unit(WorkUnit.from_fits(str(tmp_path / "j.fits")), JWorkUnit.from_fits(str(tmp_path / "t.fits")))
        _assert_same_unit(WorkUnit.from_fits(str(tmp_path / "j.fits")), twu)

    @pytest.mark.parametrize("lazy", [False, True])
    def test_sharded_interop(self, tmp_path, lazy):
        jwu, twu = self._reprojected_pair()
        twu.to_sharded_fits("wu.fits", tmp_path / "t")
        jwu.to_sharded_fits("wu.fits", tmp_path / "j")
        for name in ["wu.fits"] + [f"{i}_wu.fits" for i in range(4)]:
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
        back = WorkUnit.from_sharded_fits("wu.fits", tmp_path / "j", lazy=lazy)
        jback = JWorkUnit.from_sharded_fits("wu.fits", tmp_path / "t", lazy=lazy)
        if lazy:
            assert back.lazy and back.im_stack.num_times == 0
            assert [p.split("/")[-1] for p in back.file_paths] == [p.split("/")[-1] for p in jback.file_paths]
            back.load_images()
            jback.load_images()
            assert not back.lazy
        _assert_same_unit(back, jback)
        _assert_same_unit(back, twu)

    def test_load_layered_image_from_shard(self, tmp_path):
        from kbmod_tpu_torch.work_unit import load_layered_image_from_shard

        _, twu = self._reprojected_pair()
        twu.to_sharded_fits("wu.fits", tmp_path)
        img = load_layered_image_from_shard(str(tmp_path / "2_wu.fits"))
        np.testing.assert_array_equal(img.sci, twu.im_stack.sci[2])
        assert img.time == twu.im_stack.times[2]

    def test_module_helpers_match(self):
        from kbmod_tpu.work_unit import add_image_data_to_hdul as j_add
        from kbmod_tpu.work_unit import image_metadata_table_to_hdu as j_meta_hdu
        from kbmod_tpu_torch.work_unit import (add_image_data_to_hdul, hdu_to_image_metadata_table,
                                               image_metadata_table_to_hdu, read_image_data_from_hdul)

        rng = np.random.default_rng(9)
        sci = rng.normal(size=(6, 7)).astype(np.float32)
        var = np.ones((6, 7), np.float32)
        mask = np.zeros((6, 7))
        mask[2, 3] = 1
        wcs = make_fake_wcs(10.0, 20.0, 6, 7)
        hdul = t_fits.HDUList([t_fits.ImageHDU(name="PRIMARY")])
        add_image_data_to_hdul(hdul, 0, sci, var, mask, 57000.5, wcs=wcs, compression_type="GZIP_1")
        jhdul = []
        j_add(jhdul, 0, sci, var, mask, 57000.5, wcs=j_make_fake_wcs(10.0, 20.0, 6, 7), compression_type="GZIP_1")
        assert [h.header for h in hdul[1:]] == [h.header for h in jhdul]
        s, v, m, t, psf, w = read_image_data_from_hdul(hdul, 0)
        assert np.isnan(s[2, 3]) and t == 57000.5
        for attr in ("crval", "crpix", "cd"):
            np.testing.assert_array_equal(getattr(w, attr), getattr(wcs, attr))
        np.testing.assert_array_equal(np.nan_to_num(s), np.where(mask > 0, 0.0, sci))
        table = TTable({"a": [1.0, 2.0], "w": np.array([wcs, None], dtype=object)})
        hdu = image_metadata_table_to_hdu(table, "META")
        jhdu = j_meta_hdu(JTable({"a": [1.0, 2.0], "w": np.array([j_make_fake_wcs(10.0, 20.0, 6, 7), None],
                                                                   dtype=object)}), "META")
        assert set(hdu.columns) == set(jhdu.columns) == {"a", "_WCSSTR_w"}
        assert hdu.columns["_WCSSTR_w"] == jhdu.columns["_WCSSTR_w"]
        back = hdu_to_image_metadata_table(hdu)
        assert serialize_wcs(back["w"][0]) == serialize_wcs(wcs) and back["w"][1] is None


class TestConfigurationFitsForms:
    CFG = {"num_obs": 17, "cluster_type": "position", "color_scale": {"g": 0.25}, "sigmaG_lims": [20, 80],
           "result_filename": "/tmp/some dir/out.ecsv", "x_pixel_bounds": [0.5, 30]}

    @pytest.mark.parametrize("form", ["to_hdu", "to_reference_hdu"])
    def test_hdu_equals_jax_and_round_trips(self, form):
        hdu = getattr(TConfig(self.CFG), form)()
        jhdu = getattr(JConfig(self.CFG), form)()
        assert hdu.header == jhdu.header
        if form == "to_reference_hdu":
            assert hdu.columns == jhdu.columns and hdu.nrows == jhdu.nrows == 1
        back = TConfig.from_hdu(hdu)
        assert back.to_dict() == JConfig.from_hdu(jhdu).to_dict() == TConfig(self.CFG).to_dict()

    def test_reference_table_through_file(self, tmp_path):
        hdus = t_fits.HDUList([t_fits.ImageHDU(name="PRIMARY"), TConfig(self.CFG).to_reference_hdu()])
        hdus.writeto(str(tmp_path / "c.fits"))
        back = t_fits.read_fits(str(tmp_path / "c.fits"))["KBMOD_CONFIG"]
        assert TConfig.from_hdu(back) == TConfig(self.CFG)
        from kbmod_tpu.io.fits_io import read_fits as j_read_fits

        jback = JConfig.from_hdu(j_read_fits(str(tmp_path / "c.fits"))["KBMOD_CONFIG"])
        assert jback.to_dict() == TConfig(self.CFG).to_dict()
