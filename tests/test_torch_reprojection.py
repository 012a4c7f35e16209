"""The port's reprojection (ops/reproject, reprojection, reprojection_utils)
against the JAX package's, on the CPU (``device="cpu"``).

Tolerances:
- resampled values: |port - jax| <= 1e-5 * max(|jax|, 1). The JAX side runs
  XLA-CPU, which fuses some multiply-adds the port rounds twice and has its
  own ``exp``; the port keeps the reference's float32 operations in order.
- good masks: equal, except at pixels where both sides' footprints lie
  within 1e-5 of the 0.999 threshold (a few ulps of footprint can flip
  them); each test counts those pixels and prints the count.
- the coordinate grids and the parallax geometry (host numpy float64 in
  both packages): exact, or 1e-12 where a scipy minimizer runs.
The cases of tests/test_reprojection.py run again against the port with
their own bounds (flux conservation, anti-aliasing, the golden values).
"""

import numpy as np
import pytest
import torch

from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
from kbmod_tpu.fake_data.fake_data_creator import create_fake_times
from kbmod_tpu.geom.wcs import WCS as JWCS
from kbmod_tpu.ops import reproject as jrep
from kbmod_tpu import reprojection as jreprojection
from kbmod_tpu import reprojection_utils as jru
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs
from kbmod_tpu.work_unit import WorkUnit as JWorkUnit

from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.configuration import SearchConfiguration as TConfig
from kbmod_tpu_torch.geom.wcs import WCS
from kbmod_tpu_torch.ops import reproject as trep
from kbmod_tpu_torch.ops.reproject import compute_source_coordinates, resample_layer
from kbmod_tpu_torch import reprojection_utils as tru
from kbmod_tpu_torch.reprojection import reproject_lazy_work_unit, reproject_work_unit
from kbmod_tpu_torch.wcs_utils import make_fake_wcs
from kbmod_tpu_torch.work_unit import WorkUnit

REL = 1e-5
FOOT_NEAR = 1e-5
THRESHOLD = 0.999
DEG_PP = 0.5 / 3600.0


def _rotated(wcs_cls, h, w, angle_deg, scale=1.0, shift=(0.0, 0.0)):
    c, s = np.cos(np.radians(angle_deg)), np.sin(np.radians(angle_deg))
    step = DEG_PP * scale
    cd = np.array([[-step * c, step * s], [step * s, step * c]])
    return wcs_cls([w / 2.0 + 0.5 + shift[0], h / 2.0 + 0.5 + shift[1]], [45.0, 10.0], cd, shape=(h, w))


# (target WCS, output shape): a rotation, a sub-pixel shift with a small
# rotation, and a 2x downscale with a rotation.
TARGETS = {
    "rotated": lambda cls: (_rotated(cls, 48, 48, 30.0), (48, 48)),
    "shifted": lambda cls: (_rotated(cls, 48, 48, 0.2, shift=(3.3, 2.7)), (48, 48)),
    "downscaled": lambda cls: (_rotated(cls, 24, 24, 20.0, scale=2.0), (24, 24)),
}
METHODS = [("bilinear", False), ("adaptive", False), ("adaptive", True)]


def _layer(seed=0, h=48, w=48):
    rng = np.random.default_rng(seed)
    sci = rng.normal(10, 3, (h, w)).astype(np.float32)
    var = rng.uniform(1, 3, (h, w)).astype(np.float32)
    sci[5, 7] = np.nan
    var[20, 30] = np.nan
    var[31, 12] = np.inf
    return sci, var


def _footprints(sci, var, coords, method, conserve_flux):
    """Both sides' footprints, from their inner resampling functions."""
    ok = np.isfinite(sci) & np.isfinite(var)
    planes = np.stack([np.where(ok, sci, 0.0), np.where(ok, var, 0.0)]).astype(np.float32)
    val = ok.astype(np.float32)
    cy, cx = (np.asarray(c, dtype=np.float32) for c in coords)
    t_args = (torch.from_numpy(planes), torch.from_numpy(val), torch.from_numpy(cy), torch.from_numpy(cx))
    if method == "bilinear":
        _, jf = jrep._bilinear_resample(planes[0], val, cy, cx)
        _, tf = trep._bilinear_resample(*t_args)
    else:
        sigma = 1.3 / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        trunc = 0.5 * 1.3 * 4.0
        radius = jrep._stencil_radius(coords, trunc)
        assert radius == trep._stencil_radius(coords, trunc)
        _, jf = jrep._adaptive_resample(planes[0], val, cy, cx, radius, sigma * sigma, trunc * trunc, conserve_flux)
        _, tf = trep._adaptive_resample(*t_args, radius, sigma * sigma, trunc * trunc, conserve_flux)
    return np.asarray(jf), tf.numpy()


def assert_layers_match(ref, got, jfoot=None, tfoot=None, tag=""):
    """(sci, var, good) of both sides within REL, masks equal but for
    footprints within FOOT_NEAR of the threshold on both sides. Returns the
    count of such flipped pixels."""
    flips = ref[2] != got[2]
    if flips.any():
        assert jfoot is not None, f"{tag}: {int(flips.sum())} good pixels differ"
        near = (np.abs(jfoot - THRESHOLD) <= FOOT_NEAR) & (np.abs(tfoot - THRESHOLD) <= FOOT_NEAR)
        assert near[flips].all(), f"{tag}: good pixels differ away from the threshold"
    both = ref[2] & got[2]
    for a, b in zip(ref[:2], got[:2]):
        assert np.isnan(b[~got[2]]).all()
        bound = REL * np.maximum(np.abs(a[both]), 1.0)
        assert np.all(np.abs(a[both] - b[both]) <= bound), f"{tag}: max rel {np.max(np.abs(a[both] - b[both]) / bound)}"
    n = int(flips.sum())
    print(f"{tag}: {n} pixels flip at the footprint threshold")
    return n


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("method,conserve_flux", METHODS)
def test_resample_layer_matches_jax(target, method, conserve_flux):
    sci, var = _layer()
    src = make_fake_wcs(45.0, 10.0, 48, 48, DEG_PP)
    dst, shape = TARGETS[target](WCS)
    coords = compute_source_coordinates(src, dst, shape)
    jcoords = jrep.compute_source_coordinates(j_make_fake_wcs(45.0, 10.0, 48, 48, DEG_PP), TARGETS[target](JWCS)[0],
                                              shape)
    np.testing.assert_array_equal(coords, jcoords)
    ref = jrep.resample_layer(sci, var, jcoords, method=method, conserve_flux=conserve_flux)
    got = resample_layer(sci, var, coords, method=method, conserve_flux=conserve_flux, device="cpu")
    assert got[0].dtype == got[1].dtype == np.float32 and got[2].dtype == bool
    jf, tf = _footprints(sci, var, coords, method, conserve_flux)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=REL)
    assert_layers_match(ref, got, jf, tf, f"{target} {method} conserve_flux={conserve_flux}")
    assert got[2].sum() > 0.3 * got[2].size


def test_inverse_metric_and_gradient_match_jax():
    """torch.gradient (edge order 1) against jnp.gradient, and the clamped
    inverse metric, on coordinates with the -1e6 sentinel."""
    import jax.numpy as jnp

    src = make_fake_wcs(45.0, 10.0, 40, 40, DEG_PP)
    coords = compute_source_coordinates(src, _rotated(WCS, 20, 20, 20.0, scale=2.0), (20, 20)).astype(np.float32)
    coords[:, :3, :] = -1e6
    for c in coords:
        for a, b in zip(jnp.gradient(c), torch.gradient(torch.from_numpy(c), edge_order=1)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = jrep._clamped_inverse_metric(jnp.asarray(coords[0]), jnp.asarray(coords[1]))
    got = trep._clamped_inverse_metric(torch.from_numpy(coords[0]), torch.from_numpy(coords[1]))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=REL, atol=0)


def test_unknown_method_and_default_device():
    sci, var = _layer()
    coords = compute_source_coordinates(make_fake_wcs(45.0, 10.0, 48, 48), make_fake_wcs(45.0, 10.0, 48, 48), (48, 48))
    with pytest.raises(ValueError):
        resample_layer(sci, var, coords, method="nearest", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resample_layer(sci, var, coords)


class TestResample:
    def test_identity_reprojection(self):
        rng = np.random.default_rng(1)
        wcs = make_fake_wcs(45.0, 10.0, 32, 40)
        sci = rng.normal(0, 1, (32, 40)).astype(np.float32)
        var = np.full((32, 40), 2.0, dtype=np.float32)
        coords = compute_source_coordinates(wcs, wcs, (32, 40))
        sci_r, var_r, good = resample_layer(sci, var, coords, method="bilinear", device="cpu")
        assert np.all(good)
        np.testing.assert_allclose(sci_r, sci, atol=1e-4)
        np.testing.assert_allclose(var_r, var, atol=1e-4)

    def test_shifted_reprojection(self):
        rng = np.random.default_rng(2)
        wcs_a = make_fake_wcs(45.0, 10.0, 32, 40, DEG_PP)
        wcs_b = wcs_a.copy()
        wcs_b.crpix = wcs_b.crpix + np.array([3.0, 0.0])
        sci = rng.normal(0, 1, (32, 40)).astype(np.float32)
        var = np.full((32, 40), 2.0, dtype=np.float32)
        coords = compute_source_coordinates(wcs_a, wcs_b, (32, 40))
        sci_r, _, good = resample_layer(sci, var, coords, method="bilinear", device="cpu")
        np.testing.assert_allclose(sci_r[:, 3:], sci[:, :-3], atol=1e-3)
        assert not np.any(good[:, :3])

    @pytest.mark.parametrize("method", ["bilinear", "adaptive"])
    def test_mask_propagation(self, method):
        wcs = make_fake_wcs(45.0, 10.0, 24, 24, DEG_PP)
        sci = np.ones((24, 24), dtype=np.float32)
        sci[12, 12] = np.nan
        var = np.full((24, 24), 2.0, dtype=np.float32)
        coords = compute_source_coordinates(wcs, wcs, (24, 24))
        sci_r, _, good = resample_layer(sci, var, coords, method=method, device="cpu")
        assert not good[12, 12] and np.isnan(sci_r[12, 12])
        assert good[4, 4]
        np.testing.assert_allclose(sci_r[good], 1.0, atol=1e-5)


def _gaussian_blob(height, width, yc, xc, sigma, flux):
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    g = np.exp(-((yy - yc) ** 2 + (xx - xc) ** 2) / (2 * sigma**2))
    return (flux * g / g.sum()).astype(np.float32)


class TestAdaptiveResample:
    def test_identity_preserves_flux_and_constant(self):
        wcs = make_fake_wcs(45.0, 10.0, 48, 48, DEG_PP)
        sci = _gaussian_blob(48, 48, 23.3, 24.7, 2.5, flux=1000.0) + 5.0
        var = np.full((48, 48), 2.0, dtype=np.float32)
        sci_r, var_r, good = resample_layer(sci, var, compute_source_coordinates(wcs, wcs, (48, 48)), device="cpu")
        inner = good.copy()
        inner[:6] = inner[-6:] = inner[:, :6] = inner[:, -6:] = False
        np.testing.assert_allclose(var_r[good], 2.0, atol=1e-4)
        assert abs(float((sci_r[inner] - 5.0).sum()) - float((sci[inner] - 5.0).sum())) / 1000.0 < 0.01

    def test_flux_conserved_under_rotation(self):
        src = make_fake_wcs(45.0, 10.0, 64, 64, DEG_PP)
        sci = _gaussian_blob(64, 64, 31.6, 32.2, 2.0, flux=500.0)
        coords = compute_source_coordinates(src, _rotated(WCS, 64, 64, 30.0), (64, 64))
        sci_r, _, good = resample_layer(sci, np.ones((64, 64), np.float32), coords, device="cpu")
        assert abs(float(np.nansum(np.where(good, sci_r, 0.0))) - 500.0) / 500.0 < 0.01

    def test_flux_conserved_under_downscale(self):
        src = make_fake_wcs(45.0, 10.0, 64, 64, DEG_PP)
        sci = _gaussian_blob(64, 64, 31.4, 32.6, 2.0, flux=800.0)
        coords = compute_source_coordinates(src, _rotated(WCS, 32, 32, 20.0, scale=2.0), (32, 32))
        sci_r, _, good = resample_layer(sci, np.ones((64, 64), np.float32), coords, conserve_flux=True,
                                        device="cpu")
        assert abs(float(np.nansum(np.where(good, sci_r, 0.0))) - 800.0) / 800.0 < 0.02

    def test_antialiasing_beats_bilinear(self):
        src = make_fake_wcs(45.0, 10.0, 96, 96, DEG_PP)
        coords = compute_source_coordinates(src, _rotated(WCS, 40, 40, 10.0, scale=2.0), (40, 40))
        yy, xx = np.mgrid[0:96, 0:96].astype(np.float64)
        sci = (10.0 + 4.0 * np.sin(2 * np.pi * (xx + 0.6 * yy) / 2.3)).astype(np.float32)
        var = np.ones((96, 96), np.float32)
        ad, _, good_a = resample_layer(sci, var, coords, method="adaptive", device="cpu")
        bl, _, good_b = resample_layer(sci, var, coords, method="bilinear", device="cpu")
        both = good_a & good_b
        assert both.sum() > 400
        rms_ad = float(np.sqrt(np.mean((ad[both] - 10.0) ** 2)))
        rms_bl = float(np.sqrt(np.mean((bl[both] - 10.0) ** 2)))
        assert rms_ad < 0.4 and rms_bl > 4 * rms_ad
        assert float(np.sqrt(np.mean((ad[both] - bl[both]) ** 2))) > 0.5


def _unit_pair(times, h, w, seed, wcs_of):
    """The same WorkUnit in both packages, with per-image WCSes
    ``wcs_of(make_fake_wcs, i)``."""
    ds = JFakeDataSet(w, h, times, use_seed=seed, mask_fraction=0.02)
    jwu = ds.get_work_unit()
    st = ds.stack_py
    twu = WorkUnit(im_stack=TImageStackPy(times=list(st.times), sci=[np.array(s) for s in st.sci],
                                          var=[np.array(v) for v in st.var], psfs=[np.array(p) for p in st.psfs]),
                   config=TConfig(), obstimes=ds.times)
    for i in range(len(times)):
        jwu.org_img_meta["per_image_wcs"][i] = wcs_of(j_make_fake_wcs, i)
        twu.org_img_meta["per_image_wcs"][i] = wcs_of(make_fake_wcs, i)
    return jwu, twu


def _assert_units_match(jres, tres, tag):
    """Reprojected WorkUnits of both packages: the same layers, groups and
    PSFs; pixels within REL and the same NaN masks (a WorkUnit keeps no
    footprints, so a flip at the threshold would show here as a failure;
    test_resample_layer_matches_jax holds the layer-level rule)."""
    assert tres.im_stack.num_times == jres.im_stack.num_times
    assert tres._per_image_indices == jres._per_image_indices
    np.testing.assert_array_equal(tres.im_stack.times, jres.im_stack.times)
    for t in range(tres.im_stack.num_times):
        ref = [np.asarray(p[t]) for p in (jres.im_stack.sci, jres.im_stack.var)]
        got = [np.asarray(p[t]) for p in (tres.im_stack.sci, tres.im_stack.var)]
        assert_layers_match((*ref, np.isfinite(ref[0])), (*got, np.isfinite(got[0])), tag=f"{tag} layer {t}")
        np.testing.assert_array_equal(tres.im_stack.psfs[t], jres.im_stack.psfs[t])


class TestReprojectWorkUnit:
    @staticmethod
    def _shifted(make, i):
        wcs = make(45.0, 10.0, 48, 64, DEG_PP)
        wcs.crpix = wcs.crpix + np.array([0.5 * i, 0.25 * i])
        return wcs

    @pytest.mark.parametrize("frame", ["original", "ebd"])
    def test_frames_match_jax(self, frame):
        times = create_fake_times(6, t0=57130.2, obs_per_day=2)
        jwu, twu = _unit_pair(times, 48, 64, 31, self._shifted)
        jwu.barycentric_distance = twu.barycentric_distance = 40.0
        jcommon, common = j_make_fake_wcs(45.0, 10.0, 48, 64, DEG_PP), make_fake_wcs(45.0, 10.0, 48, 64, DEG_PP)
        if frame == "ebd":
            # The first image's EBD WCS: the parallax at 40 AU moves the
            # images far off the original frame.
            jcommon = jru.fit_barycentric_wcs(jwu.get_wcs(0), 64, 48, 40.0, times[0], jwu.observatory, 10, 101)[0]
            common = tru.fit_barycentric_wcs(twu.get_wcs(0), 64, 48, 40.0, times[0], twu.observatory, 10, 101)[0]
        jres = jreprojection.reproject_work_unit(jwu, jcommon, frame=frame)
        tres = reproject_work_unit(twu, common, frame=frame, device="cpu")
        assert tres.reprojected and tres.reprojection_frame == frame and tres.barycentric_distance == 40.0
        assert tres.im_stack.width == 64
        assert np.isfinite(tres.im_stack.sci[0]).sum() > 0.5 * 48 * 64
        _assert_units_match(jres, tres, frame)
        if frame == "ebd":
            from kbmod_tpu_torch.wcs_utils import serialize_wcs
            from kbmod_tpu.wcs_utils import serialize_wcs as j_serialize_wcs

            for a, b in zip(tres.org_img_meta["ebd_wcs"], jres.org_img_meta["ebd_wcs"]):
                assert serialize_wcs(a) == j_serialize_wcs(b)
            np.testing.assert_array_equal(np.asarray(tres.org_img_meta["geocentric_distance"], float),
                                          np.asarray(jres.org_img_meta["geocentric_distance"], float))

    def test_mosaic_with_collision(self):
        """Two same-time chips that overlap by 8 columns mosaic into one
        layer; the overlap is masked as a collision."""
        def wcs_of(make, i):
            wcs = make(45.0, 10.0, 32, 32, DEG_PP)
            if i == 1:
                wcs.crpix = wcs.crpix + np.array([24.0, 0.0])
            return wcs

        jwu, twu = _unit_pair([57130.2, 57130.2, 57130.5], 32, 32, 13, wcs_of)
        jcommon = j_make_fake_wcs(45.0, 10.0, 32, 64, DEG_PP)
        jcommon.crpix = jcommon.crpix + np.array([16.0, 0.0])
        common = make_fake_wcs(45.0, 10.0, 32, 64, DEG_PP)
        common.crpix = common.crpix + np.array([16.0, 0.0])
        jres = jreprojection.reproject_work_unit(jwu, jcommon)
        tres = reproject_work_unit(twu, common, device="cpu")
        assert tres.im_stack.num_times == 2 and tres._per_image_indices[0] == [0, 1]
        # Pixels both chips cover are NaN; a pixel one chip covers has its
        # value.
        layer = np.asarray(tres.im_stack.sci[0])
        alone = [resample_layer(twu.im_stack.sci[i], twu.im_stack.var[i],
                                compute_source_coordinates(twu.get_wcs(i), common, (32, 64)), device="cpu")
                 for i in (0, 1)]
        both = alone[0][2] & alone[1][2]
        assert both.sum() > 50 and np.isnan(layer[both]).all()
        for i in (0, 1):
            only = alone[i][2] & ~both
            assert only.sum() > 400
            np.testing.assert_array_equal(layer[only], alone[i][0][only])
        np.testing.assert_array_equal(tres.im_stack.psfs[0], twu.im_stack.psfs[0])
        _assert_units_match(jres, tres, "mosaic")

    def test_reproject_twice_raises(self):
        _, twu = _unit_pair(create_fake_times(2, t0=57130.2), 48, 64, 31, self._shifted)
        common = make_fake_wcs(45.0, 10.0, 48, 64, DEG_PP)
        result = reproject_work_unit(twu, common, device="cpu")
        with pytest.raises(ValueError):
            reproject_work_unit(result, common, device="cpu")
        with pytest.raises(ValueError):
            reproject_work_unit(twu, common, frame="galactic", device="cpu")


class TestLazyReprojection:
    @staticmethod
    def _sharded(tmp_path):
        def wcs_of(make, i):
            wcs = make(45.0, 10.0, 32, 40, DEG_PP)
            wcs.crpix = wcs.crpix + np.array([4.0 * (i % 2), 0.5 * i])
            return wcs

        times = [57130.2, 57130.2, 57130.5, 57130.5, 57130.8, 57130.8]
        jwu, twu = _unit_pair(times, 32, 40, 77, wcs_of)
        twu.to_sharded_fits("wu.fits", tmp_path / "input")
        return jwu, twu, tmp_path / "input"

    def test_lazy_matches_eager_and_jax(self, tmp_path):
        jwu, twu, in_dir = self._sharded(tmp_path)
        lazy = WorkUnit.from_sharded_fits("wu.fits", in_dir, lazy=True)
        common = make_fake_wcs(45.0, 10.0, 32, 48, DEG_PP)
        reproject_lazy_work_unit(lazy, common, str(tmp_path / "out"), "reproj.fits", device="cpu")
        assert lazy.lazy and lazy.im_stack.num_times == 0
        got = WorkUnit.from_sharded_fits("reproj.fits", tmp_path / "out")
        want = reproject_work_unit(twu, common, device="cpu")
        assert got.reprojected and got.im_stack.num_times == want.im_stack.num_times == 3
        assert got._per_image_indices == want._per_image_indices
        for i in range(3):
            np.testing.assert_array_equal(got.im_stack.sci[i], want.im_stack.sci[i])
            np.testing.assert_array_equal(got.im_stack.var[i], want.im_stack.var[i])
            assert got.im_stack.times[i] == want.im_stack.times[i]
        # The JAX package's lazy path on the port's shards writes the same
        # head file and equal layers.
        jlazy = JWorkUnit.from_sharded_fits("wu.fits", in_dir, lazy=True)
        jreprojection.reproject_lazy_work_unit(jlazy, j_make_fake_wcs(45.0, 10.0, 32, 48, DEG_PP),
                                              str(tmp_path / "jout"), "reproj.fits")
        assert (tmp_path / "out" / "reproj.fits").read_bytes() == (tmp_path / "jout" / "reproj.fits").read_bytes()
        _assert_units_match(JWorkUnit.from_sharded_fits("reproj.fits", tmp_path / "jout"), got, "lazy")

    def test_lazy_loads_one_group_at_a_time(self, tmp_path, monkeypatch):
        import kbmod_tpu_torch.work_unit as wu_mod

        _, _, in_dir = self._sharded(tmp_path)
        lazy = WorkUnit.from_sharded_fits("wu.fits", in_dir, lazy=True)
        load_order = []
        real_loader = wu_mod.load_layered_image_from_shard

        def counting_loader(path):
            load_order.append(path)
            return real_loader(path)

        monkeypatch.setattr(wu_mod, "load_layered_image_from_shard", counting_loader)
        reproject_lazy_work_unit(lazy, make_fake_wcs(45.0, 10.0, 32, 48, DEG_PP), str(tmp_path / "o2"),
                                 "reproj.fits", device="cpu")
        assert [p.split("/")[-1] for p in load_order] == [f"{i}_wu.fits" for i in range(6)]

    def test_non_lazy_raises(self, tmp_path):
        _, twu, _ = self._sharded(tmp_path)
        with pytest.raises(ValueError):
            reproject_lazy_work_unit(twu, make_fake_wcs(45.0, 10.0, 32, 48, DEG_PP), str(tmp_path / "o"), "r.fits",
                                     device="cpu")


def _mjd(iso):
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(iso).replace(tzinfo=timezone.utc)
    return (dt - datetime(1858, 11, 17, tzinfo=timezone.utc)).total_seconds() / 86400.0


class TestParallax:
    """The cases of tests/test_reprojection.py's parallax classes against
    the port, each also equal to the JAX package's numbers."""

    def test_roundtrip(self):
        ra, dec = np.array([200.0, 201.0, 44.0]), np.array([-7.0, -6.5, 12.0])
        mjds = np.array([57130.2, 57131.2, 57132.2])
        corrected, dists = tru.correct_parallax_geometrically_vectorized(ra, dec, mjds, 40.0)
        jcorr, jdists = jru.correct_parallax_geometrically_vectorized(ra, dec, mjds, 40.0)
        np.testing.assert_array_equal(corrected.ra_deg, jcorr.ra_deg)
        np.testing.assert_array_equal(dists, jdists)
        assert np.all(dists > 38.0)
        back = tru.invert_correct_parallax_vectorized(corrected, mjds)
        np.testing.assert_allclose(back.ra_deg, ra, atol=1e-8)
        np.testing.assert_allclose(back.dec_deg, dec, atol=1e-8)

    def test_no_solution_inside_earth_orbit(self):
        corrected, _ = tru.correct_parallax_geometrically_vectorized([200.0], [-7.0], [57130.2], 0.5)
        assert np.isnan(corrected.ra_deg[0])

    def test_fit_barycentric_wcs(self):
        wcs = make_fake_wcs(200.0, -7.0, 200, 200, DEG_PP)
        ebd, geo = tru.fit_barycentric_wcs(wcs, 200, 200, 40.0, 57130.2, seed=101)
        jebd, jgeo = jru.fit_barycentric_wcs(j_make_fake_wcs(200.0, -7.0, 200, 200, DEG_PP), 200, 200, 40.0, 57130.2,
                                             seed=101)
        np.testing.assert_array_equal(ebd.cd, jebd.cd)
        assert geo == jgeo and 38.5 < geo < 41.5
        ra, dec = wcs.pixel_to_world_values(100.0, 100.0)
        corrected, _ = tru.correct_parallax_geometrically_vectorized([ra], [dec], [57130.2], 40.0)
        x, y = ebd.world_to_pixel_values(corrected.ra_deg[0], corrected.dec_deg[0])
        assert abs(x - 100.0) < 0.2 and abs(y - 100.0) < 0.2

    def test_equinox_golden(self):
        out, dist = tru.correct_parallax_geometrically_vectorized(
            np.array([88.74513571, 91.24261107]), np.array([23.43426475, 23.43437467]),
            np.array([_mjd("2023-03-20T16:00:00"), _mjd("2023-09-24T04:00:00")]), 50.0,
        )
        np.testing.assert_allclose(np.array(out.ra.deg), [90.0, 90.0], atol=2e-4)
        np.testing.assert_allclose(np.array(out.dec.deg), [23.43952556, 23.43952556], atol=1e-4)
        np.testing.assert_allclose(dist, 50.0013, atol=2e-3)

    def test_scalar_apis(self):
        geo, s_geo = tru.correct_parallax_geometrically((88.74513571, 23.43426475), 60023.6667, None, 50.0)
        assert abs(float(np.asarray(geo.ra_deg)) - 90.0) < 0.01 and 49.0 < s_geo < 51.0
        mini, s_min = tru.correct_parallax_with_minimizer((88.74513571, 23.43426475), 60023.6667, None, 50.0)
        np.testing.assert_allclose(float(np.asarray(mini.ra_deg)), float(np.asarray(geo.ra_deg)), atol=1e-4)
        np.testing.assert_allclose(s_min, s_geo, atol=1e-4)
        jmini, js_min = jru.correct_parallax_with_minimizer((88.74513571, 23.43426475), 60023.6667, None, 50.0)
        assert abs(s_min - js_min) <= 1e-12
        _, s_in = tru.correct_parallax_with_minimizer((90.0, 0.0), 60000.0, None, 0.5)
        assert np.isfinite(s_in) and s_in >= 0.0

    def test_module_level_position_inverse(self):
        wcs = make_fake_wcs(200.0, -7.0, 64, 64)
        jw = j_make_fake_wcs(200.0, -7.0, 64, 64)
        out = tru.image_positions_to_original_icrs([0], [(10.0, 20.0)], wcs, [wcs], [60000.0],
                                                   reprojection_frame="original", output_format="xy")
        np.testing.assert_allclose(out[0], (10.0, 20.0), atol=1e-6)
        kw = dict(reprojection_frame="ebd", barycentric_distance=40.0, output_format="radec", filter_in_frame=False)
        ebd = tru.image_positions_to_original_icrs([0], [(10.0, 20.0)], wcs, [wcs], [60000.0], **kw)
        assert ebd == jru.image_positions_to_original_icrs([0], [(10.0, 20.0)], jw, [jw], [60000.0], **kw)
        with pytest.raises(ValueError):
            tru.image_positions_to_original_icrs([0], [(1, 2)], wcs, [wcs], [60000.0], input_format="bananas")

    def test_topocentric_roundtrip_and_site(self):
        from kbmod_tpu_torch.geom.wcs import SkyCoordLite
        from kbmod_tpu_torch.work_unit import RUBIN_LOCATION_M

        rng = np.random.default_rng(5)
        ra, dec, mjds = rng.uniform(0, 360, 20), rng.uniform(-80, 80, 20), rng.uniform(59000, 61000, 20)
        corr, _ = tru.correct_parallax_geometrically_vectorized(ra, dec, mjds, 8.0, RUBIN_LOCATION_M)
        jcorr, _ = jru.correct_parallax_geometrically_vectorized(ra, dec, mjds, 8.0, RUBIN_LOCATION_M)
        np.testing.assert_array_equal(corr.dec_deg, jcorr.dec_deg)
        back = tru.invert_correct_parallax_vectorized(corr, mjds, RUBIN_LOCATION_M)
        assert np.nanmax(SkyCoordLite(ra, dec).separation_deg(back) * 3600) < 1e-6
        without = tru.invert_correct_parallax_vectorized(corr, mjds, None)
        assert (back.separation_deg(without) * 3600).max() > 0.05
        site = tru.invert_correct_parallax(SkyCoordLite(10.0, 5.0), 60123.6, RUBIN_LOCATION_M,
                                           heliocentric_distance=3.0)
        from kbmod_tpu.geom.wcs import SkyCoordLite as JSkyCoordLite

        jsite = jru.invert_correct_parallax(JSkyCoordLite(10.0, 5.0), 60123.6, RUBIN_LOCATION_M,
                                            heliocentric_distance=3.0)
        assert float(site.ra_deg) == float(jsite.ra_deg)
