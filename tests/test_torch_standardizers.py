"""The port's standardizers and ImageCollection against the JAX package's,
on the CPU.

The cases of tests/test_standardizers.py and tests/test_butler_standardizer.py
run again against kbmod_tpu_torch (synthetic FITS files written by the
port's io.fits_io, the Butler through tests/utils/mock_butler.py); then one
file standardized by both packages, the two registries kept apart, and
collection files written by each package and read by the other.

Tolerances: none. Metadata, serialized WCS, masks (grow_mask on and off),
science, variance, PSFs and collection tables are equal: the standardizers
are the same host code in both packages.
"""

import os
import tempfile

import numpy as np
import pytest

from kbmod_tpu_torch.io import fits_io
from kbmod_tpu_torch.image_collection import ImageCollection
from kbmod_tpu_torch.standardizers import Standardizer, StandardizerConfig, KBMODV1, SingleExtensionFits
from kbmod_tpu_torch.wcs_utils import make_fake_wcs


def write_rubin_style_fits(path, seed=0, mjd=57130.5, shape=(32, 36), ra=200.0, dec=-7.0):
    """A synthetic Rubin-imdiff-style FITS file: PRIMARY (with the Rubin
    signature keys) + IMAGE/MASK/VARIANCE extensions."""
    from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime

    rng = np.random.default_rng(seed)
    primary = fits_io.ImageHDU(name="PRIMARY")
    primary.header.update(
        {
            "ZTENSION": "IMAGE",
            "ZPCOUNT": 0,
            "ZGCOUNT": 1,
            "CCDNUM": 42,
            "DATE-AVG": mjd_to_datetime(mjd).strftime("%Y-%m-%dT%H:%M:%S.%f"),
            "EXPREQ": 200.0,
            "OBS-LONG": -70.81,
            "OBS-LAT": -30.17,
            "OBS-ELEV": 2215.0,
            "FILTER": "r",
            "IDNUM": 1,
            "EXPID": 100 + seed,
            "OBSID": f"obs_{seed}",
            "DTNSANAM": "fake.fits",
            "AIRMASS": 1.2,
            "DIMM2SEE": 0.9,
            "GAINA": 1.0,
            "GAINB": 1.0,
        }
    )
    wcs = make_fake_wcs(ra, dec, shape[0], shape[1], 0.26 / 3600.0)

    image = fits_io.ImageHDU(rng.normal(0, 1, shape).astype(np.float32), name="IMAGE")
    image.header.update(wcs.to_header())
    image.header["MJD"] = mjd
    mask = fits_io.ImageHDU(np.zeros(shape, dtype=np.int32), name="MASK")
    mask.data[2, 3] = 2**0  # BAD
    variance = fits_io.ImageHDU(np.full(shape, 4.0, dtype=np.float32), name="VARIANCE")

    fits_io.write_fits(path, [primary, image, mask, variance])
    return path


class TestStandardizerResolution:
    def test_kbmodv1_volunteers(self):
        with tempfile.TemporaryDirectory() as tmp:
            path = write_rubin_style_fits(os.path.join(tmp, "img.fits"))
            std = Standardizer.get(path)
            assert isinstance(std, KBMODV1)

    def test_force_by_name(self):
        with tempfile.TemporaryDirectory() as tmp:
            path = write_rubin_style_fits(os.path.join(tmp, "img.fits"))
            std = Standardizer.get(path, force="KBMODV1")
            assert isinstance(std, KBMODV1)
            with pytest.raises(KeyError):
                Standardizer.get(path, force="NoSuchStandardizer")

    def test_unresolvable(self):
        with pytest.raises(ValueError):
            Standardizer.get("/nonexistent/file.fits")


class TestKBMODV1:
    def test_standardize(self):
        with tempfile.TemporaryDirectory() as tmp:
            path = write_rubin_style_fits(os.path.join(tmp, "img.fits"))
            std = KBMODV1(path)
            meta = std.standardizeMetadata()
            assert abs(meta["mjd_mid"][0] - 57130.5) < 0.01
            assert meta["FILTER"][0] == "r"
            # The center ra/dec come from the WCS.
            assert abs(meta["ra"][0] - 200.0) < 0.01
            assert abs(meta["dec"][0] - (-7.0)) < 0.01

            sci = std.standardizeScienceImage()[0]
            var = std.standardizeVarianceImage()[0]
            mask = std.standardizeMaskImage()[0]
            assert sci.shape == (32, 36)
            assert np.allclose(var, 4.0)
            # Mask grown around the BAD pixel.
            assert mask[2, 3]
            assert mask[5, 6]
            assert not mask[25, 30]

    def test_to_layered_image(self):
        with tempfile.TemporaryDirectory() as tmp:
            path = write_rubin_style_fits(os.path.join(tmp, "img.fits"))
            std = KBMODV1(path)
            layered = std.toLayeredImage()
            assert len(layered) == 1
            img = layered[0]
            # The mask is carried with the layer (applied as NaN when the
            # layer joins an ImageStackPy, matching the reference).
            assert img.mask[2, 3]
            assert abs(img.time - 57130.5) < 0.01


class TestImageCollection:
    def _make_collection(self, tmp, n=4):
        paths = [
            write_rubin_style_fits(os.path.join(tmp, f"img_{i}.fits"), seed=i, mjd=57130.0 + 0.05 * i)
            for i in range(n)
        ]
        return ImageCollection.fromTargets(paths)

    def test_from_targets(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            assert len(ic) == 4
            assert "mjd_mid" in ic.columns
            assert "std_idx" in ic.columns
            assert np.allclose(np.sort(ic["mjd_mid"]), 57130.0 + 0.05 * np.arange(4))

    def test_from_dir(self):
        with tempfile.TemporaryDirectory() as tmp:
            self._make_collection(tmp)
            ic = ImageCollection.fromDir(tmp)
            assert len(ic) == 4

    def test_filter_by_time_range(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            ic.filter_by_time_range(start_mjd=57130.06)
            assert len(ic) == 2

    def test_filter_by_bands(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            ic.filter_by_bands(["r"])
            assert len(ic) == 4
            ic.filter_by_bands(["g"])
            assert len(ic) == 0

    def test_ecsv_roundtrip(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            path = os.path.join(tmp, "collection.ecsv")
            ic.write(path)
            ic2 = ImageCollection.read(path)
            assert len(ic2) == 4
            np.testing.assert_allclose(
                np.asarray(ic2["mjd_mid"], dtype=float), np.asarray(ic["mjd_mid"], dtype=float)
            )
            # Lazy standardizers rebuild from the metadata.
            entry = ic2.get_standardizer(0)
            assert entry["std"] is not None

    def test_reflex_correct(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            ic.reflex_correct(5.0)
            assert "ra_5.0" in ic.columns
            assert "dec_5.0" in ic.columns
            # The parallax correction at 5 AU moves coordinates by up to
            # ~arcsin(1/5) ~ 11.5 deg, and by a nonzero amount.
            shift = np.abs(np.asarray(ic["ra_5.0"]) - np.asarray(ic["ra"], dtype=float))
            assert np.all(shift < 15.0)
            assert np.all(shift > 1e-6)

    def test_to_work_unit(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._make_collection(tmp)
            work = ic.toWorkUnit()
            assert work.im_stack.num_times == 4
            assert work.im_stack.width == 36
            # Masked pixel propagated to NaN.
            assert np.isnan(work.im_stack.sci[0][2, 3])
            # Per-image WCS preserved.
            assert work.get_wcs(0) is not None


class TestImageCollectionIndexing:
    def _ic(self, tmp, n=5):
        paths = [
            write_rubin_style_fits(os.path.join(tmp, f"ix_{i}.fits"), seed=i, mjd=57130.0 + 0.05 * i)
            for i in range(n)
        ]
        return ImageCollection.fromTargets(paths)

    def test_index_types(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            # Column access, row access, fancy/slice -> sub-collection.
            assert len(ic["mjd_mid"]) == 5
            row = ic[0]
            assert "mjd_mid" in row.keys()
            assert isinstance(ic[[0, 1]], ImageCollection)
            assert isinstance(ic[:3], ImageCollection)
            assert len(ic[1:3]) == 2

    def test_subset_reset_lazy_indices(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            subset = ic[[0, 2, 3, 4]]
            subset.reset_lazy_loading_indices()
            assert list(np.asarray(subset.data["std_idx"], dtype=int)) == [0, 1, 2, 3]
            # The subset still standardizes correctly after reindexing.
            assert subset.get_standardizer(1)["std"] is not None

    def test_filter_by_mjds_semantics(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp, 5)
            with pytest.raises(ValueError):
                ic.filter_by_mjds([57130.0], time_sep_s=-1)
            # Exact times keep everything.
            ic.filter_by_mjds(list(np.asarray(ic["mjd_mid"], dtype=float)))
            assert len(ic) == 5
            # Offsets below tolerance keep matches; dropping the last 2 times
            # drops those rows.
            times = np.asarray(ic["mjd_mid"], dtype=float) - 0.0001 / 86400.0
            ic.filter_by_mjds(times[:3])
            assert len(ic) == 3
            # 29s offsets within a 30s tolerance.
            times = np.asarray(ic["mjd_mid"], dtype=float) - 29.0 / 86400.0
            ic.filter_by_mjds(times[:2], time_sep_s=30)
            assert len(ic) == 2
            # Exact-match tolerance filters everything.
            ic.filter_by_mjds(times, time_sep_s=0)
            assert len(ic) == 0

    def test_vstack(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic1 = self._ic(tmp, 2)
            with tempfile.TemporaryDirectory() as tmp2:
                ic2 = ImageCollection.fromTargets([
                    write_rubin_style_fits(os.path.join(tmp2, "v.fits"), seed=9, mjd=57140.0)
                ])
                ic1.vstack([ic2])
                assert len(ic1) == 3
                # Standardizers from both collections stay reachable.
                assert ic1.get_standardizer(2)["std"] is not None


class TestStandardizerConfig:
    """Dict-like StandardizerConfig behavior (reference test_std_config.py)."""

    def test_dict_behavior(self):
        expected = {"a": 1, "b": 2, "c": 3}
        conf = StandardizerConfig(expected)
        assert len(conf) == 3
        assert list(conf.keys()) == ["a", "b", "c"]
        assert list(conf.values()) == [1, 2, 3]
        assert "a" in conf and "noexist" not in conf

        conf2 = StandardizerConfig(a=1, b=2, c=3)
        assert conf == conf2
        with pytest.raises(KeyError):
            conf2["noexist"]

        conf["a"] = 10
        assert conf["a"] == 10
        assert list(iter(conf)) == ["a", "b", "c"]

        conf.update(conf2)
        assert conf == conf2
        conf.update(expected)
        assert conf == expected
        conf.update({"a": 11, "b": 12, "c": 13})
        assert conf.toDict() == {"a": 11, "b": 12, "c": 13}
        conf.update(a=1, b=2, c=3)
        assert conf == conf2
        with pytest.raises(TypeError):
            conf2.update([1, 2, 3])

    def test_or(self):
        expected = {"a": 1, "b": 2, "c": 3}
        assert (StandardizerConfig(a=1, b=2, c=3) | StandardizerConfig(expected)) == expected


class TestKBMODV05:
    """Legacy DECam layout: PRIMARY(header) + science + mask + variance,
    forced via Standardizer.get(force=...) since the legacy standardizer
    does not volunteer."""

    def _write_v05(self, path, seed=0, mjd=57130.5, shape=(24, 28)):
        from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime

        rng = np.random.default_rng(seed)
        primary = fits_io.ImageHDU(name="PRIMARY")
        primary.header.update({
            "DATE-AVG": mjd_to_datetime(mjd).strftime("%Y-%m-%dT%H:%M:%S.%f"),
            "FILTER": "g",
            "EXPID": 7 + seed,
            "OBSID": f"legacy_{seed}",
        })
        wcs = make_fake_wcs(210.0, -5.0, shape[0], shape[1], 0.26 / 3600.0)
        sci = fits_io.ImageHDU(
            data=rng.normal(10, 2, shape).astype(np.float32), name="SCI"
        )
        for k, v in wcs.to_header().items():
            sci.header[k] = v
        mask_data = np.zeros(shape, dtype=np.int32)
        mask_data[3, 4] = 1
        mask = fits_io.ImageHDU(data=mask_data, name="MSK")
        var = fits_io.ImageHDU(
            data=rng.uniform(1, 2, shape).astype(np.float32), name="VAR"
        )
        fits_io.HDUList([primary, sci, mask, var]).writeto(path)
        return path

    def test_standardize(self):
        from kbmod_tpu_torch.standardizers import KBMODV0_5

        with tempfile.TemporaryDirectory() as tmp:
            path = self._write_v05(os.path.join(tmp, "legacy.fits"))
            can, _ = KBMODV0_5.resolveTarget(path)
            assert can
            std = Standardizer.get(path, force=KBMODV0_5)
            meta = std.standardizeMetadata()
            assert abs(meta["mjd"][0] - 57130.5) < 1e-5
            assert meta["FILTER"][0] == "g"
            layered = std.toLayeredImage()
            assert len(layered) == 1
            assert layered[0].sci.shape == (24, 28)
            # Masked pixel propagates.
            assert layered[0].mask[3, 4]

    def test_does_not_volunteer(self):
        from kbmod_tpu_torch.standardizers import KBMODV0_5

        assert not KBMODV0_5.can_volunteer

    def test_rejects_short_hdulist(self):
        from kbmod_tpu_torch.standardizers import KBMODV0_5

        with tempfile.TemporaryDirectory() as tmp:
            path = write_rubin_style_fits(os.path.join(tmp, "r.fits"))
            # Rubin-style file has a different extension layout but 4 HDUs;
            # resolveTarget keys on DATE-AVG + shapes, which it satisfies,
            # so instead test a 2-HDU file.
            p2 = os.path.join(tmp, "short.fits")
            fits_io.HDUList([
                fits_io.ImageHDU(name="PRIMARY"),
                fits_io.ImageHDU(data=np.zeros((4, 4), dtype=np.float32)),
            ]).writeto(p2)
            can, _ = KBMODV0_5.resolveTarget(p2)
            assert not can


class TestObsNightsSpanned:
    def test_spanned_nights(self):
        with tempfile.TemporaryDirectory() as tmp:
            paths = [
                write_rubin_style_fits(os.path.join(tmp, f"n_{i}.fits"), seed=i)
                for i in range(10)
            ]
            ic = ImageCollection.fromTargets(paths)
            # Consecutive nights 2023-01-01..2023-01-10 (MJD 59945..59954).
            ic.data["mjd_mid"] = 59945.0 + np.arange(10)
            assert ic.obs_nights_spanned() == 10
            # Repeats out of order across a leap day:
            # 2024-02-27 (60367) .. 2024-03-03 (60372) spans 6 nights.
            ic.data["mjd_mid"] = np.array(
                5 * [60372.3] + 2 * [60367.1] + 3 * [60371.2]
            )
            assert ic.obs_nights_spanned() == 6


class TestImageCollectionMethods:
    def _ic(self, tmp, n=3):
        paths = [
            write_rubin_style_fits(os.path.join(tmp, f"m_{i}.fits"), seed=i, mjd=57130.0 + 0.1 * i)
            for i in range(n)
        ]
        return ImageCollection.fromTargets(paths)

    def test_remove_column_guards(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            ic.data["extra"] = [1, 2, 3]
            ic.remove_column("extra")
            assert "extra" not in ic.columns
            import warnings as _w

            with _w.catch_warnings(record=True) as rec:
                _w.simplefilter("always")
                ic.remove_column("mjd_mid")
            assert "mjd_mid" in ic.columns and len(rec) == 1

    def test_reflex_corrected_col(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            assert ic.reflex_corrected_col("ra", 0.0) == "ra"
            assert ic.reflex_corrected_col("ra", 5.0) == "ra_5.0"
            with pytest.raises(ValueError):
                ic.reflex_corrected_col("nope", 5.0)
            with pytest.raises(ValueError):
                ic.reflex_corrected_col("ra", 5)

    def test_drop_bands_and_wcs_error(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            ic.drop_bands(["g"])   # all rows are r-band
            assert len(ic) == 3
            ic.data["wcs_err"] = [0.1 / 3600, 0.5 / 3600, 2.0 / 3600]
            ic.filter_by_wcs_error(1.0)  # arcsec
            assert len(ic) == 2
            with pytest.raises(ValueError):
                ic.filter_by_wcs_error(-1.0)
            ic.drop_bands(["r"])
            assert len(ic) == 0

    def test_get_wcs_and_bbox(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            wcs = ic.get_wcs(0)
            assert wcs is not None
            wcss = ic.get_wcs([0, 2])
            assert len(wcss) == 2
            box = ic.get_bbox(0)
            for key in ("ra", "dec", "ra_tl", "dec_br"):
                assert key in box
            boxes = list(ic.bbox())
            assert len(boxes) == 3

    def test_pack_unpack_roundtrip(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            before = {c: list(map(str, ic.data[c])) for c in ic.columns}
            assert not ic.is_packed
            ic.pack()
            assert ic.is_packed
            # The shared filter column moved into metadata.
            assert "filter" not in ic.columns
            ic.unpack()
            assert not ic.is_packed
            for c in before:
                assert list(map(str, ic.data[c])) == before[c]

    def test_to_bintable_roundtrip(self):
        with tempfile.TemporaryDirectory() as tmp:
            ic = self._ic(tmp)
            hdu = ic.toBinTableHDU()
            back = ImageCollection.fromBinTableHDU(hdu)
            assert len(back) == 3
            assert ic.validate()


# ----------------------------------------------------------------------
# tests/test_butler_standardizer.py against the port, on the mock LSST stack
# ----------------------------------------------------------------------

class TestButlerStandardizer:
    def setup_method(self):
        from tests.utils.mock_butler import MockButler, MockDatasetRef, MockExposure, install_mock_lsst

        install_mock_lsst()
        from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer

        self.butler = MockButler()
        self.exposure = MockExposure()
        self.ref = MockDatasetRef(self.exposure)
        self.std = ButlerStandardizer(self.ref, butler=self.butler)

    def test_metadata(self):
        meta = self.std.standardizeMetadata()
        assert abs(meta["mjd_mid"][0] - 57130.5) < 1e-6
        assert abs(meta["ra"][0] - 200.0) < 0.01
        assert meta["filter"][0] == "r"
        assert meta["visit"][0] == 12345
        assert type(meta["wcs"][0]).__module__ == "kbmod_tpu_torch.geom.wcs"

    def test_images(self):
        sci = self.std.standardizeScienceImage()[0]
        var = self.std.standardizeVarianceImage()[0]
        mask = self.std.standardizeMaskImage()[0]
        assert sci.shape == (32, 36)
        assert np.allclose(var, 4.0)
        assert mask[2, 3]  # BAD pixel masked (and grown)
        assert mask[5, 6]

    def test_to_layered_image(self):
        layered = self.std.toLayeredImage()
        assert len(layered) == 1
        assert layered[0].sci.shape == (32, 36)
        assert abs(layered[0].time - 57130.5) < 1e-6

    def test_psf_fallback(self):
        psf = self.std.standardizePSF()[0]
        assert psf.ndim == 2
        assert np.isclose(psf.sum(), 1.0, atol=1e-5)


def test_butler_standardizer_matches_jax_package():
    """The same mock exposure through both packages' ButlerStandardizer."""
    from tests.utils.mock_butler import MockButler, MockDatasetRef, MockExposure, install_mock_lsst

    install_mock_lsst()
    from kbmod_tpu.standardizers.butler_standardizer import ButlerStandardizer as JButler
    from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer as TButler

    butler = MockButler()
    ref = MockDatasetRef(MockExposure(seed=4))
    t, j = TButler(ref, butler=butler), JButler(ref, butler=butler)
    _assert_same_meta(t.standardizeMetadata(), j.standardizeMetadata())
    _assert_same_layers(t.toLayeredImage(), j.toLayeredImage())


# ----------------------------------------------------------------------
# Parity with the JAX package
# ----------------------------------------------------------------------

from kbmod_tpu import standardizers as jstd  # noqa: E402
from kbmod_tpu.image_collection import ImageCollection as JImageCollection  # noqa: E402
from kbmod_tpu.io import fits_io as j_fits_io  # noqa: E402
from kbmod_tpu.wcs_utils import serialize_wcs as j_serialize_wcs  # noqa: E402

from kbmod_tpu_torch.wcs_utils import serialize_wcs  # noqa: E402


def write_scattered_mask_fits(path, seed=0, mjd=57130.5, shape=(40, 44), ra=200.0, dec=-7.0):
    """A Rubin-style file whose mask plane holds scattered flags: BAD,
    SUSPECT and NO_DATA bits (masked by default) beside DETECTED and SAT
    bits (not masked by default), and bright pixels for the threshold."""
    write_rubin_style_fits(path, seed=seed, mjd=mjd, shape=shape, ra=ra, dec=dec)
    hdul = fits_io.read_fits(path)
    rng = np.random.default_rng(100 + seed)
    bits = rng.choice([0, 2**0, 2**1, 2**5, 2**7, 2**8], size=shape, p=[0.9, 0.02, 0.02, 0.03, 0.01, 0.02])
    mask = fits_io.ImageHDU(bits.astype(np.int32), name="MASK")
    image = hdul["IMAGE"]
    image.data[rng.uniform(size=shape) < 0.02] = 25.0
    fits_io.write_fits(path, [hdul[0], image, mask, hdul["VARIANCE"]])
    return path


def _same_value(a, b):
    if hasattr(a, "crval") or hasattr(b, "crval"):
        return serialize_wcs(a) == j_serialize_wcs(b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _assert_same_meta(t, j):
    assert t.keys() == j.keys()
    for key in t:
        assert _same_value(t[key], j[key]), (key, t[key], j[key])


def _assert_same_layers(t_layers, j_layers):
    assert len(t_layers) == len(j_layers)
    for a, b in zip(t_layers, j_layers):
        for plane in ("sci", "var", "mask", "psf"):
            x, y = np.asarray(getattr(a, plane)), np.asarray(getattr(b, plane))
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), plane
        assert a.time == b.time


@pytest.mark.parametrize(
    "config",
    [None, {"grow_mask": False}, {"do_threshold": True, "brightness_threshold": 5.0},
     {"do_bitmask": False}, {"grow_kernel_shape": (5, 3)}, {"mask_flags": ["SAT", "DETECTED"]},
     {"do_mask": False}],
    ids=["default", "no-grow", "threshold", "no-bitmask", "kernel-5x3", "flags", "no-mask"],
)
def test_kbmodv1_same_file_both_packages(tmp_path, config):
    """One file through both packages' KBMODV1: equal metadata (the WCS
    serialized), masks (the even 10 x 10 grow's off-centre alignment
    included), science, variance, PSFs and layered images."""
    path = write_scattered_mask_fits(str(tmp_path / "img.fits"), seed=3)
    t, j = KBMODV1(path, config=config), jstd.KBMODV1(path, config=config)
    _assert_same_meta(t.standardizeMetadata(), j.standardizeMetadata())
    for name in ("standardizeScienceImage", "standardizeVarianceImage", "standardizeMaskImage",
                 "standardizePSF"):
        for x, y in zip(getattr(t, name)(), getattr(j, name)()):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    _assert_same_layers(t.toLayeredImage(), j.toLayeredImage())
    if config is None:
        # The grow masks most of this image: scattered flags grown by 10 x 10.
        assert t.standardizeMaskImage()[0].mean() > 0.5


def test_other_standardizers_same_file_both_packages(tmp_path):
    """MultiExtensionFits (forced), SingleExtensionFits and KBMODV0_5 on
    the files they take, through both packages."""
    from kbmod_tpu_torch.standardizers import KBMODV0_5, MultiExtensionFits

    rubin = write_scattered_mask_fits(str(tmp_path / "rubin.fits"), seed=1)
    single = str(tmp_path / "single.fits")
    hdu = fits_io.ImageHDU(np.random.default_rng(2).normal(0, 1, (16, 20)).astype(np.float32), name="PRIMARY")
    hdu.header.update(make_fake_wcs(10.0, 5.0, 16, 20, 0.001).to_header())
    hdu.header.update({"MJD-OBS": 57000.25, "EXPTIME": 30.0, "FILTER": "g"})
    fits_io.write_fits(single, [hdu])
    v05 = TestKBMODV05()._write_v05(str(tmp_path / "legacy.fits"), seed=5)
    for path, t_cls, j_cls in ((rubin, MultiExtensionFits, jstd.MultiExtensionFits),
                               (single, SingleExtensionFits, jstd.SingleExtensionFits),
                               (v05, KBMODV0_5, jstd.KBMODV0_5)):
        t, j = Standardizer.get(path, force=t_cls), jstd.Standardizer.get(path, force=j_cls)
        _assert_same_meta(t.standardizeMetadata(), j.standardizeMetadata())
        _assert_same_layers(t.toLayeredImage(), j.toLayeredImage())
    assert isinstance(Standardizer.get(single), SingleExtensionFits)


def test_registries_stay_apart(tmp_path):
    """With both packages imported, each Standardizer.get resolves (and each
    registry holds) only its own package's classes."""
    path = write_rubin_style_fits(str(tmp_path / "img.fits"))
    t, j = Standardizer.get(path), jstd.Standardizer.get(path)
    assert type(t) is KBMODV1 and type(j) is jstd.KBMODV1
    assert type(Standardizer.get(path, force="KBMODV1")) is KBMODV1
    assert type(jstd.Standardizer.get(path, force="KBMODV1")) is jstd.KBMODV1
    assert Standardizer.registry is not jstd.Standardizer.registry
    assert all(c.__module__.startswith("kbmod_tpu_torch.") for c in Standardizer.registry.values())
    assert not any(c.__module__.startswith("kbmod_tpu_torch.") for c in jstd.Standardizer.registry.values())


def _assert_same_tables(a, b):
    assert list(a.colnames) == list(b.colnames) and len(a) == len(b)
    for col in a.colnames:
        x, y = np.asarray(a[col]), np.asarray(b[col])
        if x.dtype == object or y.dtype == object:
            assert [str(v) for v in x] == [str(v) for v in y], col
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"), col
    assert a.meta == b.meta


def _both_collections(tmp_path, n=4):
    paths = [write_scattered_mask_fits(str(tmp_path / f"img_{i}.fits"), seed=i, mjd=57130.0 + 0.05 * (n - i))
             for i in range(n)]
    return ImageCollection.fromTargets(paths), JImageCollection.fromTargets(paths)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("suffix", [".ecsv", ".parquet"])
def test_collection_files_cross_read(tmp_path, writer, suffix):
    """A collection file written by either package reads back in the other
    with an equal table; the two packages build equal tables."""
    t_ic, j_ic = _both_collections(tmp_path)
    _assert_same_tables(t_ic.data, j_ic.data)
    path = str(tmp_path / f"collection{suffix}")
    (t_ic if writer == "port" else j_ic).write(path)
    reader = JImageCollection if writer == "port" else ImageCollection
    back = reader.read(path)
    own = (ImageCollection if writer == "port" else JImageCollection).read(path)
    _assert_same_tables(back.data, own.data)
    assert len(back) == len(t_ic)
    np.testing.assert_array_equal(np.asarray(back["mjd_mid"], float), np.asarray(t_ic["mjd_mid"], float))
    # The lazy standardizers of a read collection rebuild from its rows.
    assert type(back.get_standardizer(0)["std"]).__name__ == "KBMODV1"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_collection_bintable_cross_read(tmp_path, writer):
    """toBinTableHDU written to a FITS file by one package and read with
    fromBinTableHDU by the other."""
    t_ic, j_ic = _both_collections(tmp_path, 3)
    path = str(tmp_path / "ic.fits")
    if writer == "port":
        fits_io.write_fits(path, [fits_io.ImageHDU(name="PRIMARY"), t_ic.toBinTableHDU()])
        back, own = JImageCollection.fromBinTableHDU(j_fits_io.read_fits(path)["IMGCOLL"]), j_ic
    else:
        j_fits_io.write_fits(path, [j_fits_io.ImageHDU(name="PRIMARY"), j_ic.toBinTableHDU()])
        back, own = ImageCollection.fromBinTableHDU(fits_io.read_fits(path)["IMGCOLL"]), t_ic
    _assert_same_tables(back.data, own.data)


def test_collection_to_work_unit_both_packages(tmp_path):
    """toWorkUnit of the same files: equal layers (time-sorted), times,
    PSFs, per-image WCS and image metadata; toImageStack too."""
    t_ic, j_ic = _both_collections(tmp_path)
    t_wu, j_wu = t_ic.toWorkUnit(), j_ic.toWorkUnit()
    np.testing.assert_array_equal(t_wu.im_stack.times, j_wu.im_stack.times)
    assert list(t_wu.im_stack.times) == sorted(t_wu.im_stack.times)
    for i in range(len(t_ic)):
        for plane in ("sci", "var"):
            assert np.array_equal(getattr(t_wu.im_stack, plane)[i], getattr(j_wu.im_stack, plane)[i], equal_nan=True)
        np.testing.assert_array_equal(t_wu.im_stack.psfs[i], j_wu.im_stack.psfs[i])
        assert serialize_wcs(t_wu.get_wcs(i)) == j_serialize_wcs(j_wu.get_wcs(i))
    np.testing.assert_array_equal(t_wu.get_all_obstimes(), j_wu.get_all_obstimes())
    for col in ("visit", "filter", "data_loc"):
        assert [str(v) for v in t_wu.org_img_meta[col]] == [str(v) for v in j_wu.org_img_meta[col]]
    t_st, j_st = t_ic.toImageStack(), j_ic.toImageStack()
    for i in range(len(t_ic)):
        assert np.array_equal(t_st.sci[i], j_st.sci[i], equal_nan=True)


def test_pack_tables_both_packages(tmp_path):
    """pack/unpack and pack_table/unpack_table move the same columns into
    the same metadata in both packages, and back."""
    from kbmod_tpu.image_collection import pack_table as j_pack, unpack_table as j_unpack
    from kbmod_tpu_torch.image_collection import pack_table, unpack_table

    t_ic, j_ic = _both_collections(tmp_path, 3)
    t_ic.pack()
    j_ic.pack()
    _assert_same_tables(t_ic.data, j_ic.data)
    t_ic.unpack()
    j_ic.unpack()
    _assert_same_tables(t_ic.data, j_ic.data)
    t_tab, j_tab = pack_table(t_ic.data.copy()), j_pack(j_ic.data.copy())
    assert t_tab.meta["shared_cols"] == j_tab.meta["shared_cols"] and "FILTER" in t_tab.meta["shared_cols"]
    _assert_same_tables(t_tab, j_tab)
    _assert_same_tables(unpack_table(t_tab), j_unpack(j_tab))


def test_vstack_shifts_others_in_place(tmp_path):
    """vstack shifts the other collections' std_idx in place, as the JAX
    package's does, and keeps every standardizer reachable."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    t1, j1 = _both_collections(tmp_path / "a", 2)
    t2, j2 = _both_collections(tmp_path / "b", 3)
    t1.vstack([t2])
    j1.vstack([j2])
    assert list(np.asarray(t2.data["std_idx"])) == list(np.asarray(j2.data["std_idx"])) == [2, 3, 4]
    _assert_same_tables(t1.data, j1.data)
    assert t1.get_standardizer(4)["std"] is t2._standardizers[2]
