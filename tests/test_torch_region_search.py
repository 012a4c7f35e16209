"""The port's RegionSearch and its two command-line tools against the JAX
package's, on the CPU.

The cases of tests/test_region_search.py run again against
kbmod_tpu_torch.region_search; then both packages on the same collection:
patches, chip-to-patch matches, ephemeris hits and exported collections;
``TestRegionSearcherCli::test_full_flow`` of tests/test_cmdline.py against
the port's region_searcher, and ``kbmod_build_ic`` through ``runpy`` (as
``python -m`` runs it).

Tolerances: none. Patch centres and sizes, overlap areas, matches and
exported tables are equal: the polygon clipping is the same float64 host
code in both packages.
"""

import numpy as np
import pytest

from kbmod_tpu_torch.region_search import Patch, Ephems, RegionSearch, patch_arcmin_to_pixels, polygon_area, clip_polygon
from kbmod_tpu_torch.table import Table


class TestPolygonMath:
    def test_area(self):
        square = [(0, 0), (2, 0), (2, 2), (0, 2)]
        assert np.isclose(abs(polygon_area(square)), 4.0)

    def test_clip_inside(self):
        square = [(0.5, 0.5), (1.5, 0.5), (1.5, 1.5), (0.5, 1.5)]
        clipped = clip_polygon(square, (0, 0, 2, 2))
        assert np.isclose(abs(polygon_area(clipped)), 1.0)

    def test_clip_partial(self):
        square = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
        clipped = clip_polygon(square, (0, 0, 2, 2))
        assert np.isclose(abs(polygon_area(clipped)), 1.0)

    def test_clip_outside(self):
        square = [(5, 5), (6, 5), (6, 6), (5, 6)]
        assert clip_polygon(square, (0, 0, 2, 2)) == []


class TestPatch:
    def test_basics(self):
        patch = Patch(100.0, -5.0, 0.5, 0.5, 0.25, patch_id=3)
        assert patch.contains(100.1, -5.1)
        assert not patch.contains(101.0, -5.0)
        assert patch.width_px == int(np.ceil(0.5 * 3600 / 0.25))
        wcs = patch.to_wcs()
        ra, dec = wcs.pixel_to_world_values(patch.width_px / 2 - 0.5, patch.height_px / 2 - 0.5)
        assert np.isclose(ra, 100.0, atol=1e-6)
        assert np.isclose(dec, -5.0, atol=1e-6)

    def test_overlap(self):
        patch = Patch(100.0, -5.0, 1.0, 1.0, 0.25)
        chip = [(99.9, -5.1), (100.1, -5.1), (100.1, -4.9), (99.9, -4.9)]
        overlap = patch.measure_overlap(np.array(chip))
        assert np.isclose(overlap, 0.04, atol=1e-6)
        assert patch.overlaps_polygon(np.array(chip))
        far_chip = [(150.0, 0.0), (150.1, 0.0), (150.1, 0.1), (150.0, 0.1)]
        assert not patch.overlaps_polygon(np.array(far_chip))

    def test_arcmin_to_pixels(self):
        assert patch_arcmin_to_pixels(1.0, 0.25) == 240


class _FakeIC:
    """A minimal ImageCollection stand-in for RegionSearch tests."""

    def __init__(self, table):
        self.data = table

    @property
    def columns(self):
        return self.data.colnames

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.data[key]
        sub = _FakeIC(self.data[key])
        return sub

    def reflex_correct(self, dist, earth_loc=None):
        from kbmod_tpu_torch.reprojection_utils import correct_parallax_geometrically_vectorized

        corrected, _ = correct_parallax_geometrically_vectorized(
            np.asarray(self.data["ra"], dtype=float),
            np.asarray(self.data["dec"], dtype=float),
            np.asarray(self.data["mjd_mid"], dtype=float),
            dist,
        )
        self.data[f"ra_{dist}"] = corrected.ra_deg
        self.data[f"dec_{dist}"] = corrected.dec_deg

    def filter_by_time_range(self, start_mjd=None, end_mjd=None):
        t = np.asarray(self.data["mjd_mid"], dtype=float)
        keep = np.ones(len(t), dtype=bool)
        if start_mjd is not None:
            keep &= t >= start_mjd
        if end_mjd is not None:
            keep &= t <= end_mjd
        self.data = self.data[keep]

    def reset_lazy_loading_indices(self):
        pass

    def copy(self):
        return _FakeIC(self.data.copy())


def make_fake_ic(n=10, seed=5):
    rng = np.random.default_rng(seed)
    ra = 100.0 + rng.uniform(-0.8, 0.8, n)
    dec = -5.0 + rng.uniform(-0.8, 0.8, n)
    half = 0.05  # chip half-size (deg)
    data = {
        "ra": ra,
        "dec": dec,
        "mjd_mid": 57130.0 + rng.uniform(0, 1, n),
        "ra_tl": ra - half, "dec_tl": dec - half,
        "ra_tr": ra + half, "dec_tr": dec - half,
        "ra_br": ra + half, "dec_br": dec + half,
        "ra_bl": ra - half, "dec_bl": dec + half,
    }
    return _FakeIC(Table(data))


class TestRegionSearch:
    def test_generate_patches(self):
        rs = RegionSearch(make_fake_ic())
        patches = rs.generate_patches(
            30.0, pixel_scale=0.26, ra_range=(99.0, 101.0), dec_range=(-6.0, -4.0)
        )
        assert len(patches) == 16  # 4x4 grid of 0.5 deg patches
        assert all(p.width == 0.5 for p in patches)

    def test_match_chips_to_patches(self):
        ic = make_fake_ic()
        rs = RegionSearch(ic)
        rs.generate_patches(30.0, pixel_scale=0.26, ra_range=(99.0, 101.0), dec_range=(-6.0, -4.0))
        matches = rs.match_ic_to_patches()
        # Every chip lands in at least one patch.
        covered = set()
        for rows in matches.values():
            covered.update(rows)
        assert covered == set(range(len(ic)))

    def test_get_image_collection_from_patch(self):
        ic = make_fake_ic()
        rs = RegionSearch(ic)
        rs.generate_patches(30.0, pixel_scale=0.26, ra_range=(99.0, 101.0), dec_range=(-6.0, -4.0))
        matches = rs.match_ic_to_patches()
        patch_id = max(matches, key=lambda k: len(matches[k]))
        sub = rs.get_image_collection_from_patch(patch_id)
        assert len(sub) == len(matches[patch_id])

    def test_search_patches_by_ephems(self):
        ic = make_fake_ic()
        rs = RegionSearch(ic)
        rs.generate_patches(30.0, pixel_scale=0.26, ra_range=(99.0, 101.0), dec_range=(-6.0, -4.0))
        eph_table = Table({"ra": [100.1], "dec": [-5.1], "mjd": [57130.5]})
        ephems = Ephems(eph_table, "ra", "dec", "mjd")
        found = rs.search_patches_by_ephems(ephems)
        assert len(found) >= 1
        for pid in found:
            assert rs.get_patch(pid).contains(100.1, -5.1)

    def test_ephems_reflex_correction(self):
        eph_table = Table({"ra": [100.0, 101.0], "dec": [-5.0, -5.5], "mjd": [57130.5, 57131.0]})
        ephems = Ephems(eph_table, "ra", "dec", "mjd", guess_dists=[40.0])
        ras = ephems.get_ras(40.0)
        assert not np.allclose(ras, ephems.get_ras(None))


# ----------------------------------------------------------------------
# Parity with the JAX package on real collections, and the tools
# ----------------------------------------------------------------------

import csv  # noqa: E402
import os  # noqa: E402
import runpy  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

from kbmod_tpu.image_collection import ImageCollection as JImageCollection  # noqa: E402
from kbmod_tpu.region_search import Ephems as JEphems, RegionSearch as JRegionSearch  # noqa: E402
from kbmod_tpu.table import Table as JTable  # noqa: E402

from kbmod_tpu_torch.image_collection import ImageCollection  # noqa: E402
from test_torch_standardizers import _assert_same_tables, write_rubin_style_fits  # noqa: E402


def _sky_collections(tmp_path):
    """Two clusters of chips on the sky (ra 200 and 210), as the JAX
    package's command-line test makes them, read by both packages."""
    paths = [write_rubin_style_fits(str(tmp_path / f"a{i}.fits"), seed=i, mjd=57130.0 + 0.05 * i,
                                    ra=200.0 + 0.002 * i, dec=-7.0) for i in range(3)]
    paths += [write_rubin_style_fits(str(tmp_path / f"b{i}.fits"), seed=10 + i, mjd=57131.0 + 0.05 * i,
                                     ra=210.0, dec=-7.0 + 0.002 * i) for i in range(2)]
    return ImageCollection.fromTargets(paths), JImageCollection.fromTargets(paths)


@pytest.mark.parametrize("guess_dist", [None, 40.0])
def test_region_search_matches_jax_package(tmp_path, guess_dist):
    t_ic, j_ic = _sky_collections(tmp_path)
    dists = [] if guess_dist is None else [guess_dist]
    t_rs, j_rs = RegionSearch(t_ic, guess_dists=dists), JRegionSearch(j_ic, guess_dists=dists)
    _assert_same_tables(t_rs.ic.data, j_rs.ic.data)
    kw = dict(pixel_scale=0.26, ra_range=(199.9, 210.1), dec_range=(-7.1, -6.9), overlap_percentage=20.0)
    t_p, j_p = t_rs.generate_patches(3.0, **kw), j_rs.generate_patches(3.0, **kw)
    assert [(p.id, p.ra, p.dec, p.width, p.width_px, p.ra_dim, p.dec_dim) for p in t_p] == [
        (p.id, p.ra, p.dec, p.width, p.width_px, p.ra_dim, p.dec_dim) for p in j_p]
    t_m, j_m = t_rs.match_ic_to_patches(guess_dist=guess_dist), j_rs.match_ic_to_patches(guess_dist=guess_dist)
    assert t_m == j_m and len(t_m) >= 2
    eph = {"ra": [200.001, 210.0], "dec": [-7.0, -6.999], "mjd": [57130.02, 57131.02]}
    t_e = Ephems(Table(dict(eph)), "ra", "dec", "mjd", guess_dists=dists)
    j_e = JEphems(JTable(dict(eph)), "ra", "dec", "mjd", guess_dists=dists)
    np.testing.assert_array_equal(t_e.get_ras(guess_dist), j_e.get_ras(guess_dist))
    found = t_rs.search_patches_by_ephems(t_e, guess_dist)
    assert found == j_rs.search_patches_by_ephems(j_e, guess_dist)
    for pid in sorted(t_m):
        t_sub = t_rs.get_image_collection_from_patch(pid, guess_dist=guess_dist or 0.0)
        j_sub = j_rs.get_image_collection_from_patch(pid, guess_dist=guess_dist or 0.0)
        _assert_same_tables(t_sub.data, j_sub.data)
        t_out = t_rs.export_image_collection(t_sub, guess_dist=guess_dist, patch=pid)
        j_out = j_rs.export_image_collection(j_sub, guess_dist=guess_dist, patch=pid)
        _assert_same_tables(t_out.data, j_out.data)
        wcs_t, wcs_j = t_rs.get_patch(pid).to_wcs(), j_rs.get_patch(pid).to_wcs()
        np.testing.assert_array_equal(wcs_t.crpix, wcs_j.crpix)
        np.testing.assert_array_equal(wcs_t.cd, wcs_j.cd)
        # The sub-collection still standardizes (its lazy indices reset).
        assert t_sub.toWorkUnit().im_stack.num_times == len(t_sub)


def run_main(module, argv):
    with mock.patch.object(sys, "argv", ["prog"] + argv):
        module.main()


class TestRegionSearcherCli:
    """tests/test_cmdline.py's region-searcher flow against the port's tool:
    patch sweep, per-patch collection export with recycling, error CSV,
    and the per-patch analysis table; the exports equal the JAX tool's."""

    def test_full_flow(self, tmp_path, capsys):
        from kbmod_tpu.cmdline import region_searcher as j_tool
        from kbmod_tpu_torch.cmdline import region_searcher as rs_tool

        ic, _ = _sky_collections(tmp_path)
        ic_path = str(tmp_path / "base.collection")
        ic.write(ic_path)

        out_dir = str(tmp_path / "out")
        argv = [
            "--ic-path", ic_path, "--guess-distances", "0.0",
            "--patch-side-len", "120", "--pixel-scale", "0.26",
            "--bands-to-drop", "u", "--max-wcs-err", "60.0",
            "--out-dir", out_dir,
        ]
        run_main(rs_tool, argv)
        out = capsys.readouterr().out
        assert "Finished!" in out

        tag_dir = os.path.join(out_dir, "0.0_120X120")
        collections = sorted(f for f in os.listdir(tag_dir) if f.endswith(".collection"))
        assert len(collections) >= 2
        with open(os.path.join(tag_dir, "overlap_0.0_120X120.csv")) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["patch_id", "overlap_deg2", "visit_count", "unique_mjds", "obs_nights_spanned"]
        overlaps = [float(r[1]) for r in rows[1:]]
        assert overlaps == sorted(overlaps, reverse=True)
        assert os.path.exists(os.path.join(tag_dir, "errors.csv"))

        sub = ImageCollection.read(os.path.join(tag_dir, collections[0]))
        assert "overlap_deg" in sub.columns
        assert "patch_id" in sub.data.meta

        run_main(rs_tool, argv)
        assert "Recycled" in capsys.readouterr().out

        # The JAX package's tool on the same collection writes the same files.
        j_dir = str(tmp_path / "jax_out")
        run_main(j_tool, argv[:-1] + [j_dir])
        j_tag = os.path.join(j_dir, "0.0_120X120")
        assert sorted(f for f in os.listdir(j_tag) if f.endswith(".collection")) == collections
        for name in collections + ["overlap_0.0_120X120.csv"]:
            with open(os.path.join(tag_dir, name)) as a, open(os.path.join(j_tag, name)) as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("how", ["dir", "files"])
def test_kbmod_build_ic_runpy(tmp_path, capsys, how):
    """``python -m kbmod_tpu_torch.cmdline.kbmod_build_ic`` (through runpy)
    writes the collection that fromDir builds, equal to the JAX package's
    tool's file."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    paths = [write_rubin_style_fits(str(img_dir / f"x{i}.fits"), seed=i, mjd=57130.0 + 0.1 * i) for i in range(3)]
    source = ["--dir", str(img_dir)] if how == "dir" else ["--files", *paths]
    out = str(tmp_path / "ic.ecsv")
    with mock.patch.object(sys, "argv", ["kbmod_build_ic", *source, "--outfile", out]):
        runpy.run_module("kbmod_tpu_torch.cmdline.kbmod_build_ic", run_name="__main__")
    assert "Wrote collection of 3 images" in capsys.readouterr().out
    back = ImageCollection.read(out)
    built = ImageCollection.fromDir(str(img_dir))
    _assert_same_tables(back.data, ImageCollection.read(_written(built, tmp_path)).data)
    from kbmod_tpu.cmdline import kbmod_build_ic as j_tool

    j_out = str(tmp_path / "j_ic.ecsv")
    run_main(j_tool, [*source, "--outfile", j_out])
    with open(out) as a, open(j_out) as b:
        assert a.read() == b.read()


def _written(ic, tmp_path):
    path = str(tmp_path / "in_process.ecsv")
    ic.write(path)
    return path
