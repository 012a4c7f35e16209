"""The port's command-line tools against the JAX package's, on the CPU.

Each tool runs as ``python -m kbmod_tpu_torch.cmdline.<tool>`` does,
through ``runpy``, with ``--device cpu`` where its work reaches the card.
First every case of tests/test_cmdline.py's ``TestCmdline``,
``TestMigrateResultsBatch`` and ``TestResultMatcherBatch`` is re-run
against the port. Then each tool that writes a file is held to the JAX
tool on the same input, column by column:

- exact for every tool but ``kbmod_filter --workunit``: they copy, drop,
  reshape, sort or cluster the same values, and ``kbmod_stamps``' coadds
  (sum, mean, median) take the same float32 steps in the same order;
- ``kbmod_filter --workunit`` rebuilds the psi/phi curves with the port's
  K1 (its plain twin here), which rounds a value up to a few float32 ulps
  away from the JAX package's XLA convolution: the curves within 4 ulps,
  the re-scored likelihood and flux within the bound that 4 ulps a sample
  give each row's sums; the kept rows, their order and their obs_valid
  exact.
"""

import csv
import importlib
import os
import runpy
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from kbmod_tpu_torch.fake_data.fake_result_creator import make_fake_results
from kbmod_tpu_torch.results import Results

U = 2.0**-24


def run_main(name, argv):
    """``python -m kbmod_tpu_torch.cmdline.<name> argv``, in this process."""
    with mock.patch.object(sys, "argv", [name] + list(argv)):
        runpy.run_module(f"kbmod_tpu_torch.cmdline.{name}", run_name="__main__", alter_sys=False)


def run_jax(name, argv):
    """The JAX package's tool of the same name on the same arguments."""
    module = importlib.import_module(f"kbmod_tpu.cmdline.{name}")
    with mock.patch.object(sys, "argv", ["prog"] + list(argv)):
        module.main()


def _column(table, col):
    return np.asarray(table[col])


def assert_tables_equal(got_path, ref_path, skip=()):
    """Both files read back (by the port's reader) with the same columns,
    metadata times and rows, every column exactly (NaN where NaN)."""
    got, ref = Results.read_table(str(got_path)), Results.read_table(str(ref_path))
    assert got.colnames == ref.colnames
    assert len(got) == len(ref)
    if ref.mjd_mid is not None:
        np.testing.assert_array_equal(got.mjd_mid, ref.mjd_mid)
    for col in ref.colnames:
        if col in skip:
            continue
        a, b = _column(got, col), _column(ref, col)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=col)
        else:
            assert a.tolist() == b.tolist(), col
    return got, ref


class TestCmdline:
    def test_version(self, capsys):
        run_main("kbmod_version", [])
        assert "kbmod_tpu_torch" in capsys.readouterr().out
        run_main("kbmod_version", ["--full"])
        out = capsys.readouterr().out
        for word in ("kbmod_tpu_torch 0.1.0", f"torch {torch.__version__}", f"numpy {np.__version__}",
                     "cuda ", "devices: "):
            assert word in out
        assert "jax" not in out

    def test_create_test_data_and_search(self, capsys, tmp_path):
        from kbmod_tpu_torch.configuration import SearchConfiguration

        wu_path = str(tmp_path / "wu.fits")
        args = ["--num_times=6", "--width=64", "--height=64", "--num_objects=1", "--flux=500", "--seed=42"]
        run_main("kbmod_create_test_data", [f"--outfile={wu_path}"] + args)
        assert os.path.exists(wu_path)
        # The JAX tool's file on the same arguments: the same bytes.
        ref_path = str(tmp_path / "wu_jax.fits")
        run_jax("kbmod_create_test_data", [f"--outfile={ref_path}"] + args)
        with open(wu_path, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()

        out_path = str(tmp_path / "results.ecsv")
        config_path = str(tmp_path / "config.yaml")
        config = SearchConfiguration.from_dict(
            {
                "generator_config": {
                    "name": "EclipticCenteredSearch",
                    "velocities": [0.0, 60.0, 9],
                    "angles": [-3.2, 3.2, 9],
                    "angle_units": "radian",
                    "given_ecliptic": 0.0,
                },
                "num_obs": 4,
                "lh_level": 8.0,
                "compute_ra_dec": False,
            }
        )
        config.to_file(config_path)
        run_main("kbmod_search", [f"--workunit={wu_path}", f"--outfile={out_path}", f"--config={config_path}",
                                  "--device", "cpu"])
        assert os.path.exists(out_path)

    def test_stats_filter_strip_merge_migrate(self, capsys, tmp_path):
        rng = np.random.default_rng(3)
        r1 = make_fake_results(6, 200, 200, 8, rng=rng)
        r2 = make_fake_results(6, 200, 200, 5, rng=rng)
        p1 = str(tmp_path / "r1.ecsv")
        p2 = str(tmp_path / "r2.ecsv")
        r1.write_table(p1)
        r2.write_table(p2)

        run_main("kbmod_stats", [f"--input={p1}"])
        assert "Rows: 8" in capsys.readouterr().out

        filt = str(tmp_path / "filtered.ecsv")
        run_main("kbmod_filter", [f"--input={p1}", f"--outfile={filt}", "--lh_level=30.0"])
        out = Results.read_table(filt)
        assert np.all(np.asarray(out["likelihood"]) >= 30.0)

        merged = str(tmp_path / "merged.ecsv")
        run_main("kbmod_merge_results", [p1, p2, f"--outfile={merged}", "--dup_thresh=1"])
        assert len(Results.read_table(merged)) <= 13

        stripped = str(tmp_path / "stripped.ecsv")
        run_main("kbmod_strip_results", [f"--input={p1}", f"--outfile={stripped}", "--cols=psi_curve,phi_curve"])
        out = Results.read_table(stripped)
        assert "psi_curve" not in out.colnames

        mig = str(tmp_path / "migrated.parquet")
        run_main("kbmod_migrate_results", [f"--input={p1}", f"--outfile={mig}"])
        assert len(Results.read_table(mig)) == 8


class TestMigrateResultsBatch:
    """The full reference migrate flow (kbmod_migrate_results.py:73-429):
    directory batch, image-column reshape, aux-file split, validation,
    atomic replace, audit CSVs, dry-run and skip logic."""

    def _legacy_file(self, tmp, name, n=6, dim=5):
        rng = np.random.default_rng(sum(map(ord, name)))
        res = make_fake_results(4, 100, 100, n, rng=rng)
        # A legacy flattened stamp column: (N, dim*dim).
        res.table["coadd_mean"] = rng.normal(0, 1, (n, dim * dim)).astype(np.float32)
        path = os.path.join(tmp, name)
        res.write_table(path)
        return path

    def test_directory_batch_migration(self, capsys, tmp_path):
        tmp = str(tmp_path)
        p1 = self._legacy_file(tmp, "a.search.parquet")
        p2 = self._legacy_file(tmp, "b.search.parquet", n=4)
        self._legacy_file(tmp, "unrelated.parquet")  # not matched by glob
        out_dir = os.path.join(tmp, "staging")
        run_main("kbmod_migrate_results", [
            f"--input={tmp}", "--image-columns", "*coadd*",
            "--stamp-dim=5", f"--output-dir={out_dir}",
        ])
        out = capsys.readouterr().out
        assert "Migrated 2 file(s)" in out

        # Originals replaced: main files lost the coadd column, aux side
        # files hold it reshaped, metadata records the shape.
        for p, n in ((p1, 6), (p2, 4)):
            main = Results.read_table(p)
            assert "coadd_mean" not in main.colnames
            assert len(main) == n
            aux = p.replace(".search.parquet", ".search_coadd_mean.parquet")
            assert os.path.exists(aux)
        # Audit CSV has one row per migrated file.
        with open(os.path.join(out_dir, "migration_mapping.csv")) as f:
            rows = list(csv.reader(f))
        assert len(rows) == 3  # header + 2
        assert all(r[-1] == "migrated" for r in rows[1:])

    def test_reshape_and_reload_roundtrip(self, tmp_path):
        p = self._legacy_file(str(tmp_path), "c.search.parquet", n=3, dim=7)
        flat = np.asarray(Results.read_table(p).table["coadd_mean"])
        run_main("kbmod_migrate_results", [f"--input={p}", "--image-columns", "*coadd*", "--stamp-dim=7"])
        aux = p.replace(".search.parquet", ".search_coadd_mean.parquet")
        main = Results.read_table(p)
        main.load_column(aux, "coadd_mean")
        got = np.asarray(main.table["coadd_mean"])
        assert got.shape == (3, 7, 7)
        np.testing.assert_allclose(got.reshape(3, 49), flat)

    def test_dry_run_and_skip_with_aux(self, capsys, tmp_path):
        p = self._legacy_file(str(tmp_path), "d.search.parquet")
        with open(p, "rb") as f:
            before = f.read()
        run_main("kbmod_migrate_results", [f"--input={p}", "--image-columns", "*coadd*", "--stamp-dim=5",
                                           "--dry-run"])
        assert "Would migrate 1" in capsys.readouterr().out
        with open(p, "rb") as f:
            assert f.read() == before  # untouched

        # Real migration, then a second run skips (aux files exist).
        run_main("kbmod_migrate_results", [f"--input={p}", "--image-columns", "*coadd*", "--stamp-dim=5"])
        capsys.readouterr()
        run_main("kbmod_migrate_results", [f"--input={p}", "--image-columns", "*coadd*", "--stamp-dim=5"])
        assert "skipped 1" in capsys.readouterr().out

    def test_bad_stamp_dim_fails_cleanly(self, capsys, tmp_path):
        p = self._legacy_file(str(tmp_path), "e.search.parquet", dim=5)
        with open(p, "rb") as f:
            before = f.read()
        run_main("kbmod_migrate_results", [f"--input={p}", "--image-columns", "*coadd*", "--stamp-dim=9"])
        out = capsys.readouterr().out
        assert "failed 1" in out
        with open(p, "rb") as f:
            assert f.read() == before  # original intact


def _ephem_on_row0(res, wcs, table_cls):
    """An ephemeris that follows row 0's trajectory exactly."""
    times = np.asarray(res.mjd_mid)
    t0 = times - times[0]
    xs = np.asarray(res.table["x"])[0] + np.asarray(res.table["vx"])[0] * t0
    ys = np.asarray(res.table["y"])[0] + np.asarray(res.table["vy"])[0] * t0
    ra, dec = wcs.pixel_to_world_values(xs, ys)
    return table_cls({"Name": np.array(["obj0"] * len(times), dtype=object), "RA": ra, "Dec": dec,
                      "mjd_mid": times})


class TestResultMatcherBatch:
    """The reference result-matcher flow (kbmod_result_matcher.py): glob
    batch, reflex-corrected ephemeris cache, CSV manifest with
    matched_obs/obs_ratio, exceptions CSV."""

    def _results_file(self, tmp, name, wcs, n=5, num_times=6):
        res = make_fake_results(num_times, 64, 64, n, rng=np.random.default_rng(11))
        res.wcs = wcs
        path = os.path.join(tmp, name)
        res.write_table(path)
        return path, res

    def test_glob_batch_manifest(self, capsys, tmp_path):
        from kbmod_tpu_torch.io import table_io
        from kbmod_tpu_torch.table import Table
        from kbmod_tpu_torch.wcs_utils import make_fake_wcs

        tmp = str(tmp_path)
        wcs = make_fake_wcs(25.0, -10.0, 64, 64, deg_per_pixel=0.01)
        p1, res = self._results_file(tmp, "a.results.parquet", wcs)
        self._results_file(tmp, "b.results.parquet", wcs)
        eph_path = os.path.join(tmp, "ephem.ecsv")
        table_io.write_table(_ephem_on_row0(res, wcs, Table), eph_path)

        argv = ["--results_glob", os.path.join(tmp, "*.results.parquet"), "--ephem", eph_path,
                "--sep_thresh", "5.0", "--time_thresh_s", "600", "--min_obs", "2"]
        out_dir = os.path.join(tmp, "out")
        run_main("kbmod_result_matcher", argv + ["--output", out_dir])
        out = capsys.readouterr().out
        assert "match rows for 2 file(s)" in out

        with open(os.path.join(out_dir, "matching_results.csv")) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) >= 1
        assert any(r["name"] == "obj0" and r["results_file"] == p1 for r in rows)
        r0 = [r for r in rows if r["results_file"] == p1][0]
        assert int(r0["matched_obs"]) >= 2
        assert 0 < float(r0["obs_ratio"]) <= 1.0
        # The zero-distance ephemeris cache was written.
        assert os.path.exists(os.path.join(out_dir, "ephem_0.0.parquet"))
        assert not os.path.exists(os.path.join(out_dir, "exceptions.csv"))

        # The JAX tool on the same files: the same manifest and cache.
        ref_dir = os.path.join(tmp, "out_jax")
        run_jax("kbmod_result_matcher", argv + ["--output", ref_dir])
        with open(os.path.join(ref_dir, "matching_results.csv")) as f:
            assert list(csv.DictReader(f)) == rows
        from kbmod_tpu_torch.io.table_io import read_table

        got, ref = (read_table(os.path.join(d, "ephem_0.0.parquet")) for d in (out_dir, ref_dir))
        assert got.colnames == ref.colnames
        for col in ref.colnames:
            assert np.asarray(got[col]).tolist() == np.asarray(ref[col]).tolist(), col

    def test_exceptions_csv_for_bad_file(self, capsys, tmp_path):
        from kbmod_tpu_torch.io import table_io
        from kbmod_tpu_torch.table import Table

        tmp = str(tmp_path)
        bad = os.path.join(tmp, "broken.results.parquet")
        with open(bad, "w") as f:
            f.write("not a parquet file")
        ephem = Table({
            "Name": np.array(["x"], dtype=object),
            "RA": np.array([10.0]), "Dec": np.array([5.0]),
            "mjd_mid": np.array([57130.0]),
        })
        eph_path = os.path.join(tmp, "ephem.ecsv")
        table_io.write_table(ephem, eph_path)
        out_dir = os.path.join(tmp, "out")
        run_main("kbmod_result_matcher", ["--results", bad, "--ephem", eph_path, "--output", out_dir])
        assert os.path.exists(os.path.join(out_dir, "exceptions.csv"))

    def test_reflex_corrected_cache(self):
        from kbmod_tpu.cmdline.kbmod_result_matcher import reflex_correct_ephem_table as j_reflex
        from kbmod_tpu.table import Table as JTable
        from kbmod_tpu_torch.cmdline.kbmod_result_matcher import reflex_correct_ephem_table
        from kbmod_tpu_torch.table import Table

        cols = {
            "Name": np.array(["o"] * 3, dtype=object),
            "RA": np.array([150.0, 150.1, 150.2]),
            "Dec": np.array([-5.0, -5.0, -5.0]),
            "mjd_mid": np.array([60000.0, 60000.3, 60000.6]),
        }
        out = reflex_correct_ephem_table(Table(dict(cols)), 30.0)
        assert "ra_30.0" in out.colnames
        # Reflex correction at 30 AU moves positions measurably (arcsec+)
        # but far less than a degree.
        d = np.abs(np.asarray(out["ra_30.0"]) - np.asarray(out["RA"]))
        assert np.all(d > 1e-5) and np.all(d < 0.5)
        ref = j_reflex(JTable(dict(cols)), 30.0)
        for col in ("ra_30.0", "dec_30.0"):
            np.testing.assert_array_equal(np.asarray(out[col]), np.asarray(ref[col]))


# ----------------------------------------------------------------------
# Each tool's file against the JAX tool's on the same input
# ----------------------------------------------------------------------

@pytest.fixture
def fake_files(tmp_path):
    """Two results files from the JAX package's fake creator (seeded)."""
    from kbmod_tpu.fake_data.fake_result_creator import add_fake_coadds_to_results as j_coadds
    from kbmod_tpu.fake_data.fake_result_creator import make_fake_results as j_make

    rng = np.random.default_rng(7)
    paths = []
    for i, n in enumerate((12, 9)):
        res = j_make(8, 120, 100, n, rng=rng)
        j_coadds(res, 3, ["mean"], rng=rng)
        path = str(tmp_path / f"in{i}.ecsv")
        res.write_table(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("argv", [
    ["--lh_level=30.0"],
    ["--num_obs=7"],
    ["--sigma_g_bnds=25,75"],
    ["--sigma_g_bnds=10,90", "--clip_negative", "--lh_level=5.0"],
    ["--cluster_type=all", "--cluster_eps=20"],
    ["--cluster_type=position", "--cluster_eps=10", "--num_obs=3"],
], ids=["lh", "num_obs", "sigma_g", "sigma_g_clip_negative", "cluster_all", "cluster_position"])
def test_filter_equals_jax(fake_files, tmp_path, argv):
    got, ref = str(tmp_path / "got.ecsv"), str(tmp_path / "ref.ecsv")
    run_main("kbmod_filter", [f"--input={fake_files[0]}", f"--outfile={got}", "--device", "cpu"] + argv)
    run_jax("kbmod_filter", [f"--input={fake_files[0]}", f"--outfile={ref}"] + argv)
    assert_tables_equal(got, ref)


@pytest.mark.parametrize("cols", ["psi_curve,phi_curve", "all_stamps,psi_curve,phi_curve,obs_valid,likelihood"])
def test_strip_equals_jax(fake_files, tmp_path, cols):
    got, ref = str(tmp_path / "got.ecsv"), str(tmp_path / "ref.ecsv")
    run_main("kbmod_strip_results", [f"--input={fake_files[0]}", f"--outfile={got}", f"--cols={cols}"])
    run_jax("kbmod_strip_results", [f"--input={fake_files[0]}", f"--outfile={ref}", f"--cols={cols}"])
    got_t, _ = assert_tables_equal(got, ref)
    assert "psi_curve" not in got_t.colnames and "likelihood" in got_t.colnames


@pytest.mark.parametrize("dup_thresh", [0, 1, 10])
def test_merge_equals_jax(fake_files, tmp_path, dup_thresh):
    got, ref = str(tmp_path / "got.ecsv"), str(tmp_path / "ref.ecsv")
    run_main("kbmod_merge_results", [*fake_files, f"--outfile={got}", f"--dup_thresh={dup_thresh}"])
    run_jax("kbmod_merge_results", [*fake_files, f"--outfile={ref}", f"--dup_thresh={dup_thresh}"])
    merged, _ = assert_tables_equal(got, ref)
    assert len(merged) <= 21


def test_stats_prints_as_jax(fake_files, capsys):
    run_main("kbmod_stats", [f"--input={fake_files[1]}"])
    got = capsys.readouterr().out
    run_jax("kbmod_stats", [f"--input={fake_files[1]}"])
    assert got == capsys.readouterr().out
    assert "Rows: 9" in got


def test_migrate_equals_jax(tmp_path, capsys):
    """The legacy converter and the batch flow on copies of the same legacy
    files: equal main and side files."""
    import shutil

    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    for name, n in (("a.search.parquet", 5), ("b.search.parquet", 3)):
        res = make_fake_results(4, 100, 100, n, rng=rng)
        res.table["coadd_sum"] = rng.normal(0, 1, (n, 25)).astype(np.float32)
        res.write_table(str(src / name))
    run_main("kbmod_migrate_results", [f"--input={src / 'a.search.parquet'}", f"--outfile={tmp_path / 'got.ecsv'}"])
    run_jax("kbmod_migrate_results", [f"--input={src / 'a.search.parquet'}", f"--outfile={tmp_path / 'ref.ecsv'}"])
    assert_tables_equal(tmp_path / "got.ecsv", tmp_path / "ref.ecsv")

    # The port's tool as ``python -m`` in a child with two forked workers
    # (a fork of this process, which runs JAX's threads, could deadlock);
    # the JAX tool here with one.
    dirs = {tag: tmp_path / tag for tag in ("got", "ref")}
    for tag in dirs:
        shutil.copytree(src, dirs[tag])
    argv = ["--image-columns", "*coadd*", "--stamp-dim=5"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run(
        [sys.executable, "-m", "kbmod_tpu_torch.cmdline.kbmod_migrate_results", f"--input={dirs['got']}", *argv,
         "--workers=2", f"--output-dir={tmp_path / 'got_staging'}"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert child.returncode == 0, child.stderr[-2000:]
    assert "Migrated 2 file(s)" in child.stdout
    run_jax("kbmod_migrate_results", [f"--input={dirs['ref']}", *argv, f"--output-dir={tmp_path / 'ref_staging'}"])
    assert "Migrated 2 file(s)" in capsys.readouterr().out
    from kbmod_tpu_torch.io.table_io import read_table

    for stem in ("a", "b"):
        assert_tables_equal(dirs["got"] / f"{stem}.search.parquet", dirs["ref"] / f"{stem}.search.parquet")
        got, ref = (read_table(str(d / f"{stem}.search_coadd_sum.parquet")) for d in (dirs["got"], dirs["ref"]))
        assert got.colnames == ref.colnames and "coadd_sum" in got.colnames
        for col in got.colnames:
            assert np.asarray(got[col]).tolist() == np.asarray(ref[col]).tolist(), col
        main = Results.read_table(str(dirs["got"] / f"{stem}.search.parquet"))
        main.load_column(str(dirs["got"] / f"{stem}.search_coadd_sum.parquet"), "coadd_sum")
        assert np.asarray(main.table["coadd_sum"]).shape == (len(main), 5, 5)


def test_results_rater_console_equals_jax(fake_files, tmp_path, monkeypatch, capsys):
    """The console rater with the same answers typed: the same ratings."""
    answers = ["y", "n", "s", "y", "x", "n", "q"]
    for tag, runner in (("got", run_main), ("ref", run_jax)):
        typed = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="": next(typed))
        runner("kbmod_results_rater", [f"--input={fake_files[0]}", f"--outfile={tmp_path / (tag + '.ecsv')}",
                                       "--start=1"])
    out = capsys.readouterr().out
    assert out.count("=== Result 1/12 ===") == 2
    got, _ = assert_tables_equal(tmp_path / "got.ecsv", tmp_path / "ref.ecsv")
    assert list(got["rating"][:7]) == ["", "real", "bogus", "", "real", "", "bogus"]
    from kbmod_tpu.cmdline import kbmod_results_rater as j_rater
    from kbmod_tpu_torch.cmdline import kbmod_results_rater as t_rater

    assert t_rater.ascii_stamp(np.arange(9.0).reshape(3, 3)) == j_rater.ascii_stamp(np.arange(9.0).reshape(3, 3))


def test_result_matcher_annotate_equals_jax(tmp_path):
    """Annotate mode (--input/--catalog/--workunit): the same match columns
    and the same rows removed."""
    from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
    from kbmod_tpu.fake_data.fake_data_creator import create_fake_times as j_times
    from kbmod_tpu.io import table_io as j_table_io
    from kbmod_tpu.table import Table as JTable
    from kbmod_tpu.wcs_utils import make_fake_wcs as j_wcs

    T = 6
    ds = JFakeDataSet(64, 64, j_times(T, t0=57130.0, obs_per_day=3), use_seed=3)
    wu = ds.get_work_unit()
    wu.wcs = j_wcs(25.0, -10.0, 64, 64, deg_per_pixel=0.01)
    wu_path = str(tmp_path / "wu.fits")
    wu.to_fits(wu_path)
    res = make_fake_results(T, 64, 64, 6, rng=np.random.default_rng(4))
    res.set_mjd_utc_mid(np.asarray(wu.get_all_obstimes()))
    res_path = str(tmp_path / "res.ecsv")
    res.write_table(res_path)
    cat = _ephem_on_row0(res, wu.wcs, JTable)
    cat["DEC"] = cat["Dec"]
    cat_path = str(tmp_path / "cat.ecsv")
    j_table_io.write_table(cat, cat_path)
    for extra in ([], ["--remove_matches"]):
        outs = {}
        for tag, runner in (("got", run_main), ("ref", run_jax)):
            outs[tag] = str(tmp_path / f"{tag}{len(extra)}.ecsv")
            runner("kbmod_result_matcher", ["--input", res_path, "--catalog", cat_path, "--workunit", wu_path,
                                            "--outfile", outs[tag], "--min_obs", "2", "--time_thresh_s", "600",
                                            *extra])
        got, _ = assert_tables_equal(outs["got"], outs["ref"])
        assert len(got) == (5 if extra else 6)


def _curve_bounds(psi, phi, valid, lh, flux):
    """|lh| and |flux| bounds from curves that differ by up to 4 float32
    ulps a sample: 4 u sum|psi| / sqrt(sum phi) + 4 u |lh| (flux: over
    sum phi, + 8 u |flux|), each sum over the row's valid samples."""
    psi, phi = np.where(valid, np.abs(psi.astype(np.float64)), 0.0), np.where(valid, phi.astype(np.float64), 0.0)
    a, p = psi.sum(axis=1), np.maximum(phi.sum(axis=1), 1e-300)
    return 4 * U * a / np.sqrt(p) + 4 * U * np.abs(lh), 4 * U * a / p + 8 * U * np.abs(flux)


def test_filter_workunit_rebuild_and_stamps_equal_jax(tmp_path, capsys):
    """create_test_data -> the port's kbmod_search -> strip the curves ->
    kbmod_filter --workunit --sigma_g_bnds 25,75 -> kbmod_stamps, each tool
    of the port (``--device cpu``) beside the JAX tool on the same files.
    The rebuilt curves equal the curves the search stored bit for bit (the
    same K1 twin on the same file) and the JAX tool's within 4 ulps."""
    from kbmod_tpu_torch.configuration import SearchConfiguration

    wu = str(tmp_path / "wu.fits")
    run_main("kbmod_create_test_data", [f"--outfile={wu}", "--num_times=10", "--width=64", "--height=48",
                                        "--num_objects=2", "--flux=500", "--seed=42", "--mask_fraction=0.02"])
    cfg = str(tmp_path / "cfg.yaml")
    SearchConfiguration.from_dict({
        "generator_config": {"name": "EclipticCenteredSearch", "velocities": [0.0, 60.0, 9],
                             "angles": [-3.2, 3.2, 9], "angle_units": "radian", "given_ecliptic": 0.0},
        "num_obs": 4, "lh_level": 8.0, "compute_ra_dec": False}).to_file(cfg)
    found = str(tmp_path / "found.ecsv")
    run_main("kbmod_search", [f"--workunit={wu}", f"--outfile={found}", f"--config={cfg}", "--device", "cpu"])
    stripped = str(tmp_path / "stripped.ecsv")
    run_main("kbmod_strip_results", [f"--input={found}", f"--outfile={stripped}", "--cols=psi_curve,phi_curve"])
    stored = Results.read_table(found)
    assert len(stored) > 2 and "psi_curve" not in Results.read_table(stripped).colnames

    got, ref = str(tmp_path / "filt.ecsv"), str(tmp_path / "filt_jax.ecsv")
    argv = [f"--input={stripped}", f"--workunit={wu}", "--sigma_g_bnds=25,75"]
    run_main("kbmod_filter", argv + [f"--outfile={got}", "--device", "cpu"])
    run_jax("kbmod_filter", argv + [f"--outfile={ref}"])
    g, r = assert_tables_equal(got, ref, skip=("psi_curve", "phi_curve", "likelihood", "flux"))
    for col in ("psi_curve", "phi_curve"):
        np.testing.assert_array_equal(_column(g, col), _column(stored, col), err_msg=col)
        a, b = _column(g, col).astype(np.float32), _column(r, col).astype(np.float32)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ulps = np.abs(np.where(np.isnan(b), 0, a).view(np.int32).astype(np.int64)
                      - np.where(np.isnan(b), 0, b).view(np.int32))
        assert ulps.max() <= 4, col
    valid = _column(r, "obs_valid").astype(bool)
    lh_b, flux_b = _curve_bounds(_column(r, "psi_curve"), _column(r, "phi_curve"), valid,
                                 _column(r, "likelihood"), _column(r, "flux"))
    assert np.all(np.abs(_column(g, "likelihood") - _column(r, "likelihood")) <= lh_b)
    assert np.all(np.abs(_column(g, "flux") - _column(r, "flux")) <= flux_b)

    # The stamps of the filtered rows: coadds equal (the JAX tool on the
    # port's rows, so that both cut the same trajectories).
    s_got, s_ref = str(tmp_path / "st.ecsv"), str(tmp_path / "st_jax.ecsv")
    argv = [f"--input={got}", f"--workunit={wu}", "--coadds=mean,median,sum", "--radius=5", "--all_stamps"]
    run_main("kbmod_stamps", argv + [f"--outfile={s_got}", "--device", "cpu"])
    run_jax("kbmod_stamps", argv + [f"--outfile={s_ref}"])
    st, _ = assert_tables_equal(s_got, s_ref)
    assert _column(st, "coadd_mean").shape == (len(g), 11, 11)
    assert _column(st, "all_stamps").shape == (len(g), 10, 11, 11)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default device is usable")
@pytest.mark.parametrize("tool", ["kbmod_filter", "kbmod_stamps"])
def test_card_tools_raise_without_a_card(tool, tmp_path, fake_files):
    """Without ``--device cpu`` the card tools run on CUDA, and raise
    without a card: no path falls back to the host on its own."""
    wu = str(tmp_path / "wu.fits")
    run_main("kbmod_create_test_data", [f"--outfile={wu}", "--num_times=4", "--width=24", "--height=20",
                                        "--seed=1"])
    argv = [f"--input={fake_files[0]}", f"--outfile={tmp_path / 'out.ecsv'}", f"--workunit={wu}"]
    if tool == "kbmod_filter":
        argv.append("--sigma_g_bnds=25,75")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_main(tool, argv)
