"""Port parity for stamp vetting: kbmod_tpu_torch's ResNet classifier,
``filter_stamps_by_cnn``, brightness filter and known-object matcher
against the JAX package's on the CPU.

- The CNN: resnet18, resnet34 and resnet50 logits through weights carried
  across by ``convert_flax_params`` from a seeded JAX ``StampClassifier``
  (whose BatchNorm statistics and scales are drawn at random, so the
  conversion is exercised), both in memory and through the JAX package's
  ``.npz`` archive; a torchvision-style ``state_dict`` with the reference
  wrapper's ``model.`` prefix loaded by both packages; the port's
  ``save_weights`` archive loaded by the JAX package, the JAX package's
  loaded by the port, and the port's own round trip bit-equal. 21 x 21 stamps, a
  batch of 4. Tolerance: logits within 1e-5 * (1 + max |logit|) of the
  batch (float32 convolutions in another order: XLA against PyTorch's CPU
  kernels); the predicted class is equal wherever the two logits of a
  stamp differ by more than that.
- ``filter_stamps_by_cnn``: the normalized stamps exactly, then the
  columns under the same tolerance, and its checks.
- Brightness: the curves exactly, the (R, C) scores within 1e-5 relative
  (a float32 sum over T in another order), the best index equal where the
  two best scores do not tie within that, and the filter's kept rows.
- Known objects: the matches, invalidated observations, recovery columns
  and filtering equal, on the WCS and catalog of
  tests/test_known_object_filters.py and on a fake WCS whose catalog is a
  result's own path.
"""

import jax
import numpy as np
import pytest
import torch

from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.fake_data.fake_result_creator import add_fake_coadds_to_results, make_fake_results
from kbmod_tpu.filters import brightness_filters as jbright
from kbmod_tpu.filters import stamp_filters as jstamp
from kbmod_tpu.filters.known_object_filters import KnownObjsMatcher as JMatcher
from kbmod_tpu.models import cnn as jcnn
from kbmod_tpu.results import Results
from kbmod_tpu.search import Trajectory
from kbmod_tpu.table import Table as JTable
from kbmod_tpu.trajectory_utils import trajectory_predict_skypos as j_predict_skypos
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs

from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.filters import brightness_filters as tbright
from kbmod_tpu_torch.filters import stamp_filters as tstamp
from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher, apply_known_obj_filters
from kbmod_tpu_torch.models import cnn as tcnn
from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.search import Trajectory as TTrajectory
from kbmod_tpu_torch.table import Table
from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos
from kbmod_tpu_torch.wcs_utils import make_fake_wcs

TOL = 1e-5


def _jax_classifier(model_type, seed=3, width=21):
    """A seeded JAX classifier with random BatchNorm scales, shifts and
    running statistics."""
    clf = jcnn.StampClassifier(model_type=model_type, stamp_width=width, seed=seed)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf)
        if "'mean'" in name or ("BatchNorm" in name and "'bias'" in name):
            return rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    clf.params = jax.tree_util.tree_map_with_path(perturb, clf.params)
    clf.batch_stats = jax.tree_util.tree_map_with_path(perturb, clf.batch_stats)
    return clf


def _stamps(n=4, width=21, seed=7):
    return np.random.default_rng(seed).normal(size=(n, width, width)).astype(np.float32)


def _assert_logits(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    tol = TOL * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    clear = np.abs(want[:, 1] - want[:, 0]) > tol
    np.testing.assert_array_equal(np.argmax(got, axis=1)[clear], np.argmax(want, axis=1)[clear])


@pytest.mark.parametrize("model_type", ["resnet18", "resnet34", "resnet50"])
def test_logits_through_convert_flax_params(tmp_path, model_type):
    ref = _jax_classifier(model_type)
    stamps = _stamps()
    want = ref.predict(stamps)
    arch = tcnn.MODEL_TYPES[model_type]()
    state = tcnn.convert_flax_params(
        jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats),
        arch.stage_sizes, arch.block_cls)
    in_memory = tcnn.StampClassifier(model_type, 21, device="cpu")
    in_memory.load_state_dict(state)
    _assert_logits(in_memory.predict(stamps), want)
    path = tmp_path / f"{model_type}.npz"
    ref.save_weights(str(path))
    archived = tcnn.StampClassifier(model_type, 21, model_path=str(path), device="cpu")
    _assert_logits(archived.predict(stamps[:, None]), want)
    assert archived.device.type == "cpu" and not archived.model.training


def test_torchvision_state_dict_loads_in_both(tmp_path):
    """A torchvision-style resnet18 state_dict (drawn from torch.Generator,
    BatchNorm statistics perturbed) saved with the ``model.`` prefix."""
    model = tcnn.StampClassifier("resnet18", 21, seed=11, device="cpu").model
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    path = tmp_path / "resnet18.pt"
    torch.save({f"model.{k}": v for k, v in model.state_dict().items()}, str(path))
    stamps = _stamps(seed=13)
    want = jcnn.StampClassifier("resnet18", 21, model_path=str(path)).predict(stamps)
    got = tcnn.StampClassifier("resnet18", 21, model_path=str(path), device="cpu").predict(stamps)
    _assert_logits(got, want)
    with torch.no_grad():
        direct = model.eval()(torch.as_tensor(stamps[:, None])).numpy()
    np.testing.assert_array_equal(got, direct)


def _port_classifier(model_type, seed=21):
    """A seeded port classifier with its BatchNorm statistics and scales
    drawn at random (torch.Generator), so that every tensor kind is saved."""
    clf = tcnn.StampClassifier(model_type, 21, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in clf.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.05, generator=gen)
    return clf


@pytest.mark.parametrize("model_type", ["resnet18", "resnet50"])
def test_save_weights_loads_in_jax(tmp_path, model_type):
    """Port save -> the JAX package's load_weights: the same logits as the
    port's (TOL, as above), and the archive has the JAX layout's keys."""
    clf = _port_classifier(model_type)
    path = tmp_path / f"{model_type}.npz"
    clf.save_weights(str(path))
    stamps = _stamps(seed=23)
    ref = jcnn.StampClassifier(model_type=model_type, stamp_width=21, model_path=str(path))
    _assert_logits(clf.predict(stamps), ref.predict(stamps))
    want_keys = set(np.load(str(path)).files)
    jax_path = tmp_path / f"{model_type}_jax.npz"
    ref.save_weights(str(jax_path))
    assert set(np.load(str(jax_path)).files) == want_keys


@pytest.mark.parametrize("model_type", ["resnet18", "resnet50"])
def test_jax_save_weights_loads_in_port(tmp_path, model_type):
    """JAX save -> port load: the same logits (TOL)."""
    ref = _jax_classifier(model_type, seed=5)
    path = tmp_path / f"{model_type}.npz"
    ref.save_weights(str(path))
    stamps = _stamps(seed=29)
    got = tcnn.StampClassifier(model_type, 21, model_path=str(path), device="cpu").predict(stamps)
    _assert_logits(got, ref.predict(stamps))


@pytest.mark.parametrize("model_type", ["resnet18", "resnet50"])
def test_save_weights_round_trips_bit_equal(tmp_path, model_type):
    """Port save -> port load: every parameter and buffer bit-equal (but
    ``num_batches_tracked``, which the flax layout does not hold), and so
    the logits."""
    clf = _port_classifier(model_type, seed=31)
    path = tmp_path / f"{model_type}.npz"
    clf.save_weights(str(path))
    back = tcnn.StampClassifier(model_type, 21, model_path=str(path), device="cpu")
    want, got = clf.model.state_dict(), back.model.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    stamps = _stamps(seed=37)
    np.testing.assert_array_equal(back.predict(stamps), clf.predict(stamps))


def test_random_init_is_seeded_and_checked():
    a = tcnn.StampClassifier("resnet18", 21, seed=5, device="cpu")
    b = tcnn.StampClassifier("resnet18", 21, seed=5, device="cpu")
    c = tcnn.StampClassifier("resnet18", 21, seed=6, device="cpu")
    stamps = _stamps()
    np.testing.assert_array_equal(a.predict(stamps), b.predict(stamps))
    assert not np.array_equal(a.predict(stamps), c.predict(stamps))
    with pytest.raises(ValueError, match="Unknown CNN model type"):
        tcnn.StampClassifier("resnet101", device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        a.load_state_dict({"fc.weight": torch.zeros(2, 512)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcnn.StampClassifier("resnet18")


def _fake_results(n=5, radius=10, seed=5):
    results = make_fake_results(5, 100, 100, n, rng=np.random.default_rng(seed))
    add_fake_coadds_to_results(results, radius, ["mean"], rng=np.random.default_rng(seed))
    return results, TResults({k: np.asarray(results[k]) for k in results.colnames})


@pytest.mark.parametrize("radii", [(10, 10), (10, 7)], ids=["same", "cropped"])
def test_filter_stamps_by_cnn_matches(tmp_path, radii):
    coadd_radius, stamp_radius = radii
    ref, got = _fake_results(6, coadd_radius)
    width = 2 * stamp_radius + 1
    path = tmp_path / "weights.npz"
    _jax_classifier("resnet18", width=width).save_weights(str(path))
    stamps = np.asarray(ref["coadd_mean"])
    d = coadd_radius - stamp_radius
    crop = stamps[:, d:-d, d:-d] if d else stamps
    np.testing.assert_array_equal(tstamp._normalize_stamps(crop, width), jstamp._normalize_stamps(crop, width))
    kw = dict(coadd_type="mean", stamp_radius=stamp_radius, coadd_radius=coadd_radius)
    jstamp.filter_stamps_by_cnn(ref, str(path), **kw)
    tstamp.filter_stamps_by_cnn(got, str(path), device="cpu", **kw)
    logits = np.stack([np.asarray(got["prob_bogus"]), np.asarray(got["prob_real"])], axis=1)
    want = np.stack([np.asarray(ref["prob_bogus"]), np.asarray(ref["prob_real"])], axis=1)
    _assert_logits(logits, want)
    clear = np.abs(want[:, 1] - want[:, 0]) > TOL * (1.0 + np.abs(want).max())
    np.testing.assert_array_equal(np.asarray(got["cnn_class"])[clear], np.asarray(ref["cnn_class"])[clear])
    assert np.asarray(got["cnn_class"]).dtype == bool


def test_filter_stamps_by_cnn_checks():
    _, got = _fake_results(3, 5)
    with pytest.raises(ValueError, match="coadd type"):
        tstamp.filter_stamps_by_cnn(got, None, coadd_type="median", device="cpu")
    with pytest.raises(ValueError, match="too large"):
        tstamp.filter_stamps_by_cnn(got, None, stamp_radius=6, coadd_radius=5, device="cpu")
    tstamp.filter_stamps_by_cnn(got, None, stamp_radius=5, coadd_radius=5, device="cpu")
    assert {"prob_real", "prob_bogus", "cnn_class"} <= set(got.colnames)
    assert np.asarray(got["prob_real"]).shape == (3,)


def _bright_stack(seed):
    times = create_fake_times(8, 57130.0, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(64, 64, times, use_seed=seed, mask_fraction=0.05)
    objs = [Trajectory(x=30, y=30, vx=5.0, vy=0.0, flux=200.0), Trajectory(x=10, y=50, vx=-2.0, vy=-3.0, flux=120.0)]
    for o in objs:
        ds.insert_object(o)
    st = ds.stack_py
    tst = TImageStackPy(times=list(st.times), sci=[np.array(s) for s in st.sci], var=[np.array(v) for v in st.var],
                        psfs=[np.asarray(p) for p in st.psfs])
    rng = np.random.default_rng(seed)
    trjs = objs + [Trajectory(x=int(rng.integers(-5, 70)), y=int(rng.integers(-5, 70)),
                              vx=float(rng.normal(0, 4)), vy=float(rng.normal(0, 4)),
                              flux=float(rng.choice([0.1, 20.0, 150.0, 900.0]))) for _ in range(40)]
    return st, tst, trjs


def test_brightness_filters_match():
    st, tst, trjs = _bright_stack(13)
    ref = Results.from_trajectories(trjs)
    got = TResults({k: np.asarray(ref[k]) for k in ref.colnames})
    j_sci, j_var = jbright.extract_sci_var_curves(ref, st)
    t_sci, t_var = tbright.extract_sci_var_curves(got, tst)
    np.testing.assert_array_equal(t_sci, j_sci)
    np.testing.assert_array_equal(t_var, j_var)
    assert "sci_curve" in got.colnames and "var_curve" in got.colnames
    a = tbright.extract_sci_var_curves(got, tst, keep_nans=False, append=False)
    b = jbright.extract_sci_var_curves(ref, st, keep_nans=False, append=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)

    cands = np.array([0.5, 1.0, 10.0, 150.0, 300.0], np.float32)
    want = jbright.score_brightness_candidates(j_sci, j_var, cands)
    got_scores = tbright.score_brightness_candidates(t_sci, t_var, cands, device="cpu")
    np.testing.assert_allclose(got_scores, want, rtol=TOL)
    per_row = np.abs(np.random.default_rng(2).normal(50, 30, (len(trjs), 4))).astype(np.float32)
    np.testing.assert_allclose(tbright.score_brightness_candidates(t_sci, t_var, per_row, device="cpu"),
                               jbright.score_brightness_candidates(j_sci, j_var, per_row), rtol=TOL)
    with pytest.raises(ValueError, match="same number of results"):
        tbright.score_brightness_candidates(t_sci, t_var, per_row[:3], device="cpu")

    offsets = np.array([0.5, 0.75, 0.9, 0.95, 0.99, 1.0, 1.01, 1.05, 1.1, 1.25, 1.5])
    for brightness in (None, np.asarray(ref["flux"])):
        jb, ji = jbright.local_search_brightness(j_sci, j_var, brightness=brightness)
        tb, ti = tbright.local_search_brightness(t_sci, t_var, brightness=brightness, device="cpu")
        center = np.nanmedian(t_sci, axis=1) if brightness is None else brightness
        s = np.sort(tbright.score_brightness_candidates(t_sci, t_var, center[:, None] * offsets[None, :],
                                                        device="cpu"), axis=1)
        clear = s[:, 1] - s[:, 0] > TOL * np.abs(s[:, 0])
        assert clear.sum() > 0.75 * len(clear)
        np.testing.assert_array_equal(ti[clear], ji[clear])
        np.testing.assert_array_equal(tb[clear], jb[clear])

    ref2 = Results.from_trajectories(trjs)
    got2 = TResults({k: np.asarray(ref2[k]) for k in ref2.colnames})
    jbright.apply_brightness_search_filter(ref2, st)
    tbright.apply_brightness_search_filter(got2, tst, device="cpu")
    assert 0 < len(got2) < len(trjs)
    for k in ("x", "y", "vx", "vy", "flux"):
        np.testing.assert_array_equal(np.asarray(got2[k]), np.asarray(ref2[k]), err_msg=k)
    assert (30, 30) in set(zip(np.asarray(got2["x"]).tolist(), np.asarray(got2["y"]).tolist()))


def _known_setup(make_wcs, table_cls, results_cls, traj_cls, predict):
    """tests/test_known_object_filters.py's setup in either package."""
    wcs = make_wcs(200.0, -7.0, 500, 500, 1.0 / 3600.0)
    obstimes = 57130.0 + np.arange(5) * 0.1
    trj = traj_cls(x=250, y=250, vx=10.0, vy=5.0, flux=100.0, lh=50.0, obs_count=5)
    results = results_cls.from_trajectories([trj, traj_cls(x=10, y=10, vx=-5.0, vy=0.0, lh=20.0, obs_count=5)])
    results.table["obs_valid"] = np.ones((2, 5), dtype=bool)
    coords = predict(trj, wcs, obstimes)
    catalog = table_cls({
        "Name": np.array(["A"] * 5 + ["B"] * 2, dtype=object),
        "RA": np.concatenate([coords.ra_deg, [210.0, 210.1]]),
        "DEC": np.concatenate([coords.dec_deg, [-10.0, -10.1]]),
        "mjd_mid": np.concatenate([obstimes, obstimes[:2]]),
    })
    return wcs, obstimes, results, catalog


@pytest.mark.parametrize("shift_s", [0.0, 1800.0], ids=["in_window", "out_of_window"])
def test_known_object_matcher_matches(shift_s):
    j = _known_setup(j_make_fake_wcs, JTable, Results, Trajectory, j_predict_skypos)
    t = _known_setup(make_fake_wcs, Table, TResults, TTrajectory, trajectory_predict_skypos)
    np.testing.assert_array_equal(np.asarray(t[3]["RA"], dtype=float), np.asarray(j[3]["RA"], dtype=float))
    out = []
    for (wcs, obstimes, results, catalog), cls in ((j, JMatcher), (t, KnownObjsMatcher)):
        catalog["mjd_mid"] = np.asarray(catalog["mjd_mid"], dtype=float) + shift_s / 86400.0
        m = cls(catalog, obstimes, "known", sep_thresh=2.0, time_thresh_s=600.0)
        m.match(results, wcs)
        m.match_on_min_obs(results, 3)
        m.match_on_obs_ratio(results, 1.0)
        rec = m.get_recovered_objects(results, m.match_min_obs_col(3))
        matches = [{k: list(v) for k, v in d.items()} for d in results["known"]]
        m.mark_matched_obs_invalid(results, drop_empty_rows=False)
        out.append(([sorted(x) for x in results[m.match_min_obs_col(3)]],
                    [sorted(x) for x in results[m.match_obs_ratio_col(1.0)]]))
        out[-1] = (matches,) + out[-1] + (rec, np.asarray(results["obs_valid"]).tolist(), len(m))
        m.filter_matches(results, m.match_min_obs_col(3))
        out[-1] += (np.asarray(results["x"]).tolist(),)
    assert out[0] == out[1]
    if shift_s == 0.0:
        assert out[1][0][0] == {"A": [True] * 5} and out[1][3] == ({"A"}, {"B"}) and out[1][6] == [10]


def test_apply_known_obj_filters_on_a_fake_wcs():
    """A catalog made from one result's own path: that row is matched and
    loses every observation; apply_known_obj_filters equals the JAX
    package's steps."""
    wcs = make_fake_wcs(150.0, 2.0, 2048, 2048, 0.27 / 3600.0)
    times = 57130.2 + np.array([0.0, 0.01, 0.02, 1.0, 1.01, 1.02, 2.0, 2.01])
    obj = TTrajectory(x=700, y=900, vx=13.0, vy=-2.5, lh=40.0, obs_count=8)
    other = TTrajectory(x=100, y=120, vx=1.0, vy=1.0, lh=30.0, obs_count=8)
    coords = trajectory_predict_skypos(obj, wcs, times)
    catalog = Table({"Name": np.array(["obj"] * 8, dtype=object), "RA": coords.ra_deg, "DEC": coords.dec_deg,
                     "mjd_mid": times})
    results = TResults.from_trajectories([other, obj])
    results.table["obs_valid"] = np.ones((2, 8), dtype=bool)
    apply_known_obj_filters(results, KnownObjsMatcher(catalog, times, "ko", sep_thresh=0.5), wcs, {})
    assert len(results) == 1 and int(results["x"][0]) == 100

    jwcs = j_make_fake_wcs(150.0, 2.0, 2048, 2048, 0.27 / 3600.0)
    jres = Results.from_trajectories([Trajectory(x=100, y=120, vx=1.0, vy=1.0), Trajectory(x=700, y=900, vx=13.0, vy=-2.5)])
    jres.table["obs_valid"] = np.ones((2, 8), dtype=bool)
    jcat = JTable({"Name": np.array(["obj"] * 8, dtype=object), "RA": np.asarray(coords.ra_deg),
                   "DEC": np.asarray(coords.dec_deg), "mjd_mid": times})
    m = JMatcher(jcat, times, "ko", sep_thresh=0.5)
    m.match(jres, jwcs)
    m.mark_matched_obs_invalid(jres)
    assert np.asarray(jres["x"]).tolist() == [100]
