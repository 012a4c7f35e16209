"""The reference's regression configuration through the port's entry point
(``kbmod_tpu_torch.scripts.regression``) against the JAX package's runner,
on the CPU.

The port's ``SearchRunner(device="cpu").run_search_from_work_unit`` and
the JAX package's runner each build the 20 x 1024 x 512 stack from seed
1001 (the two stacks are asserted equal) with the 20 objects, 2 of them
starting off the chip, and search it with the regression configuration:
EclipticCenteredSearch, the in-kernel sigma-G pool with ``clip_negative``,
median stamps, pixel buffers of 10. The same trims as the JAX package's
``tests/test_regression.py::test_reference_scale_regression`` keep it
inside the suite's time: the lattice-identical 16-step subset of the speed
axis, ``KB_SIGMAG_TOPK_FACTOR=1`` and ``KB_SIGMAG_AUTO=0`` (the full grid
and pool run on the card, in ``chip_smoke.py``).

Both recover all 20 objects, and the results files' metadata reads back.
The final rows match: x, y, vx, vy, obs_count and obs_valid exactly and in
the same order; likelihood and flux within ROADMAP Queue 3's "lh rounding"
bound taken twice (each side within it of the float64 sums of its rows'
kept samples) plus 2 float32 ulps, since each side builds its own psi/phi
(K1's twin against XLA's convolution, a float32 ulp apart at most).
"""

import numpy as np
import pytest
import torch

from kbmod_tpu.configuration import SearchConfiguration as JConfig
from kbmod_tpu.core.psf import PSF as JPSF
from kbmod_tpu.fake_data.fake_data_creator import image_stack_add_fake_object as j_add_object
from kbmod_tpu.fake_data.fake_data_creator import make_fake_image_stack as j_make_stack
from kbmod_tpu.results import Results as JResults
from kbmod_tpu.run_search import SearchRunner as JSearchRunner
from kbmod_tpu.trajectory_utils import match_trajectory_sets as j_match
from kbmod_tpu.work_unit import WorkUnit as JWorkUnit

from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.scripts import regression

U = 2.0**-24
KEY = ("x", "y", "vx", "vy", "obs_count")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and PyTorch's default of one thread a core
    each oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_stack():
    times, sigmas = regression.times_and_psf_sigmas()
    psfs = [JPSF.make_gaussian_kernel(v) for v in sigmas]
    stack = j_make_stack(regression.HEIGHT, regression.WIDTH, times, noise_level=4.0, psfs=psfs,
                         rng=np.random.default_rng(1001))
    for x, y, vx, vy in regression.TRJS:
        j_add_object(stack, x, y, vx, vy, flux=regression.FLUX)
    return stack


def _lh_bounds(table, T):
    """Per row: the Queue 3 bound of likelihood and of flux against the
    float64 sums of the row's kept samples (obs_valid) of its curves."""
    ok = np.asarray(table["obs_valid"], bool)
    psi = np.where(ok, np.asarray(table["psi_curve"], np.float64), 0.0)
    phi = np.where(ok, np.asarray(table["phi_curve"], np.float64), 0.0)
    s_abs, s_psi, s_phi = np.abs(psi).sum(1), psi.sum(1), phi.sum(1)
    lh64, flux64 = s_psi / np.sqrt(s_phi), s_psi / s_phi
    lh_b = (T + 1) * U * s_abs / np.sqrt(s_phi) + 2 * U * np.abs(lh64)
    flux_b = (T + 1) * U * s_abs / s_phi + 2 * U * np.abs(flux64)
    return lh_b, flux_b


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


@pytest.fixture
def trimmed(monkeypatch):
    monkeypatch.setenv("KB_SIGMAG_TOPK_FACTOR", "1")
    monkeypatch.setenv("KB_SIGMAG_AUTO", "0")


def test_regression_config_matches_jax(tmp_path, trimmed, capsys):
    """The script's main on the CPU (the trimmed grid) against the JAX
    package's runner."""
    stack = regression.make_stack()
    jstack = _jax_stack()
    for a, b in ((stack.sci, jstack.sci), (stack.var, jstack.var), (stack.psfs, jstack.psfs)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    times, _ = regression.times_and_psf_sigmas()
    velocities = regression.TRIMMED_VELOCITIES

    lo, hi, steps = velocities
    path = tmp_path / "port.ecsv"
    assert regression.main(["--device", "cpu", "--velocities", f"{lo},{hi},{steps}", "--results", str(path)]) == 0
    out = capsys.readouterr().out
    assert "REGRESSION OK: all 20 recovered" in out
    assert "'search_topk_shift': 1" in out and "'psi_phi_conv': 0" in out and "host CPU" in out
    got = loaded = TResults.read_table(str(path))
    assert regression.check(loaded, stack, times) == []

    config = JConfig.from_dict(regression.config_dict(velocities))
    config.set("result_filename", str(tmp_path / "jax.ecsv"))
    wu = JWorkUnit(im_stack=jstack, config=config)
    wu.org_img_meta["visit"] = [f"img_{i}" for i in range(jstack.num_times)]
    JSearchRunner().run_search_from_work_unit(wu)
    ref = JResults.read_table(str(tmp_path / "jax.ecsv"))
    matches = j_match(_jax_trajectories(), ref.make_trajectory_list(), 3.0, [0.0, 2.0])
    assert np.all(np.asarray(matches) >= 0)

    # The final rows: the same rows in the same order.
    assert len(got) == len(ref) > 0
    for k in KEY:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["obs_valid"]), np.asarray(ref["obs_valid"]))
    lh_b, flux_b = _lh_bounds(ref, len(times))
    d_lh = np.abs(np.asarray(got["likelihood"], np.float64) - np.asarray(ref["likelihood"], np.float64))
    d_flux = np.abs(np.asarray(got["flux"], np.float64) - np.asarray(ref["flux"], np.float64))
    assert np.all(d_lh <= 2 * lh_b + 2 * _ulp(ref["likelihood"])), np.max(d_lh / (2 * lh_b))
    assert np.all(d_flux <= 2 * flux_b + 2 * _ulp(ref["flux"])), np.max(d_flux / (2 * flux_b))
    # The results files' metadata, the same on both sides.
    for key in ("num_img", "dims", "visit"):
        assert list(np.atleast_1d(loaded.table.meta[key])) == list(np.atleast_1d(ref.table.meta[key])), key
    np.testing.assert_allclose(loaded.table.meta["mjd_mid"], ref.table.meta["mjd_mid"])


def _jax_trajectories():
    from kbmod_tpu.search import Trajectory

    return [Trajectory(x, y, vx, vy, regression.FLUX) for x, y, vx, vy in regression.TRJS]


def test_regression_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        regression.main([])
