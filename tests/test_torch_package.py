"""The port's package and search facades against the JAX package's.

- ``kbmod_tpu_torch``: ``__version__``, ``is_interactive`` with
  ``KB_INTERACTIVE_MODE``, the ``kbmod`` logger's level from
  ``KB_LOG_LEVEL`` (in a child interpreter, since it is set at import), and
  the top-level names, three of them lazy.
- ``kbmod_tpu_torch.search``: the reference-binding names of the JAX
  package's ``search/__init__.py``; the image helpers (``convolve_image``,
  ``generate_psi``, ``generate_phi``; K1's twin here) against the JAX ones
  within 1e-6 relative with equal NaN masks: the masked convolution's
  normalisation sum adds in another order on each side, and K1 and XLA
  round a tap's product and sum apart, a few float32 ulps in all (5 at
  most measured); ``evaluate_trajectory_cpu`` and ``search_cpu_only``
  against the JAX functions on the same planes: rows and obs_count exact,
  lh and flux within twice ROADMAP Queue 3's row-sum bound (the two sum a
  row's samples in different orders), and a slot's candidate different
  only where the two candidates tie within it; ``StampType``; the device
  and memory helpers, which read ``torch.cuda.mem_get_info`` when called
  and return 0 without a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import kbmod_tpu
import kbmod_tpu.search as jsearch
import kbmod_tpu_torch
import kbmod_tpu_torch.search as tsearch
from kbmod_tpu_torch.core.psf import PSF

RTOL = 1e-6


def test_version_and_top_level_names():
    assert kbmod_tpu_torch.__version__ == kbmod_tpu.__version__
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.image_collection import ImageCollection
    from kbmod_tpu_torch.search.stack_search import StackSearch
    from kbmod_tpu_torch.search.trajectory import Trajectory
    from kbmod_tpu_torch.standardizers import Standardizer
    from kbmod_tpu_torch.work_unit import WorkUnit

    want = {"StackSearch": StackSearch, "Trajectory": Trajectory, "SearchConfiguration": SearchConfiguration,
            "Standardizer": Standardizer, "ImageCollection": ImageCollection, "WorkUnit": WorkUnit}
    for name, obj in want.items():
        assert getattr(kbmod_tpu_torch, name) is obj, name
        assert name in kbmod_tpu_torch.__all__
    assert set(kbmod_tpu.__all__) <= set(kbmod_tpu_torch.__all__)
    with pytest.raises(AttributeError):
        kbmod_tpu_torch.NoSuchName


@pytest.mark.parametrize("value,want", [("1", True), ("true", True), ("YES", True), ("0", False), ("no", False)])
def test_is_interactive_follows_the_environment(monkeypatch, value, want):
    monkeypatch.setenv("KB_INTERACTIVE_MODE", value)
    assert kbmod_tpu_torch.is_interactive() is want
    assert kbmod_tpu.is_interactive() is want


def test_log_level_and_lazy_imports_in_a_fresh_interpreter():
    """KB_LOG_LEVEL sets the kbmod logger at import; the import pulls in
    neither JAX, nor the ingestion stack (until a lazy name is read), nor
    initialises CUDA."""
    code = (
        "import logging, sys, kbmod_tpu_torch, torch\n"
        "print(logging.getLogger('kbmod').level)\n"
        "print(sorted(m for m in ('jax', 'kbmod_tpu', 'kbmod_tpu_torch.image_collection',"
        " 'kbmod_tpu_torch.standardizers', 'kbmod_tpu_torch.work_unit') if m in sys.modules))\n"
        "print(torch.cuda.is_initialized())\n"
        "kbmod_tpu_torch.WorkUnit\n"
        "print('kbmod_tpu_torch.work_unit' in sys.modules)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, KB_LOG_LEVEL="debug")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:4] == ["10", "[]", "False", "True"]


def test_search_names_cover_the_jax_facade():
    missing = [name for name in jsearch.__all__ if not hasattr(tsearch, name)]
    assert missing == []
    assert set(jsearch.__all__) <= set(tsearch.__all__)
    for name in ("STAMP_SUM", "STAMP_MEAN", "STAMP_MEDIAN", "STAMP_VAR_WEIGHTED"):
        assert getattr(tsearch.StampType, name) == getattr(jsearch.StampType, name)
    assert tsearch.HAS_OMP is False
    with pytest.raises(AttributeError):
        tsearch.NoSuchName


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_and_memory_helpers_without_a_card():
    assert tsearch.kb_has_gpu() is False and tsearch.HAS_CUDA is False
    assert tsearch.kb_get_gpu_free_memory() == 0
    assert tsearch.kb_get_gpu_total_memory() == 0
    assert tsearch.get_gpu_free_memory() == 0 and tsearch.get_gpu_total_memory() == 0
    assert tsearch.validate_gpu() is False and tsearch.validate_gpu(1) is False
    assert tsearch.stat_gpu_memory_mb() == "No accelerator device available."
    assert not torch.cuda.is_initialized()
    # The image helpers run on CUDA unless asked for the CPU.
    img = np.ones((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsearch.generate_psi(img, img, np.ones((3, 3), np.float32))


def _images(seed, H=40, W=36, masked=0.05):
    rng = np.random.default_rng(seed)
    img = rng.normal(10, 1, (H, W)).astype(np.float32)
    var = rng.uniform(1, 2, (H, W)).astype(np.float32)
    img[rng.uniform(size=img.shape) < masked] = np.nan
    var[rng.uniform(size=img.shape) < masked / 2] = np.nan
    return img, var


def _assert_close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("psf", ["flat3", "s1.3", "s2.0", "3x5"])
@pytest.mark.parametrize("seed", [0, 1])
def test_image_helpers_match_jax(psf, seed):
    if psf == "flat3":
        k = np.full((3, 3), 1.0 / 9.0, np.float32)
    elif psf == "3x5":
        k = np.random.default_rng(9).uniform(0.1, 1.0, (3, 5)).astype(np.float32)
    else:
        k = PSF.make_gaussian_kernel(float(psf[1:]))
    img, var = _images(seed)
    _assert_close(tsearch.generate_psi(img, var, k, device="cpu"), jsearch.generate_psi(img, var, k), "psi")
    _assert_close(tsearch.generate_phi(var, k, device="cpu"), jsearch.generate_phi(var, k), "phi")
    if k.shape[0] == k.shape[1]:
        ref = jsearch.convolve_image(img, k)
        for fn in (tsearch.convolve_image, tsearch.convolve_image_cpu, tsearch.convolve_image_gpu):
            _assert_close(fn(img, k, device="cpu"), ref, "convolve_image")
    np.testing.assert_array_equal(tsearch.square_psf_values(k), jsearch.square_psf_values(k))


def test_convolve_and_psf_helpers():
    """tests/test_search_kernel.py's case, on the port."""
    rng = np.random.default_rng(2)
    img = rng.normal(10, 1, (16, 16)).astype(np.float32)
    var = rng.uniform(1, 2, (16, 16)).astype(np.float32)
    psf = np.full((3, 3), 1.0 / 9.0, dtype=np.float32)
    out = tsearch.convolve_image(img, psf, device="cpu")
    assert out.shape == img.shape
    np.testing.assert_allclose(tsearch.square_psf_values(psf), psf**2)
    psi = tsearch.generate_psi(img, var, psf, device="cpu")
    phi = tsearch.generate_phi(var, psf, device="cpu")
    np.testing.assert_allclose(psi, tsearch.convolve_image(img / var, psf, device="cpu"), rtol=1e-5)
    np.testing.assert_allclose(phi, tsearch.convolve_image(1.0 / var, psf**2, device="cpu"), rtol=1e-5)


def _planes(seed, T=5, H=12, W=14):
    rng = np.random.default_rng(seed)
    psi = [rng.normal(0, 1, (H, W)).astype(np.float32) for _ in range(T)]
    phi = [rng.uniform(1, 2, (H, W)).astype(np.float32) for _ in range(T)]
    for t in range(T):
        phi[t][rng.uniform(size=(H, W)) < 0.1] = np.nan  # masked samples
    times = np.sort(rng.uniform(0, 2, T))
    times[0] = 0.0
    return psi, phi, times


def _both_arrays(psi, phi, times):
    j = jsearch.PsiPhiArray()
    jsearch.fill_psi_phi_array(j, -1, psi, phi, times)
    t = tsearch.PsiPhiArray()
    tsearch.fill_psi_phi_array(t, -1, psi, phi, times, device="cpu")
    return j, t


def _lh_bound(arr, xs, ys, vxs, vys, lh, flux):
    """Twice Queue 3's float32 bound of each row's lh and flux (the two
    sides sum the same samples in different orders): (T+1) u sum|psi| /
    sqrt(sum phi) + 2 u |lh| (flux: over sum phi), from the row's samples."""
    from kbmod_tpu_torch.ops.search import extract_psi_phi_curves

    psi, phi, valid = arr.decoded_psi_phi()
    pc, fc = extract_psi_phi_curves(psi, phi, valid, arr.times, np.asarray(xs), np.asarray(ys),
                                    np.asarray(vxs, np.float32), np.asarray(vys, np.float32))
    a, p = np.abs(pc.astype(np.float64)).sum(axis=1), np.maximum(fc.astype(np.float64).sum(axis=1), 1e-300)
    n, u = pc.shape[1] + 1, 2.0**-24
    lh_b = 2 * (n * u * a / np.sqrt(p) + 2 * u * np.abs(np.asarray(lh, np.float64)))
    flux_b = 2 * (n * u * (a / p + np.abs(np.asarray(flux, np.float64))) + 2 * u * np.abs(np.asarray(flux)))
    return lh_b, flux_b


@pytest.mark.parametrize("seed", [3, 4])
def test_evaluate_trajectory_cpu_equals_jax(seed):
    """obs_count exact; lh and flux within the row-sum bound (the JAX
    package's XLA sum adds in another order)."""
    psi, phi, times = _planes(seed)
    j, t = _both_arrays(psi, phi, times)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        x, y, vx, vy = int(rng.integers(-2, 16)), int(rng.integers(-2, 14)), *rng.normal(0, 3, 2)
        jt, tt = jsearch.Trajectory(x=x, y=y, vx=vx, vy=vy), tsearch.Trajectory(x=x, y=y, vx=vx, vy=vy)
        jsearch.evaluate_trajectory_cpu(j, jt)
        tsearch.evaluate_trajectory_cpu(t, tt)
        assert tt.obs_count == jt.obs_count
        lh_b, flux_b = _lh_bound(t, [x], [y], [tt.vx], [tt.vy], [jt.lh], [jt.flux])
        assert abs(tt.lh - jt.lh) <= lh_b[0] and abs(tt.flux - jt.flux) <= flux_b[0]


def test_evaluate_trajectory_cpu():
    """tests/test_search_kernel.py's case, on the port."""
    T, H, W = 4, 12, 12
    psi = [np.full((H, W), float(t + 1), dtype=np.float32) for t in range(T)]
    phi = [np.full((H, W), 2.0, dtype=np.float32) for _ in range(T)]
    arr = tsearch.PsiPhiArray()
    tsearch.fill_psi_phi_array(arr, -1, psi, phi, np.arange(T, dtype=float), device="cpu")
    trj = tsearch.Trajectory(x=5, y=5, vx=0.0, vy=0.0)
    tsearch.evaluate_trajectory_cpu(arr, trj)
    assert trj.obs_count == T
    np.testing.assert_allclose(trj.lh, (1 + 2 + 3 + 4) / np.sqrt(8.0), rtol=1e-6)
    np.testing.assert_allclose(trj.flux, 10.0 / 8.0, rtol=1e-6)


@pytest.mark.parametrize("rpp", [1, 3, 8])
def test_search_cpu_only_equals_jax(rpp):
    """Every pixel's min(results_per_pixel, candidates) rows, ungated: the
    same rows in the same order as the JAX function's."""
    from kbmod_tpu.search.stack_search import _SearchParams as JParams
    from kbmod_tpu_torch.search.stack_search import _SearchParams as TParams

    psi, phi, times = _planes(6, T=6, H=10, W=11)
    j, t = _both_arrays(psi, phi, times)
    rng = np.random.default_rng(6)
    vel = rng.normal(0, 2, (5, 2))
    out = []
    for pkg, params_cls, arr in ((jsearch, JParams, j), (tsearch, TParams, t)):
        params = params_cls()
        params.x_start_min, params.x_start_max = -1, 11
        params.y_start_min, params.y_start_max = 0, 9
        params.results_per_pixel = rpp
        cands = pkg.TrajectoryList([pkg.Trajectory(vx=float(a), vy=float(b)) for a, b in vel])
        results = pkg.TrajectoryList(0)
        pkg.search_cpu_only(arr, params, cands, results)
        out.append(results.get_arrays())
    ref, got = out
    n = len(ref["x"])
    assert len(got["x"]) == n == 12 * 9 * min(rpp, 5)
    for key in ("x", "y", "obs_count"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    lh_b, flux_b = _lh_bound(t, got["x"], got["y"], got["vx"], got["vy"], ref["lh"], ref["flux"])
    assert np.all(np.abs(got["lh"].astype(np.float64) - ref["lh"]) <= lh_b)
    # A slot may hold another candidate only where the two tie within the
    # bound (Queue 3: exact ties keep the earlier candidate on the port's
    # side, the later on the JAX side).
    swap = (got["vx"] != ref["vx"]) | (got["vy"] != ref["vy"])
    if swap.any():
        ref_b, _ = _lh_bound(t, ref["x"][swap], ref["y"][swap], ref["vx"][swap], ref["vy"][swap], ref["lh"][swap],
                             ref["flux"][swap])
        stats = tsearch.evaluate_trajectories(*t.decoded_psi_phi(), t.times, ref["x"][swap], ref["y"][swap],
                                              ref["vx"][swap], ref["vy"][swap])
        assert np.all(np.abs(stats["lh"].astype(np.float64) - got["lh"][swap]) <= ref_b + lh_b[swap])
    assert swap.sum() < n // 10
