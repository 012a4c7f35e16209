"""The port's core.shift_and_stack and fake-data helpers against the JAX
package's, on the CPU.

``generate_psi_phi_images`` (one image) and ``generate_psi_phi_from_image_stack``
(a stack) run K1's plain twin here and return tensors on the device; they
are held to the JAX package's numpy results within K1's Queue 3 bound,
rtol = atol = 1e-5 (tests/test_torch_convolve.py), with NaN masks exact.
``fake_result_creator`` and ``demo_helper`` are host copies: the same
``rng`` (or seed) gives equal tables, with no tolerance.
"""

import numpy as np
import pytest
import torch

from kbmod_tpu.core import shift_and_stack as j_sas
from kbmod_tpu.core.image_stack_py import ImageStackPy as JImageStackPy
from kbmod_tpu.core.psf import PSF as JPSF
from kbmod_tpu.fake_data import demo_helper as j_demo
from kbmod_tpu.fake_data import fake_result_creator as j_frc

from kbmod_tpu_torch.core import shift_and_stack as t_sas
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.fake_data import demo_helper as t_demo
from kbmod_tpu_torch.fake_data import fake_result_creator as t_frc
from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(T=3, H=40, W=52, seed=4):
    rng = np.random.default_rng(seed)
    sci = rng.normal(10, 2, (T, H, W)).astype(np.float32)
    var = rng.uniform(1, 4, (T, H, W)).astype(np.float32)
    sci[rng.uniform(size=(T, H, W)) < 0.05] = np.nan
    var[rng.uniform(size=(T, H, W)) < 0.02] = np.nan
    return sci, var


def _close(t, j):
    t = t.cpu().numpy()
    assert t.dtype == np.float32 and t.shape == np.shape(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("psf_std", [0.5, 1.0, 1.7])
@pytest.mark.parametrize("as_psf", [False, True])
def test_generate_psi_phi_images(psf_std, as_psf):
    sci, var = _images(1)
    kernel = PSF.make_gaussian_kernel(psf_std)
    t_psf = PSF(kernel) if as_psf else kernel
    j_psf = JPSF(JPSF.make_gaussian_kernel(psf_std)) if as_psf else JPSF.make_gaussian_kernel(psf_std)
    psi_phi_conv_plain.calls = 0
    psi, phi = t_sas.generate_psi_phi_images(sci[0], var[0], t_psf, device="cpu")
    assert psi_phi_conv_plain.calls == 1
    assert isinstance(psi, torch.Tensor) and psi.device.type == "cpu" and psi.shape == sci[0].shape
    j_psi, j_phi = j_sas.generate_psi_phi_images(sci[0], var[0], j_psf)
    _close(psi, j_psi)
    _close(phi, j_phi)


def test_generate_psi_phi_from_image_stack():
    """A stack with two PSFs: one K1 build per PSF group, (T, H, W) tensors
    equal to the JAX package's lists, plane for plane."""
    sci, var = _images(4)
    times = [57130.0, 57130.1, 57130.3, 57131.0]
    psfs = [PSF.make_gaussian_kernel(1.0 if i % 2 else 1.4) for i in range(4)]
    stack = ImageStackPy(times=times, sci=list(sci), var=list(var), psfs=psfs)
    j_stack = JImageStackPy(times=times, sci=list(sci), var=list(var), psfs=[np.array(p) for p in psfs])
    psi_phi_conv_plain.calls = 0
    psi, phi = t_sas.generate_psi_phi_from_image_stack(stack, device="cpu")
    assert psi_phi_conv_plain.calls == 2
    j_psi, j_phi = j_sas.generate_psi_phi_from_image_stack(j_stack)
    assert psi.shape == (4, 40, 52) and len(j_psi) == 4
    for t in range(4):
        _close(psi[t], j_psi[t])
        _close(phi[t], j_phi[t])
    # The single-image function gives each plane of the stack's build.
    one_psi, one_phi = t_sas.generate_psi_phi_images(sci[2], var[2], psfs[2], device="cpu")
    assert torch.equal(one_psi.isnan(), psi[2].isnan())
    np.testing.assert_array_equal(one_psi.numpy(), psi[2].numpy())
    np.testing.assert_array_equal(one_phi.numpy(), phi[2].numpy())
    all_psi, _ = t_sas.generate_all_psi_phi_images(stack.sci, stack.var, stack.psfs, device="cpu")
    assert torch.equal(torch.nan_to_num(all_psi, 7.0), torch.nan_to_num(psi, 7.0))


def _assert_same_results(t, j):
    """Equal columns, but for ``uuid``: each package draws it from uuid4,
    not from the ``rng``."""
    assert list(t.colnames) == list(j.colnames) and len(t) == len(j)
    for col in (c for c in t.colnames if c != "uuid"):
        a, b = np.asarray(t[col]), np.asarray(j[col])
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), col
    np.testing.assert_array_equal(t.mjd_mid, j.mjd_mid)


@pytest.mark.parametrize("seed", [0, 5])
def test_fake_result_creator_same_rng(seed):
    t = t_frc.make_fake_results(9, 64, 48, 12, rng=np.random.default_rng(seed))
    j = j_frc.make_fake_results(9, 64, 48, 12, rng=np.random.default_rng(seed))
    _assert_same_results(t, j)
    t_frc.add_fake_coadds_to_results(t, 5, coadd_types=("mean", "median"), rng=np.random.default_rng(seed + 1))
    j_frc.add_fake_coadds_to_results(j, 5, coadd_types=("mean", "median"), rng=np.random.default_rng(seed + 1))
    _assert_same_results(t, j)
    trj_t = t_frc.make_fake_trajectories(6, 30, 20, rng=np.random.default_rng(seed))
    trj_j = j_frc.make_fake_trajectories(6, 30, 20, rng=np.random.default_rng(seed))
    assert [(a.x, a.y, a.vx, a.vy, a.flux, a.lh, a.obs_count) for a in trj_t] == [
        (b.x, b.y, b.vx, b.vy, b.flux, b.lh, b.obs_count) for b in trj_j]


def test_demo_helper_same_work_unit(tmp_path):
    """make_demo_data in both packages: equal layers, times and
    configuration; the port's file reads back in the JAX package."""
    from kbmod_tpu.work_unit import WorkUnit as JWorkUnit

    path = str(tmp_path / "demo.fits")
    t = t_demo.make_demo_data(path)
    j = j_demo.make_demo_data()
    assert t.config.to_dict() == j.config.to_dict()
    np.testing.assert_array_equal(t.im_stack.times, j.im_stack.times)
    for i in range(t.im_stack.num_times):
        assert np.array_equal(t.im_stack.sci[i], j.im_stack.sci[i], equal_nan=True)
        assert np.array_equal(t.im_stack.var[i], j.im_stack.var[i], equal_nan=True)
    back = JWorkUnit.from_fits(path)
    assert np.array_equal(back.im_stack.sci[3], j.im_stack.sci[3], equal_nan=True)
