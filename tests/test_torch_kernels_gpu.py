"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode). The file imports nothing of JAX, so it also runs
on a machine without it; tests/conftest.py does import JAX, so there run it
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: K1 to rtol = atol = 1e-5 with equal NaN masks (kernel and
twin take the same rounded steps in the same order: bit equality is
expected); K2-K5 indices equal and lh bit-equal (the same integer sums, the
decode rounded step by step, IEEE sqrt and division on both sides).
"""

import numpy as np
import pytest
import torch

from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.ops import conv_kernel, search_encoded_kernel, search_kernel
from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.ops.search_plan import _plan_groups

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _stack(dev, T, H, W, seed, masked=0.04):
    rng = np.random.default_rng(seed)
    sci = rng.normal(10, 2, (T, H, W)).astype(np.float32)
    var = rng.uniform(1, 4, (T, H, W)).astype(np.float32)
    sci[rng.uniform(size=sci.shape) < masked] = np.nan
    var[rng.uniform(size=sci.shape) < masked / 2] = np.nan
    var[rng.uniform(size=sci.shape) < masked / 4] = -1.0  # var <= 0 is invalid too
    return torch.as_tensor(sci, device=dev), torch.as_tensor(var, device=dev)


@pytest.mark.parametrize("psf", ["s1.0", "s1.4", "s2.0", "1x1", "3x5"])
@pytest.mark.parametrize("shape", [(3, 70, 45), (1, 33, 129)])
def test_k1_matches_twin(dev, psf, shape):
    sci, var = _stack(dev, *shape, seed=8)
    if psf.startswith("s"):
        k = PSF.make_gaussian_kernel(float(psf[1:]))
    elif psf == "1x1":
        k = np.ones((1, 1), np.float32)
    else:
        k = np.random.default_rng(2).uniform(0, 1, (3, 5)).astype(np.float32)
    k = torch.as_tensor(k, device=dev)
    launches = conv_kernel.psi_phi_conv.launches
    got = conv_kernel.psi_phi_conv(sci, var, k)
    ref = conv_kernel.psi_phi_conv_plain(sci, var, k)
    assert conv_kernel.psi_phi_conv.launches == launches + 1
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, equal_nan=True)


def _search_inputs(dev, T=7, H=45, W=61, C=23, seed=3):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 2.0, T))
    times[0] = 0.0
    valid = (rng.uniform(size=(T, H, W)) > 0.06).astype(np.uint8)
    psi = np.where(valid, rng.normal(0, 1, (T, H, W)), 0).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
    vxs = rng.uniform(-9, 9, C).astype(np.float32)
    vys = rng.uniform(-9, 9, C).astype(np.float32)
    vxs[[5, 17]] = vxs[2]  # exact ties with candidate 2
    vys[[5, 17]] = vys[2]
    dxs, dys = trajectory_offsets(vxs, vys, times)
    return [torch.as_tensor(a, device=dev) for a in (psi, phi, valid, dxs, dys)]


K2_CASES = {
    "full": dict(k_results=8),
    "k1": dict(k_results=1),
    "k64": dict(k_results=64, gate_min_obs=False),
    "reduced": dict(k_results=5, x_min=9, x_max=40, y_min=3, y_max=30),
    "extended": dict(k_results=6, x_min=-7, x_max=70, y_min=-5, y_max=52),
    "no_obs_gate": dict(k_results=4, gate_min_obs=False),
    "min_lh_gate": dict(k_results=3, gate_min_lh=True, min_lh=0.8),
    "unmasked": dict(k_results=4, has_masked=False),
    "offset": dict(k_results=4, cand_offset=1000),
}


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_matches_twin(dev, name):
    psi, phi, valid, dxs, dys = _search_inputs(dev)
    kw = dict(K2_CASES[name])
    min_lh = kw.pop("min_lh", 0.0)
    T, H, W = psi.shape
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
    if not kw.get("has_masked", True):
        valid = torch.ones_like(valid)
    args = (psi, phi, valid, dxs, dys, 3.0, min_lh)
    launches = search_kernel.search_topk.launches
    got = search_kernel.search_topk(*args, **kw)
    ref = search_kernel.search_topk_shift(*args, **kw)
    assert search_kernel.search_topk.launches == launches + 1
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


def test_k2_padding_and_ties(dev):
    psi, phi, valid, dxs, dys = _search_inputs(dev)
    T, H, W = psi.shape
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=23)
    plain = search_kernel.search_topk(psi, phi, valid, dxs, dys, 0.0, 0.0, **kw)
    cand_valid = torch.tensor([True] * len(dxs) + [False] * 3, device=dev)
    padded = search_kernel.search_topk(
        psi, phi, valid, torch.cat([dxs, dxs[:3] + 2]), torch.cat([dys, dys[:3]]), 0.0, 0.0,
        cand_valid=cand_valid, **kw,
    )
    assert torch.equal(padded[0], plain[0]) and torch.equal(padded[1], plain[1])
    idx = plain[1].cpu().numpy()
    for i in range(H):
        for j in range(W):
            tied = [v for v in idx[:, i, j] if v in (2, 5, 17)]
            assert tied == sorted(tied)


def test_k2_rejects_what_it_cannot_run(dev):
    psi, phi, valid, dxs, dys = _search_inputs(dev)
    T, H, W = psi.shape
    with pytest.raises(ValueError):
        search_kernel.search_topk(psi, phi, valid, dxs, dys, 0.0, 0.0,
                                  x_min=0, x_max=W, y_min=0, y_max=H, k_results=65)
    with pytest.raises(ValueError):
        search_kernel.search_topk(psi, phi, valid, dxs[:, :3], dys, 0.0, 0.0,
                                  x_min=0, x_max=W, y_min=0, y_max=H, k_results=2)


EM = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], dtype=np.float32)


def _encoded_inputs(dev, T, bits, H=37, W=53, C=21, seed=4, vmax=6.0):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if bits == 8 else np.uint16
    psi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    phi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    psi[rng.uniform(size=psi.shape) < 0.05] = 0
    phi[rng.uniform(size=phi.shape) < 0.05] = 0
    times = np.linspace(0.0, 2.0, T)
    vxs = rng.uniform(-vmax, vmax, C).astype(np.float32)
    vys = rng.uniform(-vmax / 3, vmax / 3, C).astype(np.float32)
    vxs[[5, 17]] = vxs[2]  # exact ties with candidate 2
    vys[[5, 17]] = vys[2]
    dxs, dys = trajectory_offsets(vxs, vys, times)
    em = EM if bits == 8 else np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32)
    planes = EncodedPlanes(torch.as_tensor(psi, device=dev), torch.as_tensor(phi, device=dev), em)
    return planes, dxs, dys


ENC_CASES = {
    "full": dict(k_results=8),
    "k1": dict(k_results=1),
    "k32": dict(k_results=32, gate_min_obs=False),
    "reduced": dict(k_results=5, x_min=9, x_max=40, y_min=3, y_max=30),
    "extended": dict(k_results=6, x_min=-7, x_max=62, y_min=-5, y_max=44),
    "min_lh_gate": dict(k_results=3, gate_min_lh=True, min_lh=0.8),
    "offset": dict(k_results=4, cand_offset=1000),
}


@pytest.mark.parametrize("name", sorted(ENC_CASES))
@pytest.mark.parametrize("kernel,bits,T", [("K3", 16, 7), ("K3", 8, 260), ("K4", 8, 7), ("K5", 8, 7), ("K5", 8, 300)])
def test_encoded_kernels_match_twin(dev, kernel, bits, T, name):
    planes, dxs, dys = _encoded_inputs(dev, T, bits)
    kw = dict(ENC_CASES[name])
    min_lh = kw.pop("min_lh", 0.0)
    _, H, W = planes.shape
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    args = (planes, dx, dy, 3.0, min_lh)
    if kernel == "K5":
        wrapper = search_encoded_kernel.search_grouped
        kw["plan"] = _plan_groups(dys, 8, 8)
    else:
        wrapper = search_encoded_kernel.search_paired if kernel == "K4" else search_encoded_kernel.search_encoded
    launches = wrapper.launches
    got = wrapper(*args, **kw)
    assert wrapper.launches == launches + 1
    kw.pop("plan", None)
    ref = search_encoded_kernel.search_topk_encoded_shift(
        planes.psi_codes, planes.phi_codes, dx, dy, 3.0, min_lh, planes.em, **kw
    )
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


def test_dispatcher_dedup_on_card(dev):
    """Dedup + expansion on the card equals the twin over all candidates."""
    planes, dxs, dys = _encoded_inputs(dev, 6, 8, vmax=0.8)
    _, H, W = planes.shape
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=6)
    got = search_topk_encoded(planes, dxs, dys, 2.0, 0.0, **kw)
    assert search_topk_encoded.last_route.startswith("dedup+")
    ref = search_encoded_kernel.search_topk_encoded_shift(
        planes.psi_codes, planes.phi_codes, dxs, dys, 2.0, 0.0, planes.em, **kw
    )
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


def test_encoded_kernels_reject_what_they_cannot_run(dev):
    planes, dxs, dys = _encoded_inputs(dev, 7, 8)
    _, H, W = planes.shape
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    with pytest.raises(ValueError):
        search_encoded_kernel.search_encoded(planes, dx, dy, 0.0, 0.0, k_results=65, **kw)
    with pytest.raises(ValueError):
        search_encoded_kernel.search_grouped(planes, dx, dy, 0.0, 0.0, k_results=2, plan=(np.arange(3), [0]), **kw)
    planes16, _, _ = _encoded_inputs(dev, 7, 16)
    with pytest.raises(ValueError):
        search_encoded_kernel.search_paired(planes16, dx, dy, 0.0, 0.0, k_results=2, **kw)
