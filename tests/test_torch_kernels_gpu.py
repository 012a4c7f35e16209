"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode). The file imports nothing of JAX, so it also runs
on a machine without it; tests/conftest.py does import JAX, so there run it
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: none. K1 bit-equal with equal NaN masks (kernel and twin take
the same rounded steps in the same order; the kernel's fused mask terms
round once where the twin's exact product and add do); K2-K5 indices equal
and lh bit-equal (the same float adds in the same order, or the same integer
sums and the decode rounded step by step, IEEE sqrt and division on both
sides); K6 exact int32 equality.
"""

import numpy as np
import pytest
import torch

from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.ops import conv_kernel, exactrow_kernel, search_encoded_kernel, search_kernel
from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.ops import search_plan
from kbmod_tpu_torch.ops.psi_phi import code_pair_views
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


def _psf(name):
    """s<sigma>: a Gaussian PSF (sigma 1.4: 9 x 9, 2.5: 15 x 15, 3.5: 21 x 21,
    the last past the templated sizes); AxB: random taps of both signs."""
    if name.startswith("s"):
        return PSF.make_gaussian_kernel(float(name[1:]))
    kh, kw = (int(v) for v in name.split("x"))
    return np.random.default_rng(kh * kw).uniform(-0.1, 1, (kh, kw)).astype(np.float32)


def _assert_k1_equal(got, ref):
    """Bit-equal: NaN masks equal and every finite value equal."""
    for g, r in zip(got, ref):
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(g[~nan], r[~nan])


@pytest.mark.parametrize("psf", ["s1.0", "s1.4", "s2.0", "s2.5", "s3.5", "1x1", "3x5", "4x4"])
@pytest.mark.parametrize("shape", [(3, 70, 45), (1, 33, 129), (2, 37, 130)])
def test_k1_matches_twin(dev, psf, shape):
    sci, var = _stack(dev, *shape, seed=8)
    k = torch.as_tensor(_psf(psf), device=dev)
    launches = conv_kernel.psi_phi_conv.launches
    got = conv_kernel.psi_phi_conv(sci, var, k)
    ref = conv_kernel.psi_phi_conv_plain(sci, var, k)
    assert conv_kernel.psi_phi_conv.launches == launches + 1
    _assert_k1_equal(got, ref)


@pytest.mark.parametrize("psf", ["s1.4", "s2.5", "3x5"])
def test_k1_masks_on_tile_edges_and_all_masked(dev, psf):
    """Masked rows and columns on the 64 x 16 tile's edges and the 32 x 8
    generic tile's, a masked 4-output group, then an image masked whole."""
    sci, var = _stack(dev, 2, 50, 150, seed=3, masked=0.01)
    for c in (0, 31, 32, 63, 64, 65, 127, 128, 149):
        sci[0, :, c] = float("nan")
    for r in (0, 7, 8, 15, 16, 31, 32, 49):
        var[1, r, :] = 0.0
    sci[1, 20:24, 40:44] = float("nan")
    k = torch.as_tensor(_psf(psf), device=dev)
    _assert_k1_equal(conv_kernel.psi_phi_conv(sci, var, k), conv_kernel.psi_phi_conv_plain(sci, var, k))
    sci[:] = float("nan")
    psi, phi = conv_kernel.psi_phi_conv(sci, var, k)
    assert bool(torch.isnan(psi).all()) and bool(torch.isnan(phi).all())


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


def _grouped_inputs(dev, T=9, H=40, W=300, C=29, seed=13, vx=8.0, dup=11):
    """Candidates whose rows move little, so the plan makes real groups; C
    not a multiple of 8; candidate 1 copied ``dup`` times, so its exact ties
    span two groups."""
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 2.0, T)
    valid = (rng.uniform(size=(T, H, W)) > 0.06).astype(np.uint8)
    psi = np.where(valid, rng.normal(0, 1, (T, H, W)), 0).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
    vxs = rng.uniform(-vx, vx, C).astype(np.float32)
    vys = rng.uniform(-1.5, 1.5, C).astype(np.float32)
    vxs[C - dup :], vys[C - dup :] = vxs[1], vys[1]
    dxs, dys = trajectory_offsets(vxs, vys, times)
    return [torch.as_tensor(a, device=dev) for a in (psi, phi, valid, dxs, dys)]


K2_GROUPED_CASES = {
    "groups": dict(k_results=8),
    "ties_across_groups": dict(k_results=32),
    "k64": dict(k_results=64, gate_min_obs=False),
    "unmasked": dict(k_results=8, has_masked=False),
    "negative_origins": dict(k_results=6, x_min=-37, x_max=250, y_min=-11, y_max=30),
    "wide_spread": dict(k_results=8, vx=120.0),
}


@pytest.mark.parametrize("name", sorted(K2_GROUPED_CASES))
def test_k2_grouped_cases_match_twin(dev, name):
    kw = dict(K2_GROUPED_CASES[name])
    psi, phi, valid, dxs, dys = _grouped_inputs(dev, vx=kw.pop("vx", 8.0))
    T, H, W = psi.shape
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
    if not kw.get("has_masked", True):
        valid = torch.ones_like(valid)
    plan, _ = search_plan.grouped_plan(dys.cpu().numpy())
    assert len(plan[1]) < len(dxs), "the plan made no group of two"
    args = (psi, phi, valid, dxs, dys, 2.0, 0.0)
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
    "k64": dict(k_results=64),
    "reduced": dict(k_results=5, x_min=9, x_max=40, y_min=3, y_max=30),
    "extended": dict(k_results=6, x_min=-7, x_max=62, y_min=-5, y_max=44),
    "min_lh_gate": dict(k_results=3, gate_min_lh=True, min_lh=0.8),
    "offset": dict(k_results=4, cand_offset=1000),
}


@pytest.mark.parametrize("name", sorted(ENC_CASES))
@pytest.mark.parametrize(
    "kernel,bits,T",
    [("K3", 16, 7), ("K3", 16, 300), ("K3", 8, 260), ("K4", 8, 7), ("K4", 8, 257), ("K5", 8, 7), ("K5", 8, 257),
     ("K5", 8, 258), ("K5", 8, 300)],
)
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


def test_k5_odd_shifts_and_spread(dev):
    """K5 where members' columns differ by odd amounts (each word a funnel
    shift of two) and spread far (one slab per member)."""
    planes, dxs, dys = _encoded_inputs(dev, 9, 8, W=301, vmax=60.0)
    assert (dxs % 2 == 1).any()
    _, H, W = planes.shape
    plan = _plan_groups(dys, 8, 8)
    assert len(plan[1]) < len(dxs)
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    for K in (8, 32, 64):
        kw = dict(x_min=-3, x_max=W, y_min=0, y_max=H, k_results=K)
        got = search_encoded_kernel.search_grouped(planes, dx, dy, 2.0, 0.0, plan=plan, **kw)
        ref = search_encoded_kernel.search_topk_encoded_shift(
            planes.psi_codes, planes.phi_codes, dx, dy, 2.0, 0.0, planes.em, **kw
        )
        assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.parametrize("K", [1, 8, 32, 64])
def test_k4_spread_odd_shifts_and_edges(dev, K):
    """K4 where the candidates spread far in columns (one slab per member),
    shift by odd columns (each word a funnel shift of two) and the window
    reaches past all four edges of the image; C = 21, so the last batch is
    partial."""
    planes, dxs, dys = _encoded_inputs(dev, 9, 8, W=301, vmax=60.0)
    assert (dxs % 2 == 1).any()
    lay = search_encoded_kernel.k4_staging(dxs, dys, -5, -4)["lay"]
    assert (lay[..., 0] > 1).any(), "no step staged one slab per member"
    _, H, W = planes.shape
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    kw = dict(x_min=-5, x_max=W + 7, y_min=-4, y_max=H + 3, k_results=K, gate_min_obs=False)
    launches = search_encoded_kernel.search_paired.launches
    got = search_encoded_kernel.search_paired(planes, dx, dy, 0.0, 0.0, **kw)
    assert search_encoded_kernel.search_paired.launches == launches + 1
    ref = search_encoded_kernel.search_topk_encoded_shift(
        planes.psi_codes, planes.phi_codes, dx, dy, 0.0, 0.0, planes.em, **kw
    )
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


def _k3_grouped_inputs(dev, bits, T=9, H=23, W=301, C=29, vx=8.0, dup=11, seed=21):
    """Codes and candidates whose rows move little, so the plan makes real
    groups; C not a multiple of 8; candidate 1 copied ``dup`` times, so its
    exact ties span two groups."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if bits == 8 else np.uint16
    psi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    phi = rng.integers(1, 1 << bits, (T, H, W)).astype(dtype)
    psi[rng.uniform(size=psi.shape) < 0.05] = 0
    phi[rng.uniform(size=phi.shape) < 0.05] = 0
    vxs = rng.uniform(-vx, vx, C).astype(np.float32)
    vys = rng.uniform(-1.5, 1.5, C).astype(np.float32)
    vxs[C - dup :], vys[C - dup :] = vxs[1], vys[1]
    dxs, dys = trajectory_offsets(vxs, vys, np.linspace(0.0, 2.0, T))
    em = EM if bits == 8 else np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32)
    planes = EncodedPlanes(torch.as_tensor(psi, device=dev), torch.as_tensor(phi, device=dev), em)
    return planes, dxs, dys


K3_GROUPED_CASES = {
    "groups": dict(k_results=8),
    "ties_across_groups": dict(k_results=32),
    "k64": dict(k_results=64, gate_min_obs=False),
    "wide_spread": dict(k_results=8, vx=300.0),
    "padding": dict(k_results=8, pad=5),
    "negative_origins": dict(k_results=6, x_min=-37, x_max=250, y_min=-11, y_max=20),
    "far_right": dict(k_results=4, x_min=150, x_max=330, y_min=3, y_max=30),
}


@pytest.mark.parametrize("name", sorted(K3_GROUPED_CASES))
@pytest.mark.parametrize("bits", [16, 8])
def test_k3_grouped_cases_match_twin(dev, bits, name):
    kw = dict(K3_GROUPED_CASES[name])
    planes, dxs, dys = _k3_grouped_inputs(dev, bits, vx=kw.pop("vx", 8.0))
    pad = kw.pop("pad", 0)
    T, H, W = planes.shape
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
    plan, _ = search_plan.grouped_plan(dys)
    assert len(plan[1]) < len(dxs), "the plan made no group of two"
    if name == "wide_spread":
        lay = search_encoded_kernel.k3_staging(dxs, dys, 0, 0, bits)["lay"]
        assert (lay[..., 0] > 1).any(), "no step staged one slab per member"
    if pad:
        dxs, dys = np.concatenate([dxs, dxs[:pad] + 1]), np.concatenate([dys, dys[:pad] - 1])
        kw["cand_valid"] = torch.tensor([True] * (len(dxs) - pad) + [False] * pad, device=dev)
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    launches = search_encoded_kernel.search_encoded.launches
    got = search_encoded_kernel.search_encoded(planes, dx, dy, 2.0, 0.0, **kw)
    assert search_encoded_kernel.search_encoded.launches == launches + 1
    ref = search_encoded_kernel.search_topk_encoded_shift(
        planes.psi_codes, planes.phi_codes, dx, dy, 2.0, 0.0, planes.em, **kw
    )
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.parametrize("kernel,T", [("K2", 1000), ("K5", 1500), ("K3", 1000)])
def test_long_stacks_match_twin(dev, kernel, T):
    """Past the T at which the grouped kernels' tables used to outgrow
    shared memory: the tables are reloaded every 63 steps."""
    if kernel == "K2":
        psi, phi, valid, dxs, dys = _search_inputs(dev, T=T, H=20, W=40)
        kw = dict(x_min=-3, x_max=37, y_min=0, y_max=20, k_results=8)
        args = (psi, phi, valid, dxs, dys, float(T // 3), 0.0)
        got = search_kernel.search_topk(*args, **kw)
        ref = search_kernel.search_topk_shift(*args, **kw)
    else:
        planes, dxs, dys = _encoded_inputs(dev, T, 8 if kernel == "K5" else 16, H=20, W=40)
        kw = dict(x_min=-3, x_max=37, y_min=0, y_max=20, k_results=8)
        dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
        if kernel == "K5":
            got = search_encoded_kernel.search_grouped(planes, dx, dy, float(T // 3), 0.0,
                                                       plan=search_plan.grouped_plan(dys)[0], **kw)
        else:
            got = search_encoded_kernel.search_encoded(planes, dx, dy, float(T // 3), 0.0, **kw)
        ref = search_encoded_kernel.search_topk_encoded_shift(
            planes.psi_codes, planes.phi_codes, dx, dy, float(T // 3), 0.0, planes.em, **kw
        )
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.parametrize("bits", [16, 8])
def test_k3_raises_past_its_t_limit(dev, bits):
    T = search_encoded_kernel.K3_MAX_T[bits] + 1
    dtype = torch.uint16 if bits == 16 else torch.uint8
    pairs = torch.zeros((T, 2, 8, 2), dtype=dtype, device=dev)
    planes = EncodedPlanes(*code_pair_views(pairs, 8), EM, pairs)
    zeros = torch.zeros((1, T), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="above the kernel"):
        search_encoded_kernel.search_encoded(planes, zeros, zeros, 0.0, 0.0, x_min=0, x_max=8, y_min=0, y_max=2,
                                             k_results=1)


K6_DRAWS = ["script", "wrap"]


@pytest.mark.parametrize("mode", ["A", "B", "C"])
@pytest.mark.parametrize("draw", K6_DRAWS)
def test_k6_matches_twin(dev, draw, mode):
    from kbmod_tpu_torch.scripts.exactrow_microbench import make_inputs

    tbl, buf = make_inputs(device=dev)
    if draw == "wrap":
        rng = np.random.default_rng(9)
        rows, W4 = buf.shape
        T, SL = tbl.shape[1] // 3, 40
        tbl = torch.as_tensor(
            np.concatenate([rng.integers(0, SL, (64, T)), rng.integers(0, rows - SL + 1, (64, T)),
                            rng.integers(0, 3 * W4, (64, T))], axis=1).astype(np.int32),
            device=dev,
        )
    launches = exactrow_kernel.exactrow_accumulate.launches
    got = exactrow_kernel.exactrow_accumulate(tbl, buf, mode, 8, 32)
    assert exactrow_kernel.exactrow_accumulate.launches == launches + 1
    ref = exactrow_kernel.exactrow_accumulate_plain(tbl, buf, mode, 8, 32)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["A", "B", "C"])
@pytest.mark.parametrize("th,w4", [(7, 601), (5, 13), (33, 1030)])
def test_k6_groups_and_ragged_tiles(dev, th, w4, mode):
    """K6 in every mode with G = 1..8, rows and words that are not multiples
    of the tile (4 x 512), a row narrower than one staged run (13 words, so
    the lane roll wraps more than once) and wrap-around tables."""
    rng = np.random.default_rng(th * w4)
    T, ng, rows = 5, 11, 2 * (th + 16)
    SL = th + 8
    buf = torch.as_tensor(rng.integers(-(2**31), 2**31 - 1, (rows, w4), dtype=np.int64).astype(np.int32), device=dev)
    tbl = torch.as_tensor(
        np.concatenate([rng.integers(0, SL, (ng, T)), rng.integers(0, rows - SL + 1, (ng, T)),
                        rng.integers(-3 * w4, 3 * w4, (ng, T))], axis=1).astype(np.int32),
        device=dev,
    )
    for group in range(1, 9):
        got = exactrow_kernel.exactrow_accumulate(tbl, buf, mode, group, th)
        ref = exactrow_kernel.exactrow_accumulate_plain(tbl, buf, mode, group, th)
        assert torch.equal(got, ref), group


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
