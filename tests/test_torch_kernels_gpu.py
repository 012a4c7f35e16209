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
    with pytest.raises(ValueError, match="bytes"):  # maps larger than the card
        search_kernel.search_topk(psi, phi, valid, dxs, dys, 0.0, 0.0,
                                  x_min=0, x_max=W, y_min=0, y_max=H, k_results=10**9)
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
    with pytest.raises(ValueError, match="bytes"):  # maps larger than the card
        search_encoded_kernel.search_encoded(planes, dx, dy, 0.0, 0.0, k_results=10**9, **kw)
    with pytest.raises(ValueError):
        search_encoded_kernel.search_grouped(planes, dx, dy, 0.0, 0.0, k_results=2, plan=(np.arange(3), [0]), **kw)
    planes16, _, _ = _encoded_inputs(dev, 7, 16)
    with pytest.raises(ValueError):
        search_encoded_kernel.search_paired(planes16, dx, dy, 0.0, 0.0, k_results=2, **kw)


# Lists longer than 64 stay in the maps (kMapList): K2-K5 at K = 65, 100
# and 128 over 150-200 candidates, so lists fill and entries leave them.
K_MAP_CASES = {
    "k65": dict(k_results=65),
    "k100_min_lh": dict(k_results=100, gate_min_lh=True, min_lh=-2.0),
    "k128": dict(k_results=128),
    "k128_no_obs_gate_extended": dict(k_results=128, gate_min_obs=False, x_min=-5, x_max=40, y_min=-3, y_max=30),
}


@pytest.mark.parametrize("name", sorted(K_MAP_CASES))
@pytest.mark.parametrize("kernel,bits", [("K2", 32), ("K3", 16), ("K3", 8), ("K4", 8), ("K5", 8)])
def test_long_lists_match_twin(dev, kernel, bits, name):
    kw = dict(K_MAP_CASES[name])
    min_lh = kw.pop("min_lh", 0.0)
    if kernel == "K2":
        psi, phi, valid, dxs, dys = _grouped_inputs(dev, H=33, W=41, C=200, dup=5)
        T, H, W = psi.shape
        kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
        args = (psi, phi, valid, dxs, dys, 2.0, min_lh)
        wrapper, twin = search_kernel.search_topk, search_kernel.search_topk_shift
        twin_args = args
    else:
        planes, dxs, dys = _encoded_inputs(dev, 9, bits, H=33, W=41, C=150)
        _, H, W = planes.shape
        kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H), **kw)
        dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
        args = (planes, dx, dy, 2.0, min_lh)
        twin_args = (planes.psi_codes, planes.phi_codes, dx, dy, 2.0, min_lh, planes.em)
        twin = search_encoded_kernel.search_topk_encoded_shift
        wrapper = {"K3": search_encoded_kernel.search_encoded, "K4": search_encoded_kernel.search_paired,
                   "K5": search_encoded_kernel.search_grouped}[kernel]
    extra = dict(plan=_plan_groups(dys, 8, 8)) if kernel == "K5" else {}
    launches = wrapper.launches
    got = wrapper(*args, **kw, **extra)
    assert wrapper.launches == launches + 1
    ref = twin(*twin_args, **kw)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])
    assert int((ref[1][-1] >= 0).sum()) > 0, "no list filled to its last slot"


def test_batched_coadds_on_card_equal_cpu(dev):
    """The coadds reduced on the card equal the CPU run: sum, median and the
    stamp cube exact, mean and weighted within 1e-6 relative."""
    from kbmod_tpu_torch.ops.stamps import batched_coadds

    rng = np.random.default_rng(21)
    T, H, W, R = 9, 60, 70, 300
    sci = rng.normal(0, 3, (T, H, W)).astype(np.float32)
    var = rng.uniform(0.5, 2, (T, H, W)).astype(np.float32)
    sci[rng.uniform(size=sci.shape) < 0.05] = np.nan
    var[rng.uniform(size=sci.shape) < 0.02] = 0.0
    times = np.linspace(0.0, 2.0, T)
    xs, ys = rng.integers(-6, W + 6, R), rng.integers(-6, H + 6, R)
    vx, vy = rng.normal(0, 4, R), rng.normal(0, 4, R)
    valid = rng.uniform(size=(R, T)) < 0.75
    kinds = ["sum", "mean", "median", "weighted", "all_stamps"]
    args = (list(sci), list(var), times, xs, ys, vx, vy, 6, kinds)
    got = batched_coadds(*args, obs_valid=valid, device=dev)
    ref = batched_coadds(*args, obs_valid=valid, device="cpu")
    for kind in kinds:
        if kind in ("mean", "weighted"):
            np.testing.assert_allclose(got[kind], ref[kind], rtol=1e-6, atol=0, err_msg=kind)
        else:
            np.testing.assert_array_equal(got[kind], ref[kind], err_msg=kind)


@pytest.mark.parametrize("num_bytes,gpu_filter", [(-1, False), (1, True)], ids=["float-host-sigmag", "u8-gpu-filter"])
def test_search_runner_on_card_equals_cpu(dev, tmp_path, monkeypatch, num_bytes, gpu_filter):
    """A small SearchRunner run on the card equals the CPU run: rows exact,
    lh bit-equal (every kernel equals its twin, the gathers and the host
    stages are the same arithmetic). K1's plain twin on the CPU may round a
    psi/phi value an ulp or two away from K1 (and itself) on the card, which
    moves a uint8 code by at most one: that is checked (and counted) first,
    and then both runs search the CPU build's planes, handed over where the
    runner builds its StackSearch."""
    import kbmod_tpu_torch.run_search as run_search
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.ops.psi_phi import psi_phi_array_from_numpy
    from kbmod_tpu_torch.search import StackSearch, Trajectory

    times = create_fake_times(10, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)

    def stack():
        ds = FakeDataSet(96, 80, times, psf_val=1.2, mask_fraction=0.03, use_seed=17)
        ds.insert_object(Trajectory(x=40, y=33, vx=4.0, vy=-1.5, flux=250.0))
        return ds.stack_py

    st = stack()
    cpu = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, num_bytes, device="cpu").psi_phi_array
    card = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, num_bytes, device=dev).psi_phi_array
    if num_bytes == -1:
        for a, b in zip(card.decoded_psi_phi()[:2], cpu.decoded_psi_phi()[:2]):
            a, b = a.cpu().numpy(), b.numpy()
            ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
            print(f"float build, card against CPU: {int((ulps > 0).sum())} of {a.size} values differ, "
                  f"at most {int(ulps.max())} ulp")
            assert np.all(np.sign(a) == np.sign(b)) and ulps.max() <= 2
        assert torch.equal(card.valid.cpu(), cpu.valid)
    else:
        for a, b in ((card.psi, cpu.psi), (card.phi, cpu.phi)):
            d = (a.cpu().to(torch.int32) - b.to(torch.int32)).abs()
            print(f"uint8 build, card against CPU: {int((d > 0).sum())} of {d.numel()} codes differ")
            assert int(d.max()) <= 1
    valid = None if num_bytes in (1, 2) else cpu.valid.numpy()
    planes = (cpu.psi.numpy(), cpu.phi.numpy(), valid, cpu.times, cpu.meta)

    class HandedOver(StackSearch):
        def __init__(self, *args, device=None):
            super().__init__(*args, device=device)
            self.psi_phi_array = psi_phi_array_from_numpy(*planes, device=self.device)

    monkeypatch.setattr(run_search, "StackSearch", HandedOver)
    tables = []
    for where in (dev, "cpu"):
        config = SearchConfiguration(dict(
            generator_config={"name": "KBMODV1SearchConfig", "v_arr": [2.0, 6.0, 7], "ang_arr": [0.6, 0.2, 7],
                              "average_angle": 0.0},
            encode_num_bytes=num_bytes, gpu_filter=gpu_filter, num_obs=5, lh_level=3.0, near_dup_thresh=3,
            cluster_eps=1.5, coadds=["mean", "median"], save_config=False,
            result_filename=str(tmp_path / f"{'card' if where is dev else 'cpu'}.ecsv"),
        ))
        tables.append(run_search.SearchRunner(device=where).run_search(config, stack()))
    got, ref = tables
    assert len(got) == len(ref) > 0
    for k in ("x", "y", "vx", "vy", "obs_count", "likelihood", "flux", "obs_valid", "psi_curve", "phi_curve",
              "coadd_sum", "coadd_median"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["coadd_mean"], ref["coadd_mean"], rtol=1e-6)


def test_exact_sigmag_on_card_equals_cpu(dev, monkeypatch):
    """KB_SIGMAG_MODE=exact on the card against the port's CPU run of the
    same crop. The maps: indices equal except where two candidates' clipped
    lh tie within the tolerance, lh within 1e-5 * max(1, |lh|) (ROADMAP
    Queue 3; the curves' sums run in another order on the card). The
    ``StackSearch`` rows: equal, lh and flux bit for bit (the assembly
    re-scores the same gathered samples on the host)."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.ops import search as ops
    from kbmod_tpu_torch.search import StackSearch, Trajectory
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    rng = np.random.default_rng(31)
    T, H, W, C, K = 12, 24, 40, 30, 4
    valid = (rng.uniform(size=(T, H, W)) > 0.05).astype(np.uint8)
    psi = rng.normal(1.0, 0.5, (T, H, W))
    hit = rng.random((T, H, W)) < 0.05
    psi[hit] = rng.choice([-30.0, 30.0], int(hit.sum()))
    psi = np.where(valid, psi, 0).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
    dxs, dys = trajectory_offsets(rng.uniform(-3, 3, C), rng.uniform(-3, 3, C), np.arange(T) * 0.3)
    kw = dict(x_min=-2, x_max=W, y_min=0, y_max=H, k_results=K, sgl_L=0.25, sgl_H=0.75, row_tile=7)
    out = {}
    for where in (dev, torch.device("cpu")):
        planes = [torch.as_tensor(a, device=where) for a in (psi, phi, valid)]
        out[where.type] = [a.cpu().numpy() for a in ops.search_topk_sigmag_exact(*planes, dxs, dys, 4.0, 0.5, 0.7413,
                                                                                  **kw)]
        own = [ops.search_topk_sigmag_exact(*planes, dxs[c:c + 1], dys[c:c + 1], 4.0, 0.5, 0.7413,
                                            **dict(kw, k_results=1))[0][0].cpu().numpy() for c in range(C)]
        out[where.type + "_own"] = own
    (g_lh, g_idx), (r_lh, r_idx) = out["cuda"], out["cpu"]
    bound = 1e-5 * np.maximum(1.0, np.abs(r_lh))
    assert np.array_equal(g_idx < 0, r_idx < 0) and (g_idx >= 0).sum() > 0.5 * g_idx.size
    same = g_idx == r_idx
    assert np.all(np.abs(g_lh[same & (g_idx >= 0)] - r_lh[same & (g_idx >= 0)]) <= bound[same & (g_idx >= 0)])
    for k, i, j in np.argwhere(~same):
        a, b = g_idx[k, i, j], r_idx[k, i, j]
        assert abs(out["cpu_own"][a][i, j] - out["cpu_own"][b][i, j]) <= 2 * bound[k, i, j]

    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
    times = create_fake_times(10, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(64, 48, times, psf_val=1.2, mask_fraction=0.03, use_seed=19)
    ds.insert_object(Trajectory(x=30, y=20, vx=4.0, vy=-1.5, flux=250.0))
    st = ds.stack_py
    rows = []
    for where in (dev, "cpu"):
        s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, -1, device="cpu")
        if where is dev:
            s = _on_card(s, dev)
        s.set_results_per_pixel(2)
        s.set_min_obs(5)
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 3.0)
        s.search_all(list(KBMODV1Search(5, 2.0, 6.0, 5, -0.6, 0.2)), True)
        rows.append(s.results.get_arrays())
    for k in ("x", "y", "vx", "vy", "obs_count", "lh", "flux"):
        np.testing.assert_array_equal(rows[0][k], rows[1][k], err_msg=k)


def _on_card(search, dev):
    """A CPU-built float StackSearch with its planes moved to the card (both
    runs search the same planes)."""
    from kbmod_tpu_torch.ops.psi_phi import psi_phi_array_from_numpy

    arr = search.psi_phi_array
    search.device = dev
    search.psi_phi_array = psi_phi_array_from_numpy(
        arr.psi.numpy(), arr.phi.numpy(), arr.valid.numpy(), arr.times, arr.meta, device=dev)
    return search


@pytest.mark.parametrize("model_type", ["resnet18", "resnet50"])
def test_cnn_logits_on_card_equal_cpu(dev, model_type):
    """The classifier's logits on the card (cuDNN convolutions in float32,
    TF32 off) against the CPU run of the same seeded weights: within 1e-4 *
    (1 + max |logit|) (the convolutions sum in another order); the class
    equal wherever the two logits differ by more than that."""
    from kbmod_tpu_torch.models.cnn import StampClassifier

    stamps = np.random.default_rng(3).normal(size=(64, 21, 21)).astype(np.float32)
    got = StampClassifier(model_type, 21, seed=4, device=dev).predict(stamps)
    want = StampClassifier(model_type, 21, seed=4, device="cpu").predict(stamps)
    tol = 1e-4 * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    clear = np.abs(want[:, 1] - want[:, 0]) > tol
    np.testing.assert_array_equal(got.argmax(axis=1)[clear], want.argmax(axis=1)[clear])


def test_snapped_u8_search_k5_equals_twin(dev, monkeypatch):
    """The uint8 search under KB_SNAP_ROW_ERROR goes through K5 (the snapped
    rows fill the grouping plan), K5 bit-equal to its twin on the snapped
    offsets, and the object found with a vy on the lattice."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.ops.search import snap_vy_rows
    from kbmod_tpu_torch.ops.search_encoded import encoded_route
    from kbmod_tpu_torch.ops.search_plan import _dedup_plan_cached
    from kbmod_tpu_torch.search import StackSearch, Trajectory
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    monkeypatch.setenv("KB_SNAP_ROW_ERROR", "0.75")
    times = create_fake_times(12, 57130.2, 4, 0.02, 1)
    ds = FakeDataSet(64, 64, times, use_seed=77, psf_val=1.4)
    ds.insert_object(Trajectory(x=12, y=15, vx=14.0, vy=9.0, flux=400.0))
    st = ds.stack_py
    cands = list(KBMODV1Search(15, 10.0, 20.0, 15, 0.3, 0.9))
    s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, 1, device=dev)
    s.set_min_obs(8)
    launches = search_encoded_kernel.search_grouped.launches
    s.search_all(cands, True)
    assert search_encoded_kernel.search_grouped.launches > launches
    assert "grouped" in search_topk_encoded.last_route
    best = s.get_results(0, 1)[0]
    q = 2 * 0.75 / float(np.max(st.zeroed_times))
    assert (best.x, best.y) == (12, 15) and abs(best.vy / q - round(best.vy / q)) < 1e-3

    vxs = np.array([c.vx for c in cands], np.float32)
    vys, _ = snap_vy_rows(np.array([c.vy for c in cands], np.float32), st.zeroed_times, 0.75)
    dxs, dys = trajectory_offsets(vxs, vys, st.zeroed_times)
    dedup = _dedup_plan_cached(dxs, dys, 1.1)
    if dedup is not None:
        dxs, dys = dedup[0], dedup[1]
    planes = s._eval_planes()[0]
    route, plan = encoded_route(planes.psi_codes.dtype, len(st.zeroed_times), dys)
    assert route == "grouped"
    args = (torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev), 8.0, 0.0)
    kw = dict(x_min=0, x_max=64, y_min=0, y_max=64, k_results=8)
    got = search_encoded_kernel.search_grouped(planes, *args, plan=plan, **kw)
    ref = search_encoded_kernel.search_topk_encoded_shift(planes.psi_codes, planes.phi_codes, *args, planes.em, **kw)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


def _grid_stack(dev, num_bytes, seed=77):
    """A 12 x 64 x 64 fake stack with one object, its grid, and a search of
    it on ``dev``."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import StackSearch, Trajectory
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    times = create_fake_times(12, 57130.2, 4, 0.02, 1)
    ds = FakeDataSet(64, 64, times, use_seed=seed, psf_val=1.4, mask_fraction=0.02)
    ds.insert_object(Trajectory(x=12, y=15, vx=14.0, vy=9.0, flux=400.0))
    st = ds.stack_py
    cands = list(KBMODV1Search(9, 10.0, 20.0, 9, 0.3, 0.9))
    s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, num_bytes, device=dev)
    s.set_min_obs(8)
    return st, cands, s


@pytest.mark.parametrize("shard_mode", ["candidates", "pixels"])
@pytest.mark.parametrize("num_bytes", [-1, 1], ids=["float-K2", "u8-K5"])
def test_two_shards_on_one_card_equal_one_device(dev, num_bytes, shard_mode):
    """Two shards on one card (the planes held once): the merged or
    concatenated maps equal the one-device search bit for bit, each shard
    through its kernel (K2, or the dispatcher's K5 with a plan per shard)."""
    from kbmod_tpu_torch.ops.search import _local_topk
    from kbmod_tpu_torch.parallel import build_mesh, sharded_search_topk

    st, cands, s = _grid_stack(dev, num_bytes)
    planes = s._eval_planes()
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, st.zeroed_times)
    kw = dict(x_min=0, x_max=64, y_min=0, y_max=64, k_results=8, gate_min_obs=True, gate_min_lh=False)
    has_masked = num_bytes == -1 and bool(torch.min(planes[2]) == 0)
    one = _local_topk(*planes, dxs, dys, sigmag_mode="", min_obs=8.0, min_lh=0.0, sgl_L=0.25, sgl_H=0.75,
                      sigmag_coeff=1.0, has_masked=has_masked, **kw)
    kernel = search_kernel.search_topk if num_bytes == -1 else search_encoded_kernel.search_grouped
    before = kernel.launches
    got = sharded_search_topk(*planes, dxs, dys, build_mesh(devices=[dev, dev]), min_obs=8.0, min_lh=0.0,
                              shard_mode=shard_mode, has_masked=has_masked, **kw)
    assert torch.equal(got[1], one[1]) and torch.equal(got[0], one[0])
    if num_bytes == -1 or shard_mode == "candidates":
        assert kernel.launches == before + 2


@pytest.mark.parametrize("num_bytes", [-1, 1], ids=["float", "u8"])
def test_time_mode_on_card_equals_cpu(dev, num_bytes):
    """Time mode (plain PyTorch partial sums over candidate chunks, two
    shards) on the card equals the same on the CPU bit for bit."""
    from kbmod_tpu_torch.parallel import build_mesh, sharded_search_topk
    from kbmod_tpu_torch.parallel.sharded import _planes_on

    st, cands, s = _grid_stack(dev, num_bytes)
    planes = s._eval_planes()
    vxs = np.array([c.vx for c in cands[:20]], np.float32)
    vys = np.array([c.vy for c in cands[:20]], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, st.zeroed_times)
    kw = dict(x_min=0, x_max=64, y_min=8, y_max=24, k_results=4, min_obs=8.0, shard_mode="time")
    got = sharded_search_topk(*planes, dxs, dys, build_mesh(devices=[dev, dev]), **kw)
    cpu = torch.device("cpu")
    ref = sharded_search_topk(*_planes_on(*planes, cpu), dxs, dys, build_mesh(devices=[cpu, cpu]), **kw)
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[0].cpu(), ref[0])


def test_sharded_psi_phi_build_on_card(dev):
    """K1 once a shard over two time slices on one card: equal to one K1
    launch over the whole stack (NaN masks and every finite value)."""
    from kbmod_tpu_torch.parallel import build_mesh, sharded_psi_phi_build

    sci, var = _stack(dev, 9, 70, 90, seed=4)
    psf = PSF.make_gaussian_kernel(1.4)
    before = conv_kernel.psi_phi_conv.launches
    psi, phi, valid = sharded_psi_phi_build(sci.cpu().numpy(), var.cpu().numpy(), psf, build_mesh(devices=[dev, dev]))
    assert conv_kernel.psi_phi_conv.launches == before + 2
    ref_psi, ref_phi = conv_kernel.psi_phi_conv(sci, var, torch.as_tensor(psf, device=dev))
    ok = torch.isfinite(ref_psi) & torch.isfinite(ref_phi)
    assert torch.equal(valid.bool(), ok)
    assert torch.equal(psi[ok], ref_psi[ok]) and torch.equal(phi[ok], ref_phi[ok])


def test_checkpointed_k5_search_on_card(dev, tmp_path):
    """The uint8 search checkpointed in row tiles on the card: K5 per tile,
    bit-equal to the un-tiled search; a resume loads every tile and
    launches nothing."""
    _, cands, s = _grid_stack(dev, 1)
    s.search_all(cands, True)
    plain = s.results.get_arrays()
    s.enable_search_checkpointing(str(tmp_path / "ck"), tile_rows=24)
    before = search_encoded_kernel.search_grouped.launches
    s.search_all(cands, True)
    assert search_encoded_kernel.search_grouped.launches == before + 3
    assert s.timings["tiles_loaded"] == 0
    tiled = s.results.get_arrays()
    s.search_all(cands, True)
    assert s.timings["tiles_loaded"] == 3 and search_encoded_kernel.search_grouped.launches == before + 3
    for key in plain:
        assert np.array_equal(tiled[key], plain[key]) and np.array_equal(s.results.get_arrays()[key], plain[key])
