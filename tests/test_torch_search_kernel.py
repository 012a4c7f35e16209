"""Port parity: K2's plain twin ``search_topk_shift`` against the JAX
package's ``search_topk_shift`` (XLA) and ``search_topk_pallas`` (interpret
mode) on the CPU, on the cases of tests/test_search_pallas.py.

Tolerances: both sides' lh are held to a float64 reference. Each kept
slot's lh is recomputed in float64 from the same samples (sum of psi over
the square root of the sum of phi), and the twin's lh must lie within the
float32 rounding of a sequential sum of T terms plus one rounding each for
the sqrt and the division:

    |lh32 - lh64| <= (T + 1) * u * sum|psi_t| / sqrt(sum phi_t) + 2 * u * |lh64|,  u = 2**-24.

The JAX side gets that bound plus 2 ulps of lh64: its decode note allows 1
(kbmod_tpu/ops/search.py:129-132), and it may compute lh through an rsqrt
(one more rounding; the Pallas kernel multiplies by one). A bound of ulps
between the two sides would hold the twin to XLA's own rounding, which
varies with the host CPU. The twin's lh is IEEE float32 arithmetic
(``test_twin_lh_is_ieee``). Indices are equal except at slots where the
two candidates' own lh tie within the sum of their bounds. Where the
reference's lh ties exactly, its bubble insertion reverses equal entries
and the rank-insert keeps arrival order, so such slots may hold other
indices.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbmod_tpu.ops.psi_phi import PsiPhiArray, fill_psi_phi_array
from kbmod_tpu.ops.search import search_topk_shift, trajectory_offsets
from kbmod_tpu.ops.search_pallas import search_topk_pallas

from kbmod_tpu_torch.ops import search_kernel

@pytest.fixture(scope="module")
def data():
    """The stack of tests/test_search_pallas.py."""
    rng = np.random.default_rng(99)
    T, H, W = 5, 40, 48
    times = np.arange(T) * 0.35
    psi = [rng.normal(0, 1, (H, W)).astype(np.float32) for _ in range(T)]
    phi = [rng.uniform(0.5, 2.0, (H, W)).astype(np.float32) for _ in range(T)]
    for t in range(T):
        bad = rng.uniform(size=(H, W)) < 0.07
        psi[t][bad] = np.nan
        phi[t][bad] = np.nan
    arr = PsiPhiArray()
    fill_psi_phi_array(arr, -1, psi, phi, times)
    psi_z, phi_z, valid = (np.asarray(a) for a in arr.decoded_psi_phi())
    vxs = np.array([0.0, 2.5, -3.0, 5.3, 1.7, -0.8], dtype=np.float32)
    vys = np.array([0.0, -2.0, 3.5, 1.4, -4.1, 2.2], dtype=np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, times)
    return psi_z, phi_z, valid, dxs, dys, (T, H, W)


def _twin(psi, phi, valid, dxs, dys, min_obs, min_lh, **kw):
    lh, idx = search_kernel.search_topk(
        torch.as_tensor(psi), torch.as_tensor(phi), torch.as_tensor(valid),
        torch.as_tensor(dxs), torch.as_tensor(dys), min_obs, min_lh, **kw,
    )
    return lh.numpy(), idx.numpy()


def _jax(fn, psi, phi, valid, dxs, dys, min_obs, min_lh, **kw):
    lh, idx = fn(
        jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(valid), jnp.asarray(dxs), jnp.asarray(dys),
        jnp.float32(min_obs), jnp.float32(min_lh), **kw,
    )
    return np.asarray(lh), np.asarray(idx)


U = 2.0 ** -24


def f64_lh(psi, phi, valid, dxs, dys, x_min, x_max, y_min, y_max):
    """Each candidate's lh recomputed in float64 from the float32 samples
    at every start pixel of the window, and the twin's float32 bound
    around it: (T + 1) u sum|psi| / sqrt(sum phi) + 2 u |lh64|. Returns
    (lh64, bound), each (C, SH, SW); lh is -1 where no phi was summed."""
    T, H, W = psi.shape
    ii, jj = np.mgrid[y_min:y_max, x_min:x_max]
    C = len(dxs)
    ps, pa, ph = (np.zeros((C,) + ii.shape) for _ in range(3))
    for t in range(T):
        y = ii[None] + dys[:, t, None, None]
        x = jj[None] + dxs[:, t, None, None]
        ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        yc, xc = np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)
        ok &= valid[t, yc, xc] > 0
        p = np.where(ok, psi[t, yc, xc].astype(np.float64), 0.0)
        ps += p
        pa += np.abs(p)
        ph += np.where(ok, phi[t, yc, xc].astype(np.float64), 0.0)
    good = ph > 0
    root = np.sqrt(np.where(good, ph, 1.0))
    lh64 = np.where(good, ps / root, -1.0)
    bound = np.where(good, (T + 1) * U * pa / root + 2 * U * np.abs(lh64), 0.0)
    return lh64, bound


def jax_extra(lh64):
    """What the JAX side may add to the bound: 2 float32 ulps of lh64."""
    return 2 * np.spacing(np.abs(lh64).astype(np.float32)).astype(np.float64)


def assert_lh_match(got, ref, own, lh64, bound):
    """The twin's lh within its float64 bound, the reference's within that
    plus :func:`jax_extra`; an index may differ only where the two
    candidates' own lh (``own[c]``, the twin's gated map of candidate c)
    tie within the sum of both sides' bounds for both."""
    (g_lh, g_idx), (r_lh, r_idx) = got, ref
    assert g_lh.shape == r_lh.shape and g_lh.dtype == np.float32 and g_idx.dtype == np.int32
    assert np.all(np.sign(g_lh) == np.sign(r_lh))
    assert np.array_equal(g_idx < 0, r_idx < 0), "filled/empty mismatch"
    assert np.all(g_lh[g_idx < 0] == r_lh[r_idx < 0])
    k, i, j = np.nonzero(g_idx >= 0)
    for lh, idx, extra in ((g_lh, g_idx, 0.0), (r_lh, r_idx, 1.0)):
        c = idx[k, i, j]
        want = lh64[c, i, j]
        gap = np.abs(lh[k, i, j].astype(np.float64) - want)
        assert np.all(gap <= bound[c, i, j] + extra * jax_extra(want)), (
            "lh outside its float64 bound" + (" (JAX side)" if extra else " (port)"))
    tie = bound + bound + jax_extra(lh64)
    for k, i, j in np.argwhere(g_idx != r_idx):
        a, b = g_idx[k, i, j], r_idx[k, i, j]
        assert abs(float(own[a][i, j]) - float(own[b][i, j])) <= tie[a, i, j] + tie[b, i, j], (
            f"index mismatch at {(k, i, j)} without a tie")


def _assert_match(got, ref, lh_of):
    """:func:`assert_lh_match` with the maps of :func:`_lh_of`."""
    assert_lh_match(got, ref, *lh_of)


def _lh_of(psi, phi, valid, dxs, dys, min_obs, min_lh, kw):
    """Each candidate's own lh map under the same gates (twin, one candidate
    at a time, K = 1), and the float64 maps of :func:`f64_lh`."""
    one = dict(kw, k_results=1)
    own = [
        _twin(psi, phi, valid, dxs[c : c + 1], dys[c : c + 1], min_obs, min_lh, **one)[0][0]
        for c in range(len(dxs))
    ]
    if kw.get("has_masked") is False:
        valid = np.ones_like(valid)
    return (own,) + f64_lh(psi, phi, valid, dxs, dys, kw["x_min"], kw["x_max"], kw["y_min"], kw["y_max"])


CASES = {
    "full_k3": dict(k_results=3),
    "full_k2": dict(k_results=2),
    "k1": dict(k_results=1),
    "reduced": dict(k_results=2, bounds=(5, 30, 4, 25)),
    "extended": dict(k_results=2, bounds=(-4, 52, -6, 42)),
    "min_obs_gate": dict(k_results=2, min_obs=5.0),
    "no_obs_gate": dict(k_results=4, gate_min_obs=False),
    "min_lh_gate": dict(k_results=3, gate_min_lh=True, min_lh=0.5, min_obs=2.0),
}


def _case_kwargs(data, case):
    _, _, _, _, _, (T, H, W) = data
    case = dict(case)
    x_min, x_max, y_min, y_max = case.pop("bounds", (0, W, 0, H))
    min_obs = case.pop("min_obs", 0.0)
    min_lh = case.pop("min_lh", 0.0)
    return min_obs, min_lh, dict(x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max, **case)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_xla(data, name):
    psi, phi, valid, dxs, dys, _ = data
    min_obs, min_lh, kw = _case_kwargs(data, CASES[name])
    ref = _jax(search_topk_shift, psi, phi, valid, dxs, dys, min_obs, min_lh, **kw)
    got = _twin(psi, phi, valid, dxs, dys, min_obs, min_lh, **kw)
    _assert_match(got, ref, _lh_of(psi, phi, valid, dxs, dys, min_obs, min_lh, kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_pallas_interpret(data, name):
    psi, phi, valid, dxs, dys, _ = data
    min_obs, min_lh, kw = _case_kwargs(data, CASES[name])
    ref = _jax(search_topk_pallas, psi, phi, valid, dxs, dys, min_obs, min_lh,
               interpret=True, row_tile=16, **kw)
    got = _twin(psi, phi, valid, dxs, dys, min_obs, min_lh, **kw)
    _assert_match(got, ref, _lh_of(psi, phi, valid, dxs, dys, min_obs, min_lh, kw))


def test_twin_lh_is_ieee(data):
    """The twin's lh is psi_sum / sqrt(phi_sum) with IEEE float32 sqrt and
    division (each correctly rounded), over float32 sums in time order:
    numpy's float32 arithmetic gives the same bits."""
    psi, phi, valid, dxs, dys, (T, H, W) = data
    lh, idx = _twin(psi, phi, valid, dxs, dys, 0.0, 0.0,
                    x_min=0, x_max=W, y_min=0, y_max=H, k_results=1, gate_min_obs=False)
    ii, jj = np.mgrid[0:H, 0:W]
    c = idx[0]
    psi_s = np.zeros((H, W), np.float32)
    phi_s = np.zeros((H, W), np.float32)
    for t in range(T):
        y, x = ii + dys[c, t], jj + dxs[c, t]
        ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        yc, xc = np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)
        ok &= valid[t, yc, xc] > 0
        psi_s += np.where(ok, psi[t, yc, xc], np.float32(0))
        phi_s += np.where(ok, phi[t, yc, xc], np.float32(0))
    good = phi_s > 0
    ieee = np.where(good, psi_s / np.sqrt(np.where(good, phi_s, np.float32(1))), np.float32(-1))
    assert ieee.dtype == np.float32
    np.testing.assert_array_equal(lh[0], ieee)


def test_unmasked_stack(data):
    """has_masked=False skips the validity plane; on a stack without masked
    pixels the result equals the masked read."""
    rng = np.random.default_rng(8)
    _, _, _, dxs, dys, (T, H, W) = data
    psi = rng.normal(0, 1, (T, H, W)).astype(np.float32)
    phi = rng.uniform(0.5, 2.0, (T, H, W)).astype(np.float32)
    valid = np.ones((T, H, W), np.uint8)
    kw = dict(x_min=-3, x_max=W, y_min=0, y_max=H + 2, k_results=3)
    ref = _jax(search_topk_shift, psi, phi, valid, dxs, dys, 0.0, 0.0, has_masked=False, **kw)
    got = _twin(psi, phi, valid, dxs, dys, 0.0, 0.0, has_masked=False, **kw)
    _assert_match(got, ref, _lh_of(psi, phi, valid, dxs, dys, 0.0, 0.0, dict(kw, has_masked=False)))
    np.testing.assert_array_equal(got[1], _twin(psi, phi, valid, dxs, dys, 0.0, 0.0, **kw)[1])


def test_candidate_padding(data):
    """Junk candidates marked invalid change nothing."""
    psi, phi, valid, dxs, dys, (T, H, W) = data
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=3)
    ref = _jax(search_topk_shift, psi, phi, valid, dxs, dys, 0.0, 0.0, **kw)
    cand_valid = np.array([True] * len(dxs) + [False, False])
    got = _twin(psi, phi, valid, np.concatenate([dxs, dxs[:2]]), np.concatenate([dys, dys[:2]]),
                0.0, 0.0, cand_valid=torch.as_tensor(cand_valid), **kw)
    _assert_match(got, ref, _lh_of(psi, phi, valid, dxs, dys, 0.0, 0.0, kw))
    assert got[1].max() < len(dxs)


def test_ties_keep_lower_index(data):
    """Duplicated candidates tie exactly at every pixel: the rank-insert keeps
    them in index order (lower index first), with cand_offset added."""
    psi, phi, valid, dxs, dys, (T, H, W) = data
    order = [3, 1, 3, 0, 3]  # candidates 0, 2 and 4 are the same trajectory
    lh, idx = _twin(psi, phi, valid, dxs[order], dys[order], 0.0, 0.0,
                    x_min=0, x_max=W, y_min=0, y_max=H, k_results=5, cand_offset=100)
    dup = np.isin(idx, [100, 102, 104])
    assert np.all(dup.sum(axis=0) == 3)
    for i in range(H):
        for j in range(W):
            col = [v for v in idx[:, i, j] if v in (100, 102, 104)]
            assert col == [100, 102, 104]
            pos = [k for k in range(5) if idx[k, i, j] in (100, 102, 104)]
            assert np.all(lh[pos, i, j] == lh[pos[0], i, j])


def test_empty_slots_and_counters(data):
    psi, phi, valid, dxs, dys, (T, H, W) = data
    calls, launches = search_kernel.search_topk_shift.calls, search_kernel.search_topk.launches
    lh, idx = _twin(psi, phi, valid, dxs, dys, float(T + 1), 0.0,
                    x_min=0, x_max=W, y_min=0, y_max=H, k_results=2)
    assert np.all(idx == -1) and np.all(lh == -search_kernel.FLT_MAX)
    assert search_kernel.search_topk_shift.calls == calls + 1
    assert search_kernel.search_topk.launches == launches
