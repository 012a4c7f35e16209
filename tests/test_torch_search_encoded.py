"""Port parity for the encoded search: the twin of kernels K3-K5, the
plans, the dedup expansion and the dispatcher's routing, against the JAX
package on the same uint8/uint16 codes and decode vector, with
``device="cpu"``. The JAX side runs its Pallas kernels in interpret mode.

Tolerance against every JAX route (XLA's ``search_topk_shift`` with
``encode_meta``, Pallas K3/K4 and K5, the packed dispatcher): lh within
1e-5 * max(1, |lh|). Measured on these inputs: at most 3.4e-6 absolute
below |lh| = 1 and 2.6e-6 relative above it. The port decodes with every
product and sum rounded on its own and takes an IEEE sqrt and division;
XLA's CPU build fuses the decode's multiply-add, and the Pallas kernels
multiply by an rsqrt, so near a cancellation in the decode the two sides
part by a few ulps of the decode's terms. Indices must be equal, except
that two candidates may swap where their lh (as the port computes them)
lie within that tolerance of each other. Within the port (dispatcher,
dedup) results are bit-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbmod_tpu.ops import search as jax_search
from kbmod_tpu.ops import search_pallas as jsp
from kbmod_tpu.trajectory_generator import KBMODV1Search

from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.ops import search_plan
from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
from kbmod_tpu_torch.ops.search_encoded import encoded_route, search_topk_encoded
from kbmod_tpu_torch.ops.search_encoded_kernel import (
    search_encoded,
    search_grouped,
    search_paired,
    search_topk_encoded_shift,
)

EM = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], dtype=np.float32)
EM16 = np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], dtype=np.float32)
TOL = 1e-5


def _codes(T, H, W, bits, seed, zeros=0.05):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    dtype = np.uint8 if bits == 8 else np.uint16
    psi = rng.integers(1, hi, (T, H, W)).astype(dtype)
    phi = rng.integers(1, hi, (T, H, W)).astype(dtype)
    psi[rng.uniform(size=psi.shape) < zeros] = 0
    phi[rng.uniform(size=phi.shape) < zeros] = 0
    return psi, phi


def _offsets(C, T, seed, vmax=3.0, span=2.0):
    rng = np.random.default_rng(seed)
    vxs = rng.uniform(-vmax, vmax, C).astype(np.float32)
    vys = rng.uniform(-vmax, vmax, C).astype(np.float32)
    vxs[[3, 7]] = vxs[1]  # exact ties with candidate 1
    vys[[3, 7]] = vys[1]
    return trajectory_offsets(vxs, vys, np.linspace(0.0, span, T))


def _planes(psi, phi, em):
    return EncodedPlanes(torch.as_tensor(psi), torch.as_tensor(phi), em)


def _lh_of(psi, phi, em, dxs, dys, kw):
    """Every candidate's ungated lh at every window pixel, from the twin:
    (C, SH, SW)."""
    C = len(dxs)
    bounds = {k: kw[k] for k in ("x_min", "x_max", "y_min", "y_max")}
    lh, idx = search_topk_encoded_shift(
        torch.as_tensor(psi), torch.as_tensor(phi), dxs, dys, 0.0, 0.0, em,
        k_results=C, gate_min_obs=False, **bounds,
    )
    out = np.zeros(lh.shape, np.float64)
    np.put_along_axis(out, idx.numpy().astype(np.int64), lh.numpy(), 0)
    return out


def _assert_topk_close(ref, got, lh_of):
    """Filled slots equal, lh within the tolerance, indices equal up to
    swaps of candidates whose lh lie within the tolerance of each other."""
    r_lh, r_idx = (np.asarray(a) for a in ref)
    g_lh, g_idx = (np.asarray(a) for a in got)
    assert g_lh.shape == r_lh.shape and g_lh.dtype == np.float32 and g_idx.dtype == np.int32
    np.testing.assert_array_equal(g_idx >= 0, r_idx >= 0)
    filled = r_idx >= 0
    tol = TOL * np.maximum(1.0, np.abs(r_lh.astype(np.float64)))
    assert (np.abs(g_lh.astype(np.float64) - r_lh)[filled] <= tol[filled]).all()
    diff = np.argwhere(filled & (g_idx != r_idx))
    for k, i, j in diff:
        a, b = lh_of[g_idx[k, i, j], i, j], lh_of[r_idx[k, i, j], i, j]
        assert abs(a - b) <= TOL * max(1.0, abs(a)), (k, i, j, a, b)
    return len(diff)


CASES = {
    "full": dict(k_results=4),
    "reduced": dict(k_results=3, x_min=4, x_max=19, y_min=3, y_max=15),
    "extended": dict(k_results=3, x_min=-4, x_max=27, y_min=-3, y_max=21),
    "no-obs-gate": dict(k_results=2, gate_min_obs=False),
    "min-obs": dict(k_results=3, min_obs=5.0),
    "min-lh": dict(k_results=3, gate_min_lh=True, min_lh=0.5, min_obs=2.0),
    "k1": dict(k_results=1),
}


def _case(name, H, W):
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    kw.update(CASES[name])
    min_obs = kw.pop("min_obs", 3.0)
    min_lh = kw.pop("min_lh", 0.0)
    return kw, min_obs, min_lh


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_xla_encoded(bits, case):
    T, H, W, C = 6, 18, 23, 11
    psi, phi = _codes(T, H, W, bits, seed=bits + len(case))
    em = EM if bits == 8 else EM16
    dxs, dys = _offsets(C, T, seed=5)
    kw, min_obs, min_lh = _case(case, H, W)
    ref = jax_search.search_topk_shift(
        jnp.asarray(psi), jnp.asarray(phi), jnp.zeros((1, 1, 1), jnp.uint8),
        jnp.asarray(dxs), jnp.asarray(dys), jnp.float32(min_obs), jnp.float32(min_lh),
        encode_meta=jnp.asarray(em), **kw,
    )
    got = search_topk_encoded_shift(
        torch.as_tensor(psi), torch.as_tensor(phi), torch.as_tensor(dxs), torch.as_tensor(dys),
        min_obs, min_lh, em, **kw,
    )
    _assert_topk_close(ref, got, _lh_of(psi, phi, em, dxs, dys, kw))


@pytest.mark.parametrize("kernel,bits,T", [("K3", 16, 6), ("K4", 8, 6), ("K3", 8, 260)])
def test_wrappers_match_pallas_encoded(kernel, bits, T):
    """Pallas K3 (uint16) and K4 (uint8, T <= 257), and the XLA route for
    uint8 with T > 257, against the port's K3 and K4 wrappers on the CPU."""
    H, W, C = 16, 21, 9
    psi, phi = _codes(T, H, W, bits, seed=T)
    em = EM if bits == 8 else EM16
    dxs, dys = _offsets(C, T, seed=6, vmax=2.0)
    kw, min_obs, min_lh = _case("full", H, W)
    args = (jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(dxs), jnp.asarray(dys),
            jnp.float32(min_obs), jnp.float32(min_lh), jnp.asarray(em))
    if T <= 257:
        ref = jsp.search_topk_pallas_encoded(*args, interpret=True, **kw)
    else:
        ref = jax_search.search_topk_shift(
            args[0], args[1], jnp.zeros((1, 1, 1), jnp.uint8), *args[2:6], encode_meta=args[6], **kw
        )
    wrapper = search_paired if kernel == "K4" else search_encoded
    got = wrapper(_planes(psi, phi, em), torch.as_tensor(dxs), torch.as_tensor(dys), min_obs, min_lh, **kw)
    _assert_topk_close(ref, got, _lh_of(psi, phi, em, dxs, dys, kw))


@pytest.mark.parametrize("T", [6, 260])
def test_grouped_wrapper_matches_pallas_grouped(T):
    """Pallas K5 with a plan against the port's K5 wrapper (on the CPU: the
    twin), T past the 16-bit field limit included."""
    H, W, C = 16, 20, 19
    psi, phi = _codes(T, H, W, 8, seed=T + 1)
    dxs, dys = _offsets(C, T, seed=8, vmax=1.5)
    kw, min_obs, min_lh = _case("full", H, W)
    plan = search_plan._plan_groups(dys, 8, 8)
    words, geom = jsp.pack_psi_phi_words(psi, phi)
    ref = jsp.search_topk_paired_grouped(
        words, dxs, dys, jnp.float32(min_obs), jnp.float32(min_lh), jnp.asarray(EM),
        shape=(T, H, W), pad_rows=geom, interpret=True, _plan=plan, **kw,
    )
    got = search_grouped(_planes(psi, phi, EM), torch.as_tensor(dxs), torch.as_tensor(dys), min_obs, min_lh,
                         plan=plan, **kw)
    _assert_topk_close(ref, got, _lh_of(psi, phi, EM, dxs, dys, kw))


class _Routed(Exception):
    pass


def _jax_route(monkeypatch, psi, phi, em, dxs, dys, kw, min_obs):
    """The route the JAX packed dispatcher takes, found by replacing its
    kernels with stubs that name themselves."""
    taken = []
    dedup = jsp._dedup_plan_cached

    def spy_dedup(*a, **k):
        plan = dedup(*a, **k)
        if plan is not None:
            taken.append("dedup+")
        return plan

    def stub(name):
        def run(*a, **k):
            raise _Routed(name)
        return run

    monkeypatch.setattr(jsp, "_dedup_plan_cached", spy_dedup)
    monkeypatch.setattr(jsp, "search_topk_paired_grouped", stub("grouped"))
    monkeypatch.setattr(jsp, "_run_paired_search", stub("paired"))
    monkeypatch.setattr(jsp, "_run_encoded_search", stub("encoded"))
    monkeypatch.setattr(jsp, "_search_topk_pallas_packed_jit", jsp._search_topk_pallas_packed_jit.__wrapped__)
    words, geom = jsp.pack_psi_phi_words(psi, phi)
    with pytest.raises(_Routed) as routed:
        jsp.search_topk_pallas_packed(
            words, dxs, dys, jnp.float32(min_obs), jnp.float32(0), jnp.asarray(em),
            shape=psi.shape, bits=8 * psi.dtype.itemsize, pad_rows=geom, interpret=True, **kw,
        )
    monkeypatch.undo()
    return "".join(taken) + routed.value.args[0]


def _route_case(name):
    """(codes, em, offsets) for one route of the dispatcher."""
    if name == "dedup":  # slow candidates: many share their offsets
        T, bits = 5, 8
        vxs, vys = (np.asarray(a, np.float32) for a in np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 5)))
        dxs, dys = trajectory_offsets(vxs.ravel(), vys.ravel(), np.linspace(0.0, 1.2, T))
    elif name == "grouped":  # rows close together, offsets distinct
        T, bits = 6, 8
        rng = np.random.default_rng(3)
        dxs, dys = trajectory_offsets(rng.uniform(-4, 4, 24).astype(np.float32),
                                      rng.uniform(-0.4, 0.4, 24).astype(np.float32), np.linspace(0, 3, T))
    elif name in ("paired", "encoded-u8"):  # last rows 8 apart: singleton groups, the plan does not fill
        T, bits = (6 if name == "paired" else 260), 8
        dxs, dys = trajectory_offsets(np.linspace(-2, 2, 7).astype(np.float32),
                                      np.linspace(-12, 12, 7).astype(np.float32), np.linspace(0, 2, T))
    else:  # uint16
        T, bits = 6, 16
        dxs, dys = _offsets(10, T, seed=2)
    psi, phi = _codes(T, 15, 19, bits, seed=T + bits)
    return psi, phi, (EM if bits == 8 else EM16), dxs, dys


@pytest.mark.parametrize(
    "name,route",
    [("dedup", "dedup+grouped"), ("grouped", "grouped"), ("paired", "paired"),
     ("encoded-u16", "dedup+encoded"), ("encoded-u8", "encoded")],
)
def test_dispatcher_routes_and_results_match(monkeypatch, name, route):
    """The port's dispatcher takes the JAX dispatcher's route and returns
    its result (within the tolerance)."""
    psi, phi, em, dxs, dys = _route_case(name)
    T, H, W = psi.shape
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=3)
    assert _jax_route(monkeypatch, psi, phi, em, dxs, dys, kw, 2.0) == route
    got = search_topk_encoded(_planes(psi, phi, em), dxs, dys, 2.0, 0.0, **kw)
    assert search_topk_encoded.last_route == route
    if T > 64:  # the JAX interpreter at T = 260 is slow; compare with XLA there
        ref = jax_search.search_topk_shift(
            jnp.asarray(psi), jnp.asarray(phi), jnp.zeros((1, 1, 1), jnp.uint8), jnp.asarray(dxs),
            jnp.asarray(dys), jnp.float32(2.0), jnp.float32(0), encode_meta=jnp.asarray(em), **kw,
        )
    else:
        words, geom = jsp.pack_psi_phi_words(psi, phi)
        ref = jsp.search_topk_pallas_packed(
            words, dxs, dys, jnp.float32(2.0), jnp.float32(0), jnp.asarray(em),
            shape=psi.shape, bits=8 * psi.dtype.itemsize, pad_rows=geom, interpret=True, **kw,
        )
    _assert_topk_close(ref, got, _lh_of(psi, phi, em, dxs, dys, kw))


def test_dedup_expand_equals_search_without_dedup():
    """Within the port: dedup + expansion is bit-equal to the twin over all
    candidates, exact ties (duplicated candidates) included."""
    psi, phi, em, dxs, dys = _route_case("dedup")
    T, H, W = psi.shape
    for k in (1, 4, 9):
        kw = dict(x_min=-2, x_max=W + 1, y_min=0, y_max=H, k_results=k)
        got = search_topk_encoded(_planes(psi, phi, em), dxs, dys, 1.0, 0.0, **kw)
        assert search_topk_encoded.last_route.startswith("dedup+")
        ref = search_topk_encoded_shift(torch.as_tensor(psi), torch.as_tensor(phi), dxs, dys, 1.0, 0.0, em, **kw)
        assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


def test_twin_ties_and_padding_candidates():
    psi, phi = _codes(5, 12, 14, 8, seed=4)
    dxs, dys = _offsets(13, 5, seed=9)
    dxs[9:], dys[9:] = dxs[1], dys[1]  # exact ties with candidate 1
    kw = dict(x_min=0, x_max=14, y_min=0, y_max=12, k_results=6)
    ref = search_topk_encoded_shift(torch.as_tensor(psi), torch.as_tensor(phi), dxs, dys, 2.0, 0.0, EM, **kw)
    # Tied candidates sit in one pixel's list in ascending index order.
    idx = ref[1].numpy()
    tied = np.isin(idx, [1, 9, 10, 11, 12])
    assert (tied.sum(axis=0) > 1).any()
    for i, j in zip(*np.nonzero(tied.sum(axis=0) > 1)):
        col = [v for v in idx[:, i, j] if v in (1, 9, 10, 11, 12)]
        assert col == sorted(col)
    # Padding candidates never enter, whatever their scores.
    pad = search_topk_encoded_shift(
        torch.as_tensor(psi), torch.as_tensor(phi), np.concatenate([dxs, dxs[:3]]), np.concatenate([dys, dys[:3]]),
        2.0, 0.0, EM, cand_valid=np.r_[np.ones(13, bool), np.zeros(3, bool)], **kw,
    )
    assert torch.equal(pad[0], ref[0]) and torch.equal(pad[1], ref[1])


def _grid_offsets(T=12):
    times = np.linspace(0.0, 3.0, T)
    cands = list(KBMODV1Search(15, 1.0, 6.0, 13, -0.6, 0.6))
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    return trajectory_offsets(vxs, vys, times)


@pytest.mark.parametrize("source", ["grid", "random"])
def test_plans_equal_jax(source):
    dxs, dys = _grid_offsets() if source == "grid" else _offsets(57, 9, seed=11, vmax=5.0)
    a = jsp._dedup_plan(dxs, dys, 1.1)
    b = search_plan._dedup_plan(dxs, dys, 1.1)
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert search_plan._dedup_plan(dxs, dys, 1e9) is None
    for G, S in ((8, 8), (4, 3), (8, 0)):
        for x, y in zip(jsp._plan_groups(dys, G, S), search_plan._plan_groups(dys, G, S)):
            np.testing.assert_array_equal(y, x)
            assert y.dtype == x.dtype
    for G in (8, 16):
        for x, y in zip(jsp._plan_groups_uniform(dys, G), search_plan._plan_groups_uniform(dys, G)):
            np.testing.assert_array_equal(y, x)
    cached = search_plan._plan_groups_cached(dys, 8, 8)
    assert search_plan._plan_groups_cached(dys.copy(), 8, 8) is cached
    if b is not None:
        assert search_plan._dedup_plan_cached(dxs.copy(), dys.copy(), 1.1)[2] is \
            search_plan._dedup_plan_cached(dxs, dys, 1.1)[2]


@pytest.mark.parametrize("K", [1, 3, 8])
def test_expand_topk_classes_bit_equal(K):
    """Class maps with exact lh ties (values from a small set, signed zeros
    too) expand to the same candidate maps as the JAX expansion."""
    dxs, dys = _grid_offsets(T=4)
    _, _, members, _ = search_plan._dedup_plan(dxs, dys, 1.1)
    n = members.shape[0]
    rng = np.random.default_rng(K)
    SH, SW = 5, 7
    vals = np.array([3.5, 1.25, 0.0, -0.0, -1.0], np.float32)
    lh = np.sort(rng.choice(vals, (K, SH, SW)), axis=0)[::-1].copy()
    idx = np.stack([rng.permutation(n)[:K] for _ in range(SH * SW)], axis=1).reshape(K, SH, SW).astype(np.int32)
    lh[K - 1, 0, :3] = -np.finfo(np.float32).max  # empty slots
    idx[K - 1, 0, :3] = -1
    ref = jsp._expand_topk_classes(jnp.asarray(lh), jnp.asarray(idx), members)
    for band in (None, 2):
        got = search_plan._expand_topk_classes(torch.as_tensor(lh), torch.as_tensor(idx), members, row_band=band)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[0].numpy().view(np.int32), np.asarray(ref[0]).view(np.int32))


def test_route_rules():
    """The rule itself: uint16 never groups, uint8 groups when the plan
    fills, else pairs up to T = 257."""
    _, dys = _grid_offsets()
    assert encoded_route(torch.uint16, 12, dys)[0] == "encoded"
    route, plan = encoded_route(torch.uint8, 12, dys)
    assert route == "grouped" and len(plan[0]) == len(dys)
    sparse = np.arange(0, 60, 10, dtype=np.int32)[:, None] * np.ones((1, 12), np.int32)
    assert encoded_route(torch.uint8, 12, sparse)[0] == "paired"
    assert encoded_route(torch.uint8, 258, np.repeat(sparse, 258 // 12 + 1, axis=1)[:, :258])[0] == "encoded"


@pytest.mark.parametrize("bits", [8, 16])
def test_encoded_gathers_match_jax(bits):
    """Curves gathered from the codes: validity exact, values within 1e-6
    relative and absolute (measured: 2 float32 ulps; XLA's CPU build fuses
    the decode's multiply-add, the port rounds each step)."""
    psi, phi = _codes(7, 14, 17, bits, seed=bits, zeros=0.15)
    em = EM if bits == 8 else EM16
    rng = np.random.default_rng(1)
    xs, ys = rng.integers(-3, 20, 25).astype(np.int32), rng.integers(-3, 17, 25).astype(np.int32)
    dxs, dys = _offsets(25, 7, seed=3)
    ref_planes = jax_search.EncodedPlanes(jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(em))
    ref = jax_search._gather_curves(ref_planes, None, None, jnp.asarray(xs), jnp.asarray(ys),
                                    jnp.asarray(dxs), jnp.asarray(dys))
    got = search_ops._gather_curves(_planes(psi, phi, em), None, None, torch.as_tensor(xs), torch.as_tensor(ys),
                                    torch.as_tensor(dxs), torch.as_tensor(dys))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
