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
    K4_TILE_COLS,
    K4_TILE_ROWS,
    K5_SHARE_REUSE,
    K5_TILE_COLS,
    K5_TILE_ROWS,
    k4_staging,
    k5_staging,
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


def _rank_insert_in_order(top, topi, nv, ni):
    """rank_insert<KB, false>: insert below every entry >= nv (candidates
    arrive in index order)."""
    K = top.shape[0]
    p = (top >= nv[None]).sum(axis=0)
    k = np.arange(K)[:, None]
    shifted, shiftedi = np.concatenate([top[:1], top[:-1]]), np.concatenate([topi[:1], topi[:-1]])
    top = np.where(k == p, nv[None], np.where(k > p, shifted, top))
    topi = np.where(k == p, ni, np.where(k > p, shiftedi, topi))
    return top.astype(np.float32), topi


def _k4_replay(psi, phi, dxs, dys, min_obs, min_lh, em, *, x_min, x_max, y_min, y_max, k_results,
               gate_min_obs=True, gate_min_lh=False, cand_offset=0):
    """The new K4 (csrc/search_topk_encoded.cu) replayed in numpy from its
    host layout: per block of K4_TILE_ROWS x 256 window pixels, per batch of
    8 candidates in index order and per step, stage each member's window in
    16-byte chunks (zero outside the image), read every thread's word (two
    columns) at its member offset, joining two words with a funnel shift
    where the offset is odd, sum psi, phi and the counts as 16-bit fields,
    then decode and rank-insert in index order into the output map."""
    T, H, W = psi.shape
    Wp = -(-W // 8) * 8
    pairs = np.zeros((T, H, Wp), np.uint64)
    pairs[:, :, :W] = psi.astype(np.uint64) | (phi.astype(np.uint64) << 8)
    st = k4_staging(dxs, dys, x_min, y_min)
    starts, lay, off = st["starts"], st["lay"], st["off"]
    ox, oy = dxs.astype(np.int64) + x_min, dys.astype(np.int64) + y_min
    C = len(ox)
    SH, SW, K = y_max - y_min, x_max - x_min, k_results
    P, F, M32 = 0x00FF00FF, 0x00010001, 0xFFFFFFFF
    psi_s, psi_d = np.float32(em[1]), np.float32(em[0] - em[1])
    phi_s, phi_d = np.float32(em[3]), np.float32(em[2] - em[3])
    top = np.full((K, SH, SW), -np.finfo(np.float32).max, np.float32)
    topi = np.full((K, SH, SW), -1, np.int64)
    rows, words = np.arange(K4_TILE_ROWS)[:, None], np.arange(K4_TILE_COLS // 2)[None, :]
    for i0 in range(0, SH, K4_TILE_ROWS):
        for col0 in range(0, SW, K4_TILE_COLS):
            for b, c0 in enumerate(starts):
                n = min(8, C - c0)
                ap, af, ao = (np.zeros((8,) + np.broadcast(rows, words).shape, np.uint64) for _ in range(3))
                for t in range(T):
                    nslab, nrows, pitch, y, x = (int(v) for v in lay[b, t])
                    assert pitch % 8 == 0 and nslab * nrows * pitch <= st["buf_elems"]
                    buf = np.zeros(nslab * nrows * pitch, np.uint64)
                    for sr in range(nslab * nrows):
                        if nslab == 1:
                            yy, xx = i0 + y + sr, col0 + x
                        else:
                            m, r = divmod(sr, nrows)
                            yy, xx = i0 + oy[c0 + m, t] + r, col0 + (ox[c0 + m, t] & ~7)
                        assert xx % 8 == 0  # chunks lie wholly inside or outside the plane
                        xs = xx + np.arange(pitch)
                        ok = (0 <= yy < H) & (xs >= 0) & (xs < Wp)
                        buf[sr * pitch:(sr + 1) * pitch] = np.where(ok, pairs[t, min(max(yy, 0), H - 1),
                                                                               np.clip(xs, 0, Wp - 1)], 0)
                    w32 = buf[0::2] | (buf[1::2] << 16)
                    for m in range(n):
                        e = off[b, t, m] + 2 * words + rows * pitch
                        if off[b, t, m] % 2:  # a funnel shift of the two words around the pair
                            assert ((e + 1) >> 1).max() < len(w32)
                            w = ((w32[(e - 1) >> 1] >> 16) | (w32[(e + 1) >> 1] << 16)) & M32
                        else:
                            w = w32[e >> 1]
                        pv, fv = w & P, (w >> 8) & P
                        ind = ((pv + P) >> 8) & ((fv + P) >> 8) & F
                        ap[m] += pv & (ind * 0xFF)
                        af[m] += fv & (ind * 0xFF)
                        ao[m] += ind
                for p in range(2):
                    i, j = i0 + rows + 0 * words, col0 + 2 * words + p + 0 * rows
                    live = (i < SH) & (j < SW)
                    ii, jj = i[live], j[live]
                    for m in range(n):
                        c = c0 + m
                        obs = ((ao[m] >> (16 * p)) & 0xFFFF)[live]
                        fobs = obs.astype(np.float32)
                        ps = psi_s * ((ap[m] >> (16 * p)) & 0xFFFF)[live].astype(np.float32) + psi_d * fobs
                        fs = phi_s * ((af[m] >> (16 * p)) & 0xFFFF)[live].astype(np.float32) + phi_d * fobs
                        with np.errstate(divide="ignore", invalid="ignore"):
                            lh = np.where(fs > 0, ps / np.sqrt(fs.astype(np.float64)).astype(np.float32),
                                          np.float32(-1)).astype(np.float32)
                        ok = np.ones(len(lh), bool)
                        if gate_min_obs:
                            ok &= fobs >= min_obs
                        if gate_min_lh:
                            ok &= lh >= min_lh
                        nv = np.where(ok, lh, -np.inf).astype(np.float32)
                        top[:, ii, jj], topi[:, ii, jj] = _rank_insert_in_order(
                            top[:, ii, jj], topi[:, ii, jj], nv, cand_offset + c)
    return top, topi.astype(np.int32)


K4_REPLAY_CASES = {
    "slabs": dict(vmax=40.0),  # columns spread: one slab per member
    "box": dict(vmax=0.6),  # windows overlap: one box over the batch
    "edges": dict(vmax=40.0, x_min=-9, x_max=300, y_min=-5, y_max=19),  # two column tiles, past every edge
    "gates": dict(vmax=8.0, gate_min_lh=True, min_lh=0.5, k_results=5, cand_offset=100),
}


@pytest.mark.parametrize("case", sorted(K4_REPLAY_CASES))
def test_k4_replay_matches_twin_and_pallas(case):
    """The new K4's index arithmetic, replayed in numpy, bit-equal to the
    twin (batch boundaries at 8 and 16 of 19 candidates, in index order,
    exact ties included), and to the JAX Pallas K4 in interpret mode within
    the encoded tolerance on the windows it takes."""
    T, H, W, C = 6, 14, 37, 19
    kw = dict(K4_REPLAY_CASES[case])
    vmax = kw.pop("vmax")
    min_lh = kw.pop("min_lh", 0.0)
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=4), **kw)
    psi, phi = _codes(T, H, W, 8, seed=41)
    dxs, dys = _offsets(C, T, seed=42, vmax=vmax)
    dys = dys // 3
    assert (dxs % 2 == 1).any() and (dxs % 2 == 0).any()
    lay = k4_staging(dxs, dys, kw["x_min"], kw["y_min"])["lay"]
    if case == "box":
        assert (lay[..., 0] == 1).any()
    if case in ("slabs", "edges"):
        assert (lay[..., 0] > 1).any()
    got = _k4_replay(psi, phi, dxs, dys, 3.0, min_lh, EM, **kw)
    twin = search_topk_encoded_shift(torch.as_tensor(psi), torch.as_tensor(phi), torch.as_tensor(dxs),
                                     torch.as_tensor(dys), 3.0, min_lh, EM, **kw)
    np.testing.assert_array_equal(got[1], twin[1].numpy())
    np.testing.assert_array_equal(got[0], twin[0].numpy())
    if case in ("box", "slabs"):
        ref = jsp.search_topk_pallas_encoded(
            jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(dxs), jnp.asarray(dys), jnp.float32(3.0),
            jnp.float32(min_lh), jnp.asarray(EM), interpret=True, **kw)
        _assert_topk_close(ref, got, _lh_of(psi, phi, EM, dxs, dys, kw))


def _rank_insert_by_index(top, topi, nv, ni):
    """rank_insert<KB, true>: insert below every entry with a larger lh, or
    an equal lh and a smaller index (candidates arrive in plan order)."""
    K = top.shape[0]
    p = ((top > nv[None]) | ((top == nv[None]) & (topi < ni))).sum(axis=0)
    k = np.arange(K)[:, None]
    shifted, shiftedi = np.concatenate([top[:1], top[:-1]]), np.concatenate([topi[:1], topi[:-1]])
    top = np.where(k == p, nv[None], np.where(k > p, shifted, top))
    topi = np.where(k == p, ni, np.where(k > p, shiftedi, topi))
    return top.astype(np.float32), topi


def _k5_replay(psi, phi, dxs, dys, min_obs, min_lh, em, plan, *, x_min, x_max, y_min, y_max, k_results,
               gate_min_obs=True, gate_min_lh=False, cand_offset=0):
    """K5 (csrc/search_topk_grouped.cu) replayed in numpy from its host plan:
    per block of 4 x 256 window pixels (a thread one row, columns tx and tx
    + 128), per group and step, stage the window in 16-byte chunks (zero
    outside the image); a step whose box the members read K5_SHARE_REUSE
    times over is prepared once (a 32-bit word a pixel: masked psi in bits
    0-12, the indicator in 13-18, masked phi in 19-31) and each member adds
    its two pixels' words into short sums, moved into 16-bit fields every 32
    steps; any other step is extracted per member from the window's two
    16-bit pixels, psi into the 16-bit fields and phi and the indicator
    into the short sums; past 257 steps the fields go into 32-bit sums
    every 256 steps. Then decode and rank-insert by (lh desc, index asc). Returns the
    maps and the number of steps taken by each path."""
    T, H, W = psi.shape
    Wp = -(-W // 8) * 8
    pairs = np.zeros((T, H, Wp), np.uint64)
    pairs[:, :, :W] = psi.astype(np.uint64) | (phi.astype(np.uint64) << 8)
    st = k5_staging(dxs, dys, x_min, y_min, plan)
    lay, off, ext_elems = st["lay"], st["off"], st["ext_elems"]
    order, starts = (np.asarray(a, dtype=np.int64) for a in plan)
    ox, oy = dxs[order].astype(np.int64) + x_min, dys[order].astype(np.int64) + y_min
    C = len(ox)
    bounds = np.append(starts, C)
    SH, SW, K = y_max - y_min, x_max - x_min, k_results
    P, F, M32, M16 = 0x00FF00FF, 0x00010001, 0xFFFFFFFF, 0xFFFF
    psi_s, psi_d = np.float32(em[1]), np.float32(em[0] - em[1])
    phi_s, phi_d = np.float32(em[3]), np.float32(em[2] - em[3])
    top = np.full((K, SH, SW), -np.finfo(np.float32).max, np.float32)
    topi = np.full((K, SH, SW), -1, np.int64)
    ty, tx = np.arange(K5_TILE_ROWS)[:, None], np.arange(K5_TILE_COLS // 2)[None, :]
    steps = {"shared": 0, "own": 0}
    wide = T > 257
    for i0 in range(0, SH, K5_TILE_ROWS):
        for col0 in range(0, SW, K5_TILE_COLS):
            for g in range(len(starts)):
                c0, n = int(bounds[g]), int(bounds[g + 1] - bounds[g])
                sa, sb, ap, af, ao = (np.zeros((8,) + np.broadcast(ty, tx).shape, np.uint64) for _ in range(5))
                w32 = np.zeros((8, 4) + sa.shape[1:], np.int64)  # 32-bit sums: psi, psi, phi, phi
                for t in range(T):
                    nslab, rows, pitch, y, x = (int(v) for v in lay[g, t])
                    elems = nslab * rows * pitch
                    assert pitch % 8 == 0 and elems <= st["buf_elems"]
                    buf = np.zeros(elems, np.uint64)
                    for sr in range(nslab * rows):
                        if nslab == 1:
                            yy, xx = i0 + y + sr, col0 + x
                        else:
                            m, r = divmod(sr, rows)
                            yy, xx = i0 + oy[c0 + m, t] + r, col0 + (ox[c0 + m, t] & ~7)
                        xs = xx + np.arange(pitch)
                        ok = (0 <= yy < H) & (xs >= 0) & (xs < Wp)
                        buf[sr * pitch:(sr + 1) * pitch] = np.where(ok, pairs[t, min(max(yy, 0), H - 1),
                                                                               np.clip(xs, 0, Wp - 1)], 0)
                    shared = (nslab == 1 and K5_SHARE_REUSE * elems <= n * K5_TILE_ROWS * K5_TILE_COLS
                              and 2 * elems <= ext_elems)
                    steps["shared" if shared else "own"] += 1
                    if shared:
                        w = buf[0::2] | (buf[1::2] << 16)
                        pv, fv = w & P, (w >> 8) & P
                        ind = ((pv + P) >> 8) & ((fv + P) >> 8) & F
                        keep = ind * 0xFF
                        pp, ff = (pv & keep) | (ind << 13), fv & keep
                        ext = np.empty(elems, np.uint64)
                        ext[0::2] = ((pp & M16) | (ff << 19)) & M32
                        ext[1::2] = ((pp >> 16) | ((ff >> 16) << 19)) & M32
                    for m in range(n):
                        e = off[g, t, m] + tx + ty * pitch
                        assert e.min() >= 0 and e.max() + 128 < elems
                        if shared:
                            sa[m] = (sa[m] + ext[e]) & M32
                            sb[m] = (sb[m] + ext[e + 128]) & M32
                        else:
                            w = buf[e] | (buf[e + 128] << 16)
                            pv, fv = w & P, (w >> 8) & P
                            ind = ((pv + P) >> 8) & ((fv + P) >> 8) & F
                            f = fv & (ind * 0xFF)
                            ap[m] = (ap[m] + (pv & (ind * 0xFF))) & M32
                            sa[m] = (sa[m] + (((f << 19) & M32) | ((ind & 1) << 13))) & M32
                            sb[m] = (sb[m] + (((f >> 16) << 19) | ((ind >> 16) << 13))) & M32
                    if t % 32 == 31 or t == T - 1:
                        ap = (ap + ((sa & 0x1FFF) | ((sb & 0x1FFF) << 16))) & M32
                        ao = (ao + (((sa >> 13) & 0x3F) | (((sb >> 13) & 0x3F) << 16))) & M32
                        af = (af + ((sa >> 19) | ((sb >> 19) << 16))) & M32
                        sa[:], sb[:] = 0, 0
                    if wide and (t % 256 == 255 or t == T - 1):
                        for q, v in enumerate((ap & M16, ap >> 16, af & M16, af >> 16)):
                            w32[:, q] += v.astype(np.int64)
                        ap[:], af[:] = 0, 0
                for p in range(2):
                    i, j = i0 + ty + 0 * tx, col0 + tx + 128 * p + 0 * ty
                    live = (i < SH) & (j < SW)
                    ii, jj = i[live], j[live]
                    for m in range(n):
                        obs = ((ao[m] >> (16 * p)) & M16)[live]
                        if wide:
                            ps, fs = w32[m, p][live], w32[m, 2 + p][live]
                        else:
                            ps, fs = ((ap[m] >> (16 * p)) & M16)[live], ((af[m] >> (16 * p)) & M16)[live]
                        fobs = obs.astype(np.float32)
                        psum = psi_s * ps.astype(np.float32) + psi_d * fobs
                        fsum = phi_s * fs.astype(np.float32) + phi_d * fobs
                        with np.errstate(divide="ignore", invalid="ignore"):
                            lh = np.where(fsum > 0, psum / np.sqrt(fsum.astype(np.float64)).astype(np.float32),
                                          np.float32(-1)).astype(np.float32)
                        ok = np.ones(len(lh), bool)
                        if gate_min_obs:
                            ok &= fobs >= min_obs
                        if gate_min_lh:
                            ok &= lh >= min_lh
                        nv = np.where(ok, lh, -np.inf).astype(np.float32)
                        top[:, ii, jj], topi[:, ii, jj] = _rank_insert_by_index(
                            top[:, ii, jj], topi[:, ii, jj], nv, cand_offset + order[c0 + m])
    return (top, topi.astype(np.int32)), steps


# (T, C, vmax, columns apart, keywords): windows that overlap (every step
# prepared); candidates 300 columns apart at every step (every step per
# member); every third candidate drifting up to 300 columns a step further
# (early steps prepared, later ones per member, in one launch), with two
# column blocks and every edge; past the short sums' 32 steps; past 257
# steps (32-bit sums every 256).
K5_REPLAY_CASES = {
    "shared": (6, 19, 1.5, None, {}),
    "own": (6, 19, 1.5, "apart", {}),
    "mixed": (9, 24, 1.5, "drift", dict(x_min=-9, x_max=300, y_min=-5, y_max=19)),
    "short_flush": (70, 19, 0.3, None, dict(gate_min_lh=True, min_lh=0.5, k_results=5, cand_offset=100)),
    "wide": (300, 11, 0.05, None, dict(k_results=3)),
}


@pytest.mark.parametrize("case", sorted(K5_REPLAY_CASES))
def test_k5_replay_matches_twin(case):
    """K5's prepared and per-member paths, replayed in numpy, bit-equal to
    the twin (ties by ascending index among exact duplicates), each path
    taken where the case says."""
    T, C, vmax, columns, kw = K5_REPLAY_CASES[case]
    H, W = 14, 37
    kw = dict(kw)
    min_lh = kw.pop("min_lh", 0.0)
    kw = dict(dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=4), **kw)
    psi, phi = _codes(T, H, W, 8, seed=T + C)
    dxs, dys = _offsets(C, T, seed=43, vmax=vmax)
    dys = dys // 3
    if columns == "apart":
        dxs += 300 * np.arange(C, dtype=dxs.dtype)[:, None]
    elif columns == "drift":
        far = np.arange(C) % 3 == 2
        step = np.round(np.linspace(0.0, 300.0, T)).astype(dxs.dtype)
        dxs[far] += step[None, :] * (1 + np.arange(far.sum(), dtype=dxs.dtype))[:, None]
    plan = search_plan.grouped_plan(dys)[0]
    got, steps = _k5_replay(psi, phi, dxs, dys, 3.0, min_lh, EM, plan, **kw)
    if columns is None:
        assert steps["shared"] >= T * len(range(0, kw["x_max"] - kw["x_min"], K5_TILE_COLS))
    elif columns == "apart":
        assert steps["shared"] == 0 and steps["own"] > 0
    else:
        assert steps["shared"] > 0 and steps["own"] > 0
    twin = search_topk_encoded_shift(torch.as_tensor(psi), torch.as_tensor(phi), torch.as_tensor(dxs),
                                     torch.as_tensor(dys), 3.0, min_lh, EM, **kw)
    np.testing.assert_array_equal(got[1], twin[1].numpy())
    np.testing.assert_array_equal(got[0], twin[0].numpy())


def _band_offsets():
    """Offsets of the survey band cell: KBMOD's default 257 x 129
    EclipticCenteredSearch grid over 100 times in 1.35 days."""
    from kbmod_tpu_torch.trajectory_generator import EclipticCenteredSearch

    gen = EclipticCenteredSearch(velocities=[92.0, 526.0, 257], angles=[-np.pi / 15, np.pi / 15, 129],
                                 angle_units="radian", given_ecliptic=0.0)
    cands = list(gen)
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    return trajectory_offsets(vxs, vys, np.linspace(0.0, 1.35, 100))


def test_band_cell_steps_are_all_prepared():
    """At the band cell's grid (257 x 129 candidates, T = 100 over 1.35
    days, a 257-row window), K5's layout sends every step of every group of
    several members to the prepared path, each staged pixel read by 6 to 7
    members on average; only the plan's one singleton group (33,153 = 4,144
    x 8 + 1), whose box no other member reads, keeps the per-member path.
    The buffers fit two blocks an SM."""
    dxs, dys = _band_offsets()
    assert dxs.shape == (257 * 129, 100)
    route, (order, starts) = encoded_route(torch.uint8, 100, dys)
    assert route == "grouped"
    sizes = np.diff(np.append(starts, len(order)))
    assert len(starts) == 4145 and (sizes == 1).sum() == 1 and (sizes == 8).sum() == 4144
    st = k5_staging(dxs, dys, 0, 0, (order, starts))
    share = st["share"]
    assert share["steps_own"] == 100 and share["steps_shared"] == 4144 * 100
    assert 6.0 < share["pixels_read"] / share["pixels_staged"] < 7.0
    assert st["ext_elems"] == 2 * share["elems_shared"] == 2 * st["buf_elems"]
    assert 2 * (st["smem_bytes"] + 1024) <= 233472


def test_wide_column_spread_steps_go_per_member():
    """Members 300 columns apart (one slab each) keep the per-member
    extraction, and the prepared buffers hold their windows' copies."""
    dxs, dys = _offsets(40, 8, seed=44, vmax=2.0)
    dxs += 300 * np.arange(40, dtype=dxs.dtype)[:, None]
    plan = search_plan.grouped_plan(dys)[0]
    st = k5_staging(dxs, dys, 0, 0, plan)
    share = st["share"]
    assert (st["lay"][..., 0] > 1).all()
    assert share["steps_shared"] == 0 and share["steps_own"] == st["lay"].shape[0] * 8
    assert share["pixels_read"] < share["pixels_staged"]
    assert st["ext_elems"] == share["elems_own"] == st["buf_elems"]
