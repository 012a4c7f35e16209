"""The encoded search dispatcher: offset-class dedup, then K5, K4 or K3.

Port of the JAX package's ``search_topk_pallas_packed``
(ops/search_pallas.py:2654-2809) with its routing rules, in this order:

1. dedup: when C >= 1.1 x the number of offset classes, search each class
   once and expand the maps back to candidates (:2678-2697);
2. K5 (``search_grouped``) for uint8 codes when the grouping plan fills,
   i.e. groups x G <= max(1.6 C, C + 4 G) with G = S = 8 (:2713-2738);
3. K4 (``search_paired``) for uint8 codes with T <= 257 (``_use_paired``,
   :903);
4. K3 (``search_encoded``) otherwise: uint16 codes, and uint8 codes with
   T > 257 whose plan does not fill (:2870-2877).

The TPU's packed word stream, row tiles, guard and stripe machinery have no
counterpart: the kernels read ``PsiPhiArray.code_pairs``. Every result is
the same function, so the route changes only the time. The route taken is
kept in ``search_topk_encoded.last_route`` ("grouped", "paired" or
"encoded", with "dedup+" in front when dedup applied).
"""

import numpy as np
import torch

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.ops.search_encoded_kernel import (
    PAIRED_MAX_T,
    search_encoded,
    search_grouped,
    search_paired,
)
from kbmod_tpu_torch.ops.search_plan import _dedup_plan_cached, _expand_topk_classes, grouped_plan

# Dedup applies when the candidates outnumber their offset classes by this.
DEDUP_MIN_FACTOR = 1.1


def encoded_route(dtype, T, dys):
    """The kernel route for codes of ``dtype`` over T time steps and the
    (C, T) row offsets ``dys``, before dedup: ("grouped", plan),
    ("paired", None) or ("encoded", None).

    K5 takes the grouping plan of ``search_plan.grouped_plan`` when it
    fills (its groups are mostly full)."""
    if dtype == torch.uint8:
        plan, fills = grouped_plan(dys)
        if fills:
            return "grouped", plan
        if T <= PAIRED_MAX_T:
            return "paired", None
    return "encoded", None


def search_topk_encoded(
    planes, dxs, dys, min_obs, min_lh,
    *, x_min, x_max, y_min, y_max, k_results,
    gate_min_obs=True, gate_min_lh=False, cand_valid=None, cand_offset=0,
):
    """Per-pixel top-K search over an ``EncodedPlanes`` (ops/search.py).

    dxs, dys: (C, T) int offsets as numpy (the plans need them on the
    host). Returns top_lh (K, SH, SW) float32 and top_idx (K, SH, SW)
    int32 on the planes' device, as ``search_topk_encoded_shift`` defines
    them. Dedup applies only without padding candidates and candidate
    offset, as in the JAX package.
    """
    dxs = np.asarray(dxs, dtype=np.int32)
    dys = np.asarray(dys, dtype=np.int32)
    kw = dict(
        x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max, k_results=k_results,
        gate_min_obs=gate_min_obs, gate_min_lh=gate_min_lh,
        cand_valid=cand_valid, cand_offset=cand_offset,
    )
    if cand_valid is None and not cand_offset:
        with tracing.span("search.plan"):
            dedup = _dedup_plan_cached(dxs, dys, DEDUP_MIN_FACTOR)
        if dedup is not None:
            u_dxs, u_dys, members, _ = dedup
            top_lh, top_idx = search_topk_encoded(planes, u_dxs, u_dys, min_obs, min_lh, **kw)
            search_topk_encoded.last_route = "dedup+" + search_topk_encoded.last_route
            return _expand_topk_classes(top_lh, top_idx, members)
    T = planes.shape[0]
    with tracing.span("search.plan"):
        route, plan = encoded_route(planes.psi_codes.dtype, T, dys)
    dev = planes.device
    dxs_t, dys_t = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    if route == "grouped":
        out = search_grouped(planes, dxs_t, dys_t, min_obs, min_lh, plan=plan, **kw)
    elif route == "paired":
        out = search_paired(planes, dxs_t, dys_t, min_obs, min_lh, **kw)
    else:
        out = search_encoded(planes, dxs_t, dys_t, min_obs, min_lh, **kw)
    search_topk_encoded.last_route = route
    return out


search_topk_encoded.last_route = None
