"""Helpers shared by the port's entry-point scripts: the card's name and
power limit, synchronisation, random code stacks as the search takes them,
the reference's default survey grid and the 12-day lattice, the kernels' launch counts, the memory
of a pipeline's search against its budget, and the check of a search window
against the kernels' plain twin."""

import os
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch

# [psi_min, psi_scale, phi_min, phi_scale] of the JAX scripts' random code
# stacks.
EM = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], dtype=np.float32)


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_line(dev):
    """What a script's numbers were measured on: the card's line, or the
    host (no device metric is taken there)."""
    return card_line() if dev.type == "cuda" else "host CPU (plain twins; no device timing)"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn):
    """(result, seconds) of ``fn()``, the device synchronised after it."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


@contextmanager
def scoped_env(**values):
    """The environment variables set (a None value unsets one) for the
    block, and restored after it."""
    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def default_grid(n_vel=257, n_ang=129):
    """The reference's default survey grid (configuration.py's
    EclipticCenteredSearch): ``n_vel`` speeds in [92, 526] px/day x
    ``n_ang`` angles in +-pi/15 about the ecliptic (given_ecliptic 0),
    speed-major; (vxs, vys) float32."""
    vel = np.linspace(92.0, 526.0, n_vel)
    ang = np.linspace(-np.pi / 15.0, np.pi / 15.0, n_ang)
    vv, aa = np.meshgrid(vel, ang, indexing="ij")
    return (vv * np.cos(aa)).ravel().astype(np.float32), (vv * np.sin(aa)).ravel().astype(np.float32)


def twelve_day_lattice(C=257 * 129):
    """The JAX survey scripts' 12-day physical lattice: the default grid's
    257 speeds divided by 8 (a 12-day span) x whole rows of its 129 angles,
    up to C candidates, speed-major; (vxs, vys) float64."""
    vel_full = np.linspace(92.0, 526.0, 257) / 8.0
    n_ang = max(1, min(129, -(-C // 257)))
    ang_full = np.linspace(-np.pi / 15, np.pi / 15, 129)[:n_ang]
    vv, aa = np.meshgrid(vel_full, ang_full, indexing="ij")
    vel, ang = vv.ravel(), aa.ravel()
    return np.cos(ang) * vel, np.sin(ang) * vel


def random_codes(seed, T, H, W, psi_low=0):
    """The JAX scripts' random uint8 code stacks: psi in [psi_low, 256)
    (0 is masked), phi in [1, 256), from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    psi = rng.integers(psi_low, 256, (T, H, W), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, H, W), dtype=np.uint8)
    return psi, phi


def _counted():
    """The kernel wrappers, whose ``launches`` count their kernels, and the
    plain twins, whose ``calls`` count theirs, by function name."""
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv, psi_phi_conv_plain
    from kbmod_tpu_torch.ops.exactrow_kernel import exactrow_accumulate, exactrow_accumulate_plain
    from kbmod_tpu_torch.ops.search_kernel import search_topk, search_topk_shift
    from kbmod_tpu_torch.ops.sigmag_exact_kernel import sigmag_exact_topk

    kernels = [psi_phi_conv, search_topk, ek.search_encoded, ek.search_paired, ek.search_grouped,
               exactrow_accumulate, sigmag_exact_topk]
    twins = [psi_phi_conv_plain, search_topk_shift, ek.search_topk_encoded_shift, exactrow_accumulate_plain]
    return {fn.__name__: fn for fn in kernels}, {fn.__name__: fn for fn in twins}


def reset_counts():
    """Set every kernel's launch count, and every twin's call count, to 0."""
    kernels, twins = _counted()
    for fn in kernels.values():
        fn.launches = 0
    for fn in twins.values():
        fn.calls = 0


def read_counts():
    """({kernel: launches}, {twin: calls}) since :func:`reset_counts`."""
    kernels, twins = _counted()
    return {k: fn.launches for k, fn in kernels.items()}, {k: fn.calls for k, fn in twins.items()}


def measure_core_search(runner, dev):
    """Wrap ``runner.do_core_search`` so that it records, in the returned
    dict, the device's peak above what was allocated before it ("peak") and
    the port's budget for it (``run_search.search_memory_budget``,
    "budget"). On the host it records neither."""
    from kbmod_tpu_torch.run_search import search_memory_budget

    core = runner.do_core_search
    mem = {}

    def measured(config, stack, trj_generator):
        if dev.type != "cuda":
            return core(config, stack, trj_generator)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = core(config, stack, trj_generator)
        torch.cuda.synchronize(dev)
        mem["peak"] = torch.cuda.max_memory_allocated(dev) - base
        mem["budget"] = search_memory_budget(config, stack, len(trj_generator), dev)
        return out

    runner.do_core_search = measured
    return mem


def check_memory(tag, mem):
    """Raise when a measured peak exceeds the budget; returns a line."""
    if not mem:
        return f"{tag}: device memory not measured (host run)"
    total = mem["budget"]["total"]
    line = (f"{tag}: device peak {mem['peak'] / 2**30:.3f} GiB over do_core_search, budget {total / 2**30:.3f} GiB "
            f"({ {k: round(v / 2**30, 3) for k, v in mem['budget'].items() if k != 'total'} })")
    if mem["peak"] > total:
        raise AssertionError(f"{line}: the peak exceeds the budget")
    return line


def peak_rss_gib():
    """The process's peak resident set size so far, in GiB (getrusage)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def search_budget(T, H, W, C, dev, **settings):
    """The port's budget (``run_search.search_memory_budget``) of a uint8
    search of C candidates over a (T, H, W) stack with the configuration's
    defaults but ``settings``; the budget counts row tiles when
    ``KB_SEARCH_CKPT_DIR`` is set."""
    from types import SimpleNamespace

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.run_search import search_memory_budget

    config = SearchConfiguration()
    for key, value in dict(dict(encode_num_bytes=1), **settings).items():
        config.set(key, value)
    return search_memory_budget(config, SimpleNamespace(num_times=T, height=H, width=W), C, dev)


def phase_walls(runner):
    """{phase: seconds} of a runner's finished phases."""
    return {name: t[1] - t[0] for name, t in runner.phase_times.items() if t[1] is not None}


def check_window(planes, dxs, dys, min_obs, min_lh, lh, idx, window, k_results, origin=(0, 0), **gates):
    """Hold a search's (K, SH, SW) maps over a window of starting pixels
    against the kernels' plain twin on that window, bit for bit (lh and
    index; a pixel's top-K depends on its own path only, so a window is a
    sound check at any frame). ``window`` = (x0, x1, y0, y1) in pixels; the
    maps' first slot is pixel ``origin`` (x, y). Returns the twin's
    seconds."""
    from kbmod_tpu_torch.ops.search_encoded_kernel import search_topk_encoded_shift

    x0, x1, y0, y1 = window
    dev = planes.device
    t0 = time.perf_counter()
    ref_lh, ref_idx = search_topk_encoded_shift(
        planes.psi_codes, planes.phi_codes, torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev),
        float(min_obs), float(min_lh), planes.em, x_min=x0, x_max=x1, y_min=y0, y_max=y1,
        k_results=k_results, **gates)
    sync(dev)
    seconds = time.perf_counter() - t0
    ox, oy = origin
    got_lh, got_idx = lh[:, y0 - oy : y1 - oy, x0 - ox : x1 - ox], idx[:, y0 - oy : y1 - oy, x0 - ox : x1 - ox]
    if not (torch.equal(got_lh.cpu(), ref_lh.cpu()) and torch.equal(got_idx.cpu(), ref_idx.cpu())):
        bad = int((got_lh.cpu() != ref_lh.cpu()).sum() + (got_idx.cpu() != ref_idx.cpu()).sum())
        raise AssertionError(f"window {window}: the search differs from the twin at {bad} slots")
    return seconds
