"""The one general generator of the benchmark's stacks.

A traffic file (``benchmarks/traffic/<config>.<mix>.json``) holds only
parameters; this module turns them, and a seed, into the inputs of a cell:
the image stacks (science, variance, PSFs, times), the objects injected into
them, and the candidate grid of the search. The same seed gives the same
inputs on the same device, so the reference can make them again after the
window instead of keeping a second copy while the program runs.

Traffic keys read here (see ``benchmarks/README.md``):

- ``stack``: ``height``, ``width``, ``times`` (a list of MJDs, or
  ``{"linspace": [start, span_days, count]}``), ``noise`` (the science
  noise's standard deviation), ``variance`` (the flat variance plane),
  ``psf_sigmas`` (Gaussian PSF sigmas, cycled over the exposures). The
  stacks have no masked pixels.
- ``objects``: ``{"fixed": [[x, y, vx, vy, flux], ...]}`` or ``{"random":
  {"tiers": [[count, flux], ...], "speed": [lo, hi], "angle": [lo, hi],
  "margin": px, "min_separation": px}}``.
- ``grid``: the trajectory generator's configuration
  (``EclipticCenteredSearch``: ``velocities``, ``angles``, ``angle_units``
  radian, ``given_ecliptic``).
- ``distinct_stacks``: how many different stacks the window cycles through.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

# Sub-seeds of one run's distinct stacks: seed * _STRIDE + index, wrapped
# into the 63 bits a torch.Generator takes.
_STRIDE = 1_000_003


@dataclass
class Stack:
    """One stack's host inputs, as a survey user holds them."""

    times: np.ndarray  # (T,) MJD
    sci: np.ndarray  # (T, H, W) float32
    var: list  # T (H, W) float32 planes, one shared flat plane
    psfs: list  # T (k, k) float32 kernels
    objects: list  # (x, y, vx, vy, flux) injected

    @property
    def zeroed_times(self):
        return self.times - self.times[0]


def sub_seed(seed, index):
    return (int(seed) * _STRIDE + int(index)) % (2**63 - 1)


def exposure_times(spec):
    if isinstance(spec, dict):
        start, span, count = spec["linspace"]
        return float(start) + np.linspace(0.0, float(span), int(count))
    return np.asarray(spec, dtype=np.float64)


def gaussian_psf(sigma):
    """A normalised Gaussian kernel of radius int(3 sigma), float32 (the
    reference's PSF.make_gaussian_kernel)."""
    radius = int(3 * sigma)
    ax = np.arange(-radius, radius + 1)
    xx, yy = np.meshgrid(ax, ax)
    kernel = np.exp(-0.5 * (xx**2 + yy**2) / sigma**2)
    return (kernel / np.sum(kernel)).astype(np.float32)


def random_objects(rng, spec, height, width, span):
    """Objects whose paths stay ``margin`` pixels inside the frame over the
    span, each (start, end) point at least ``min_separation`` from every
    other's in the 4-D (x0, x1, y0, y1) space, so no two can be clustered
    together. Tiers are filled in order."""
    margin = float(spec["margin"])
    lo, hi = spec["speed"]
    a_lo, a_hi = spec["angle"]
    min_sep = float(spec["min_separation"])
    fluxes = [float(flux) for count, flux in spec["tiers"] for _ in range(int(count))]
    objects, points = [], []
    for _ in range(1000 * len(fluxes)):
        if len(objects) == len(fluxes):
            break
        speed, ang = rng.uniform(lo, hi), rng.uniform(a_lo, a_hi)
        vx, vy = speed * math.cos(ang), speed * math.sin(ang)
        rx, ry = vx * span, vy * span
        x_lo, x_hi = margin + max(0.0, -rx), width - margin - max(0.0, rx)
        y_lo, y_hi = margin + max(0.0, -ry), height - margin - max(0.0, ry)
        if x_lo >= x_hi or y_lo >= y_hi:
            continue
        x, y = rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)
        p = np.array([x, x + rx, y, y + ry])
        if points and min(np.linalg.norm(p - q) for q in points) < min_sep:
            continue
        points.append(p)
        objects.append((float(x), float(y), float(vx), float(vy), fluxes[len(objects)]))
    if len(objects) != len(fluxes):
        raise ValueError(f"could not place {len(fluxes)} objects in a {height} x {width} frame")
    return objects


def inject(sci, zeroed_times, psfs, objects):
    """Add flux * PSF at each object's pixel (floor(x + v t + 0.5)) in every
    exposure, clipped at the frame's edges; exposures where the centre is
    off the frame get nothing (the fake-data creator's rule)."""
    T, H, W = sci.shape
    for x, y, vx, vy, flux in objects:
        for t in range(T):
            ix = int(math.floor(x + vx * zeroed_times[t] + 0.5))
            iy = int(math.floor(y + vy * zeroed_times[t] + 0.5))
            if not (0 <= ix < W and 0 <= iy < H):
                continue
            k = psfs[t]
            kh, kw = k.shape
            patch = np.float32(flux) * k[::-1, ::-1]
            y0, x0 = iy - (kh - 1 - kh // 2), ix - (kw - 1 - kw // 2)
            ys, xs = max(0, y0), max(0, x0)
            ye, xe = min(H, y0 + kh), min(W, x0 + kw)
            sci[t, ys:ye, xs:xe] += patch[ys - y0 : ye - y0, xs - x0 : xe - x0]


def make_stack(traffic, seed, index, device):
    """Stack ``index`` of a run with ``seed``: the noise drawn on ``device``
    by one torch.Generator in one call, then brought to the host once."""
    spec = traffic["stack"]
    H, W = int(spec["height"]), int(spec["width"])
    times = exposure_times(spec["times"])
    T = len(times)
    zeroed = times - times[0]
    s = sub_seed(seed, index)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    noise = torch.randn((T, H, W), generator=gen, device=device, dtype=torch.float32)
    noise.mul_(float(spec["noise"]))
    sci = noise.cpu().numpy()
    del noise
    sigmas = spec["psf_sigmas"]
    psfs = [gaussian_psf(float(sigmas[t % len(sigmas)])) for t in range(T)]
    obj_spec = traffic["objects"]
    if "fixed" in obj_spec:
        objects = [tuple(float(v) for v in o) for o in obj_spec["fixed"]]
    else:
        rng = np.random.default_rng(s)
        objects = random_objects(rng, obj_spec["random"], H, W, float(zeroed[-1]))
    inject(sci, zeroed, psfs, objects)
    var = [np.full((H, W), float(spec["variance"]), dtype=np.float32)] * T
    return Stack(times=times, sci=sci, var=var, psfs=psfs, objects=objects)


def make_stacks(traffic, seed, device):
    return [make_stack(traffic, seed, i, device) for i in range(int(traffic.get("distinct_stacks", 1)))]


def candidate_grid(grid):
    """(vxs, vys) float32 of an EclipticCenteredSearch grid, angle-major as
    the reference's generator yields them: angle i = ecliptic + lo + i *
    step, speed j = lo + j * step, vx = cos(angle) * speed."""
    if grid["name"] != "EclipticCenteredSearch":
        raise ValueError(f"unsupported grid {grid['name']}")
    if grid.get("angle_units", "radian") != "radian":
        raise ValueError("grid angles must be in radians")
    v_lo, v_hi, n_v = grid["velocities"]
    a_lo, a_hi, n_a = grid["angles"]
    ecl = float(grid.get("given_ecliptic") or 0.0)
    n_v, n_a = int(n_v), int(n_a)
    v_step = (v_hi - v_lo) / float(n_v - 1) if n_v > 1 else 0.0
    a_min, a_max = ecl + a_lo, ecl + a_hi
    a_step = (a_max - a_min) / float(n_a - 1) if n_a > 1 else 0.0
    vxs, vys = [], []
    for i in range(n_a):
        ang = a_min + i * a_step
        for j in range(n_v):
            vel = v_lo + j * v_step
            vxs.append(math.cos(ang) * vel)
            vys.append(math.sin(ang) * vel)
    return np.asarray(vxs, dtype=np.float32), np.asarray(vys, dtype=np.float32)


def start_bounds(settings, height, width):
    """((x0, x1), (y0, y1)) of the start pixels searched: explicit
    ``{x,y}_pixel_bounds``, else the frame widened by a positive
    ``{x,y}_pixel_buffer`` on both sides, else the frame (the reference's
    run_search rule)."""

    def axis(name, extent):
        bounds = settings.get(f"{name}_pixel_bounds")
        if bounds and len(bounds) == 2:
            return int(bounds[0]), int(bounds[1])
        buffer = settings.get(f"{name}_pixel_buffer")
        if buffer and buffer > 0:
            return -int(buffer), extent + int(buffer)
        return 0, extent

    return axis("x", width), axis("y", height)


def evals_per_stack(settings, traffic):
    """Start pixels searched x candidates of one stack."""
    (x0, x1), (y0, y1) = start_bounds(settings, int(traffic["stack"]["height"]), int(traffic["stack"]["width"]))
    vxs, _ = candidate_grid(traffic["grid"])
    return (x1 - x0) * (y1 - y0) * len(vxs)
