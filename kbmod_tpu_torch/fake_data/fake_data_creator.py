"""Fake image-stack generation with synthetic moving objects.

Subset of the JAX package's fake_data/fake_data_creator.py (the reference's
kbmod.fake_data.fake_data_creator): night-cadenced fake times,
Gaussian-noise stacks with flat variance, PSF-shaped flux injection, random
masking and artifacts, and a FakeDataSet that bundles them into a WorkUnit.
Values are drawn from the same numpy generator in the same order, so a seed
gives the same stack as the JAX package's. The data is made on the host.
"""

import numpy as np

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.search.trajectory import Trajectory
from kbmod_tpu_torch.work_unit import WorkUnit


def create_fake_times(num_times, t0=0.0, obs_per_day=1, intra_night_gap=0.01, inter_night_gap=1):
    """Timestamps following a survey cadence: ``obs_per_day`` observations
    separated by ``intra_night_gap`` days within a night, nights separated
    by ``inter_night_gap`` days."""
    if num_times <= 0:
        raise ValueError(f"Invalid number of times {num_times}")
    times = []
    day = 0.0
    count = 0
    while len(times) < num_times:
        times.append(t0 + day + count * intra_night_gap)
        count += 1
        if count >= obs_per_day:
            count = 0
            day += inter_night_gap
    return np.array(times[:num_times])


def make_fake_image_stack(height, width, times, noise_level=2.0, psf_val=0.5, psfs=None, rng=None):
    """An ImageStackPy of pure Gaussian noise with flat variance."""
    rng = np.random.default_rng() if rng is None else rng
    times = np.asarray(times)
    sci = [rng.normal(0.0, noise_level, (height, width)).astype(np.float32) for _ in times]
    var = [np.full((height, width), noise_level**2, dtype=np.float32) for _ in times]
    if psfs is None:
        psfs = [PSF.make_gaussian_kernel(psf_val) for _ in times]
    return ImageStackPy(times=times, sci=sci, var=var, psfs=psfs)


def image_stack_add_random_masks(stack, mask_fraction, rng=None):
    """Mask a random fraction of pixels (NaN in sci and var)."""
    rng = np.random.default_rng() if rng is None else rng
    for idx in range(stack.num_times):
        bad = rng.uniform(size=stack.sci[idx].shape) < mask_fraction
        stack.sci[idx][bad] = np.nan
        stack.var[idx][bad] = np.nan


def image_stack_add_random_artifacts(stack, fraction, mean, std, rng=None):
    """Add bright static artifacts (PSF-less point sources) to random
    pixels of each image."""
    rng = np.random.default_rng() if rng is None else rng
    for idx in range(stack.num_times):
        hits = rng.uniform(size=stack.sci[idx].shape) < fraction
        stack.sci[idx][hits] += rng.normal(mean, std, size=int(hits.sum())).astype(np.float32)


def image_stack_add_fake_object(stack, x, y, vx, vy, *, ax=0.0, ay=0.0, flux=100.0):
    """Insert a PSF-convolved moving point source into every image.

    Position at time t: (x + vx*t + 0.5*ax*t^2, y + vy*t + 0.5*ay*t^2)
    snapped to the nearest pixel center (fake_data_creator.py:128-172).
    The SAME cross-correlation of a single flux pixel with kernel k is
    ``flux * k`` flipped and centred on that pixel, each value one rounded
    float32 product, which is what the full-image convolution of the JAX
    package yields; only that footprint is written.
    """
    for idx in range(stack.num_times):
        dt = stack.zeroed_times[idx]
        px = x + vx * dt + 0.5 * ax * dt * dt
        py = y + vy * dt + 0.5 * ay * dt * dt
        ix = int(np.floor(px + 0.5))
        iy = int(np.floor(py + 0.5))
        if ix < 0 or ix >= stack.width or iy < 0 or iy >= stack.height:
            continue
        k = np.asarray(getattr(stack.psfs[idx], "kernel", stack.psfs[idx]), dtype=np.float32)
        kh, kw = k.shape
        ph, pw = kh // 2, kw // 2
        patch = np.float32(flux) * k[::-1, ::-1]
        # Output (y, x) takes tap (iy - y + ph, ix - x + pw).
        y0, x0 = iy - (kh - 1 - ph), ix - (kw - 1 - pw)
        ys, xs = max(0, y0), max(0, x0)
        ye, xe = min(stack.height, y0 + kh), min(stack.width, x0 + kw)
        stack.sci[idx][ys:ye, xs:xe] += patch[ys - y0 : ye - y0, xs - x0 : xe - x0]


class FakeDataSet:
    """A fake image stack plus injected trajectories, convertible to a
    WorkUnit."""

    def __init__(
        self,
        width,
        height,
        times,
        noise_level=2.0,
        psf_val=0.5,
        mask_fraction=0.0,
        artifacts_fraction=0.0,
        artifacts_mean=10.0,
        artifacts_std=5.0,
        psfs=None,
        use_seed=None,
    ):
        self.times = np.asarray(times)
        self.num_times = len(self.times)
        if self.num_times == 0:
            raise ValueError("No times provided.")
        self.width = width
        self.height = height
        self.noise_level = noise_level
        self.mask_fraction = mask_fraction
        self.artifacts_fraction = artifacts_fraction
        self.artifacts_mean = artifacts_mean
        self.artifacts_std = artifacts_std
        self.psf_val = psf_val
        self.psfs = psfs
        self.use_seed = use_seed
        self.rng = np.random.default_rng(use_seed)
        self.trajectories = []
        self.stack_py = None
        self.fake_wcs = None
        self.reset()

    def reset(self):
        """Regenerate the noise stack (drops inserted objects)."""
        self.stack_py = make_fake_image_stack(
            self.height, self.width, self.times,
            noise_level=self.noise_level, psf_val=self.psf_val, psfs=self.psfs, rng=self.rng,
        )
        if self.mask_fraction > 0:
            image_stack_add_random_masks(self.stack_py, self.mask_fraction, rng=self.rng)
        if self.artifacts_fraction > 0:
            image_stack_add_random_artifacts(
                self.stack_py, self.artifacts_fraction, self.artifacts_mean, self.artifacts_std, rng=self.rng
            )
        self.trajectories = []

    def set_wcs(self, new_wcs):
        self.fake_wcs = new_wcs

    def insert_object(self, trj):
        """Insert one trajectory's object into the stack."""
        image_stack_add_fake_object(
            self.stack_py, trj.x, trj.y, trj.vx, trj.vy, flux=trj.flux if trj.flux > 0 else 100.0
        )
        self.trajectories.append(trj)

    def trajectory_is_within_bounds(self, trj):
        """Does the trajectory stay on-chip for all times?"""
        for dt in self.stack_py.zeroed_times:
            ix = int(np.floor(trj.x + trj.vx * dt + 0.5))
            iy = int(np.floor(trj.y + trj.vy * dt + 0.5))
            if ix < 0 or ix >= self.width or iy < 0 or iy >= self.height:
                return False
        return True

    def insert_random_object(self, flux, vx=None, vy=None):
        """Insert an object with random (in-bounds) start and velocity."""
        for _ in range(1000):
            trj = Trajectory(
                x=int(self.rng.integers(0, self.width)),
                y=int(self.rng.integers(0, self.height)),
                vx=self.rng.uniform(-50, 50) if vx is None else vx,
                vy=self.rng.uniform(-50, 50) if vy is None else vy,
                flux=flux,
            )
            if self.trajectory_is_within_bounds(trj):
                self.insert_object(trj)
                return trj
        raise RuntimeError("Failed to find an in-bounds random trajectory.")

    def insert_random_objects_from_generator(self, num_trj, generator, flux):
        """Insert objects whose velocities are drawn from a trajectory
        generator's candidates."""
        vxs, vys = generator.velocity_arrays()
        inserted = []
        for _ in range(num_trj):
            i = int(self.rng.integers(0, len(vxs)))
            trj = self.insert_random_object(flux, vx=float(vxs[i]), vy=float(vys[i]))
            inserted.append(trj)
        return inserted

    def get_work_unit(self, config=None):
        """Bundle the fake data into a WorkUnit."""
        if config is None:
            config = SearchConfiguration()
        elif isinstance(config, dict):
            config = SearchConfiguration.from_dict(config)
        return WorkUnit(
            im_stack=self.stack_py,
            config=config,
            wcs=self.fake_wcs,
            obstimes=self.times,
        )

    def save_fake_data_to_work_unit(self, filename, config=None):
        self.get_work_unit(config).to_fits(filename, overwrite=True)
