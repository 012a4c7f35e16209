"""TrajectoryExplorer: interactively evaluate and refine trajectories.

API-compatible with the reference's kbmod.trajectory_explorer
(src/kbmod/trajectory_explorer.py): evaluate single linear/angular
trajectories with full diagnostics (curves, stamps, sigma-G column),
sweep local neighborhoods with a pencil search, and refine results with a
velocity-grid re-search; backed by a cached StackSearch on the device.

Port of the JAX package's trajectory_explorer.py. The StackSearch, the
sigma-G clipper and the stamps run on ``device``: CUDA unless the caller
passes ``device="cpu"``. The StackSearch builds psi/phi once (kernel K1)
and keeps them on the device for every later search, which runs kernel K2.
"""

import logging

import numpy as np

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy
from kbmod_tpu_torch.filters.clustering_filters import NNSweepFilter
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps, append_coadds
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.run_search import configure_kb_search_stack
from kbmod_tpu_torch.search import StackSearch, Trajectory
from kbmod_tpu_torch.trajectory_generator import PencilSearch, VelocityGridSearch
from kbmod_tpu_torch.trajectory_utils import make_trajectory_from_ra_dec
from kbmod_tpu_torch.utils.debug_timer import DebugTimer

logger = logging.getLogger(__name__)


class TrajectoryExplorer:
    """Run test trajectories through KBMOD interactively, on ``device``
    (CUDA unless ``device="cpu"``)."""

    def __init__(self, im_stack, config=None, preload_data=False, device=None):
        self._data_initialized = False
        self.im_stack = im_stack
        self.config = config if config is not None else SearchConfiguration()
        self.preload_data = preload_data
        self.device = resolve_device(device)

        self.clipper = SigmaGClipping(
            self.config["sigmaG_lims"][0],
            self.config["sigmaG_lims"][1],
            2,
            self.config["clip_negative"],
            device=self.device,
        )
        self.search = None

    def initialize_data(self, config=None):
        """Build (or reconfigure) the cached StackSearch."""
        if config is None:
            config = self.config
        if self._data_initialized:
            configure_kb_search_stack(self.search, config)
            return

        if not isinstance(self.im_stack, ImageStackPy):
            raise TypeError("Unsupported image stack type.")
        self.search = StackSearch(
            self.im_stack.sci,
            self.im_stack.var,
            self.im_stack.psfs,
            self.im_stack.zeroed_times,
            self.config["encode_num_bytes"],
            device=self.device,
        )
        configure_kb_search_stack(self.search, config)
        if self.preload_data:
            self.search.preload_psi_phi_array()
        self._data_initialized = True

    def evaluate_linear_trajectory(self, x, y, vx, vy, use_kernel=False):
        """Evaluate one linear pixel-space trajectory with no filtering;
        returns a single-row Results with curves, stamps, and the sigma-G
        validity column."""
        self.initialize_data()

        trj = self.search.search_linear_trajectory(x, y, vx, vy, use_kernel)
        result = Results.from_trajectories([trj])

        num_times = self.im_stack.num_times
        psi_phi = self.search.get_all_psi_phi_curves([trj])
        psi_curve = psi_phi[:, :num_times]
        phi_curve = psi_phi[:, num_times:]
        obs_valid = np.full(psi_curve.shape, True, dtype=bool)
        result.add_psi_phi_data(psi_curve, phi_curve, obs_valid)

        append_coadds(result, self.im_stack, ["sum", "mean", "median"], self.config["stamp_radius"],
                      device=self.device)
        append_all_stamps(result, self.im_stack, self.config["stamp_radius"], device=self.device)

        lh = result.compute_likelihood_curves(filter_obs=True, mask_value=np.nan)
        result.table["sigma_g_res"] = self.clipper.compute_clipped_sigma_g_matrix(lh)
        return result

    def evaluate_angle_trajectory(self, ra, dec, v_ra, v_dec, wcs, use_kernel=False):
        """Evaluate a trajectory specified in sky coordinates."""
        trj = make_trajectory_from_ra_dec(ra, dec, v_ra, v_dec, wcs)
        return self.evaluate_linear_trajectory(trj.x, trj.y, trj.vx, trj.vy, use_kernel)

    def evaluate_around_linear_trajectory(
        self,
        x,
        y,
        vx,
        vy,
        pixel_radius=5,
        max_ang_offset=0.2618,
        ang_step=0.035,
        max_vel_offset=10.0,
        vel_step=0.5,
        use_gpu=True,
    ):
        """Evaluate a pencil of trajectories around the given one at every
        starting pixel within ``pixel_radius``; no filtering."""
        if pixel_radius < 0:
            raise ValueError(f"Pixel radius must be >= 0. Got {pixel_radius}")
        num_pixels = (2 * pixel_radius + 1) ** 2

        trj_generator = PencilSearch(vx, vy, max_ang_offset, ang_step, max_vel_offset, vel_step)
        num_trj = len(trj_generator)

        reduced_config = self.config.copy()
        reduced_config.set("x_pixel_bounds", [x - pixel_radius, x + pixel_radius + 1])
        reduced_config.set("y_pixel_bounds", [y - pixel_radius, y + pixel_radius + 1])
        reduced_config.set("results_per_pixel", min(num_trj, 10_000))
        reduced_config.set("gpu_filter", False)
        reduced_config.set("num_obs", 1)
        reduced_config.set("lh_level", -1e25)
        self.initialize_data(config=reduced_config)

        search_timer = DebugTimer("grid search", logger)
        self.search.search_all(list(trj_generator), use_gpu)
        search_timer.stop()

        trjs = self.search.get_results(0, num_pixels * num_trj)
        return Results.from_trajectories(trjs)

    def refine_linear_trajectory(
        self, x, y, vx, vy, *, pixel_radius=50, max_dv=10.0, dv_steps=21, max_results=1, use_gpu=True
    ):
        """Re-search a velocity grid around the trajectory within
        ``pixel_radius``; returns the best ``max_results`` rows."""
        if pixel_radius < 0:
            raise ValueError(f"Pixel radius must be >= 0. Got {pixel_radius}")
        if max_dv < 0 or dv_steps < 1:
            raise ValueError("max_dv must be >= 0 and dv_steps must be >= 1.")
        if max_results < 1:
            raise ValueError(f"max_results must be >= 1. Got {max_results}")

        trj_generator = VelocityGridSearch(dv_steps, vx - max_dv, vx + max_dv, dv_steps, vy - max_dv, vy + max_dv)
        candidates = list(trj_generator)

        reduced_config = self.config.copy()
        reduced_config.set("x_pixel_bounds", [x - pixel_radius, x + pixel_radius + 1])
        reduced_config.set("y_pixel_bounds", [y - pixel_radius, y + pixel_radius + 1])
        reduced_config.set("results_per_pixel", max_results)
        self.initialize_data(config=reduced_config)

        search_timer = DebugTimer("grid search", logger)
        self.search.search_all(candidates, use_gpu)
        search_timer.stop()

        trjs = self.search.get_results(0, max_results)
        return Results.from_trajectories(trjs)

    def apply_sigma_g(self, result):
        """Apply sigma-G clipping to a Results table in place."""
        apply_clipped_sigma_g(self.clipper, result)


def refine_all_results(
    results, im_stack, config, *, deduplicate=True, pixel_radius=50, max_dv=10.0, dv_steps=21, device=None
):
    """Refine every result with a local velocity-grid re-search, optionally
    deduplicating by start/end-point neighborhoods. One explorer with its
    data preloaded serves every row, so psi/phi are built once."""
    num_res = len(results)
    if num_res == 0:
        return results

    new_trjs = []
    trj_explorer = TrajectoryExplorer(im_stack, config=config, preload_data=True, device=device)
    for idx in range(num_res):
        refined = trj_explorer.refine_linear_trajectory(
            int(results["x"][idx]),
            int(results["y"][idx]),
            float(results["vx"][idx]),
            float(results["vy"][idx]),
            pixel_radius=pixel_radius,
            max_dv=max_dv,
            dv_steps=dv_steps,
            max_results=1,
        )
        new_trjs.append(
            Trajectory(
                x=int(refined["x"][0]),
                y=int(refined["y"][0]),
                vx=float(refined["vx"][0]),
                vy=float(refined["vy"][0]),
                flux=float(refined["flux"][0]),
                lh=float(refined["likelihood"][0]),
                obs_count=int(refined["obs_count"][0]),
            )
        )

    new_results = Results.from_trajectories(new_trjs)
    if "uuid" in results.colnames:
        new_results.table["uuid"] = results["uuid"]
    new_results.sort("likelihood", descending=True)

    if deduplicate:
        zeroed_times = im_stack.zeroed_times
        keep_t0 = NNSweepFilter(pixel_radius, [0.0]).keep_indices(new_results)
        keep_tl = NNSweepFilter(pixel_radius, [zeroed_times[-1]]).keep_indices(new_results)
        keep_inds = np.union1d(keep_t0, keep_tl)
        new_results.filter_rows(keep_inds, "deduplicate")
    return new_results
