"""StackSearch: the orchestrator for one shift-and-stack search.

API-compatible with the reference's C++ StackSearch
(src/kbmod/search/stack_search.{h,cpp}) and the JAX package's
search/stack_search.py: construct from science/variance/PSF stacks + zeroed
times, configure thresholds and bounds, then ``search_all`` a candidate
velocity list and read back filtered, likelihood-sorted results.

The psi/phi planes are built and kept on ``device`` (CUDA by default) by
kernel K1. A float stack (num_bytes -1 or 4) is searched by kernel K2; a
quantized one (num_bytes 1 or 2) keeps uint8/uint16 code planes, is
searched by kernels K3-K5 through the encoded dispatcher, and re-scores its
winners by gathering codes, never building decoded float planes.

The JAX package's result-changing switches are honoured: ``KB_SNAP_ROW_ERROR``
snaps vy onto a row lattice before the search, ``KB_COMPACT_RESULTS=0``
keeps the dense result layout, and ``KB_SIGMAG_MODE``,
``KB_SIGMAG_TOPK_FACTOR`` and ``KB_SIGMAG_AUTO`` reach ``core_search``.

``enable_search_checkpointing`` makes ``search_all`` resumable per row tile
(``search/checkpoint.py``). ``KB_SHARDED`` (``0``, ``1`` or ``auto``, the
default: more than one card and a search on CUDA) shards the search over
``parallel.build_mesh()`` (``parallel.sharded.search_mesh``) in
``KB_SHARD_MODE`` (``candidates``, ``pixels`` or ``time``). Each shard
takes the one-device route (K2, or the encoded dispatcher's K3-K5), so
``KB_SEARCH_KERNEL`` stays a route switch the port ignores.
"""

import logging
import os

import numpy as np

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.ops.psi_phi import PsiPhiArray, fill_psi_phi_array_from_image_arrays
from kbmod_tpu_torch.parallel import sharded
from kbmod_tpu_torch.parallel.sharded import sharded_core_search
from kbmod_tpu_torch.search.checkpoint import checkpointed_core_search
from kbmod_tpu_torch.search.trajectory import Trajectory
from kbmod_tpu_torch.search.trajectory_list import TrajectoryList

logger = logging.getLogger("kbmod.search.run_search")

class _SearchParams:
    """Mirror of the reference's SearchParameters (common.h:119-161)."""

    def __init__(self):
        self.min_observations = 0
        self.min_lh = 0.0
        self.do_sigmag_filter = False
        self.sgl_L = 0.25
        self.sgl_H = 0.75
        self.sigmag_coeff = -1.0
        self.encode_num_bytes = -1
        self.x_start_min = 0
        self.x_start_max = 0
        self.y_start_min = 0
        self.y_start_max = 0
        self.results_per_pixel = 8
        self.total_results = 0


class StackSearch:
    """One search over a stack. ``device`` is where the planes live and the
    kernels run: None means CUDA (raising without a card), "cpu" runs the
    kernels' plain twins. ``timings`` holds the last build and search stage
    times in milliseconds ("psi_phi_ms", "search_ms", "assemble_ms"; with
    checkpointing the stages summed over the computed tiles, plus
    "fingerprint_ms" and the count "tiles_loaded")."""

    def __init__(self, sci_imgs, var_imgs, psf_kernels, zeroed_times, num_bytes=-1, device=None):
        num_imgs = len(sci_imgs)
        if num_imgs == 0:
            raise RuntimeError("No images in the stack to process.")
        if len(var_imgs) != num_imgs:
            raise RuntimeError(
                f"The number of science and variance images do not match. "
                f"Science: {num_imgs}, Variance: {len(var_imgs)}"
            )
        if len(psf_kernels) != num_imgs:
            raise RuntimeError(
                f"The number of science and PSF kernel images do not match. "
                f"Science: {num_imgs}, PSF Kernels: {len(psf_kernels)}"
            )
        if len(zeroed_times) != num_imgs:
            raise RuntimeError(
                f"The number of science images and zeroed times do not match. "
                f"Science: {num_imgs}, Zeroed Times: {len(zeroed_times)}"
            )
        if num_bytes not in (-1, 1, 2, 4):
            raise RuntimeError(f"Invalid encoding size. Must be -1, 1, 2 or 4. Got {num_bytes}")

        self.device = resolve_device(device)
        self.num_imgs = num_imgs
        self._zeroed_times = np.asarray(zeroed_times, dtype=float)
        first = np.asanyarray(sci_imgs[0])
        self._height, self._width = first.shape

        self.params = _SearchParams()
        self.params.encode_num_bytes = num_bytes if num_bytes in (1, 2) else -1
        self.params.x_start_max = self._width
        self.params.y_start_max = self._height

        self.timings = {}
        with tracing.span("build", into=self.timings, key="psi_phi_ms", sync=self.device):
            self.psi_phi_array = PsiPhiArray()
            fill_psi_phi_array_from_image_arrays(
                self.psi_phi_array, num_bytes, sci_imgs, var_imgs, psf_kernels, self._zeroed_times,
                device=self.device,
            )
        self._psi_phi_preloaded = False
        self._checkpoint_dir = None
        self._checkpoint_tile_rows = 256
        self.results = TrajectoryList(0)

    # --- properties (stack_search.cpp:347-353) ---

    @property
    def num_images(self):
        return self.num_imgs

    @property
    def height(self):
        return self._height

    @property
    def width(self):
        return self._width

    @property
    def zeroed_times(self):
        return list(self._zeroed_times)

    def get_num_images(self):
        return self.num_imgs

    def get_image_width(self):
        return self._width

    def get_image_height(self):
        return self._height

    # --- configuration ---

    def set_min_obs(self, new_value):
        if new_value < 0:
            raise RuntimeError(f"min_obs must be >= 0. Got {new_value}")
        if new_value > self.num_imgs:
            raise RuntimeError(
                f"min_obs cannot be greater than the number of images. "
                f"min_obs = {new_value}, num_imgs = {self.num_imgs}."
            )
        self.params.min_observations = new_value

    def set_min_lh(self, new_value):
        self.params.min_lh = new_value

    def enable_search_checkpointing(self, directory, tile_rows=256):
        """Checkpoint the search per starting-pixel row tile: a killed
        ``search_all`` resumes from the finished tiles in ``directory``
        (``search/checkpoint.py``). ``directory=None`` disables it."""
        self._checkpoint_dir = directory
        self._checkpoint_tile_rows = int(tile_rows)

    def set_results_per_pixel(self, new_value):
        if new_value <= 0:
            raise RuntimeError(f"Invalid results per pixel. Got {new_value}")
        self.params.results_per_pixel = new_value

    def enable_gpu_sigmag_filter(self, percentiles, sigmag_coeff, min_lh):
        if (
            len(percentiles) != 2
            or percentiles[0] >= percentiles[1]
            or percentiles[0] <= 0.0
            or percentiles[1] >= 1.0
        ):
            raise RuntimeError(f"Invalid percentiles for sigma G filtering. Got {list(percentiles)}.")
        if sigmag_coeff <= 0.0:
            raise RuntimeError(f"Invalid coefficient for sigma G filtering. Got {sigmag_coeff}.")
        self.params.do_sigmag_filter = True
        self.params.sgl_L = percentiles[0]
        self.params.sgl_H = percentiles[1]
        self.params.sigmag_coeff = sigmag_coeff
        self.params.min_lh = min_lh

    def disable_gpu_sigmag_filter(self):
        self.params.do_sigmag_filter = False

    def set_start_bounds_x(self, x_min, x_max):
        if x_min >= x_max:
            raise RuntimeError(f"Invalid search bounds for the x pixel [{x_min}, {x_max}]")
        self.params.x_start_min = x_min
        self.params.x_start_max = x_max

    def set_start_bounds_y(self, y_min, y_max):
        if y_min >= y_max:
            raise RuntimeError(f"Invalid search bounds for the y pixel [{y_min}, {y_max}]")
        self.params.y_start_min = y_min
        self.params.y_start_max = y_max

    def preload_psi_phi_array(self):
        self.psi_phi_array.move_to_gpu()
        self._psi_phi_preloaded = True

    def unload_psi_phi_array(self):
        self.psi_phi_array.clear_from_gpu()
        self._psi_phi_preloaded = False

    def psi_phi_array_on_gpu(self):
        return self.psi_phi_array.on_gpu

    # --- evaluation ---

    def _eval_planes(self):
        """The planes the search and the gathers take, as a (psi, phi, valid)
        triple: the float planes, or for a quantized stack an
        ``EncodedPlanes`` over the code planes with phi and valid None (the
        JAX package's search/stack_search.py:187-212). The code planes are
        views into the array's interleaved code pairs, which the kernels
        read."""
        arr = self.psi_phi_array
        if arr.meta.num_bytes in (1, 2):
            return search_ops.EncodedPlanes(arr.psi, arr.phi, arr.encode_meta(), arr.code_pairs()), None, None
        return arr.decoded_psi_phi()

    def evaluate_single_trajectory(self, trj, use_kernel=False):
        """Evaluate one trajectory in place (lh, flux, obs_count).

        ``use_kernel=True`` additionally applies the in-kernel sigma-G
        refinement when enabled (kernels.cu:213-241); ``False`` matches
        evaluate_trajectory_cpu (no sigma-G)."""
        psi, phi, valid = self._eval_planes()
        psi_v, phi_v, ok, stats = search_ops._curves_and_stats(
            psi, phi, valid, self._zeroed_times, [trj.x], [trj.y], [trj.vx], [trj.vy]
        )
        trj.obs_count = int(stats["obs_count"][0])
        trj.lh = float(stats["lh"][0])
        trj.flux = float(stats["flux"][0])

        if use_kernel and self.params.do_sigmag_filter:
            p = self.params
            if trj.obs_count < p.min_observations or trj.obs_count == 0 or trj.lh < p.min_lh:
                return
            new_lh, new_flux, _, _ = search_ops.clipped_sigmag_scores(
                psi_v, phi_v, ok, p.sgl_L, p.sgl_H, p.sigmag_coeff
            )
            trj.lh = float(new_lh[0])
            trj.flux = float(new_flux[0])

    def search_linear_trajectory(self, x, y, vx, vy, use_kernel=False):
        result = Trajectory(x=x, y=y, vx=vx, vy=vy)
        self.evaluate_single_trajectory(result, use_kernel)
        return result

    def compute_max_results(self):
        p = self.params
        if p.x_start_min >= p.x_start_max:
            raise RuntimeError(f"Invalid search bounds for the x pixel [{p.x_start_min}, {p.x_start_max}]")
        if p.y_start_min >= p.y_start_max:
            raise RuntimeError(f"Invalid search bounds for the y pixel [{p.y_start_min}, {p.y_start_max}]")
        return (p.x_start_max - p.x_start_min) * (p.y_start_max - p.y_start_min) * p.results_per_pixel

    def _compact_min_lh(self):
        """Row-compaction bound for the raw core-search output.

        ``search_all`` applies ``filter_by_likelihood(min_lh)`` to the raw
        result set unconditionally (stack_search.cpp:267-281), so rows the
        kernel already scored below min_lh can be dropped inside the
        assembly instead of being materialized and filtered. The
        post-filter results are identical. ``KB_COMPACT_RESULTS=0`` keeps
        the dense reference layout (kernels.cu:286).
        """
        if os.environ.get("KB_COMPACT_RESULTS", "1") == "0":
            return None
        return self.params.min_lh

    def search_all(self, search_list, on_gpu=True):
        """Score every candidate at every starting pixel; keep the top
        results_per_pixel per pixel; filter by min_lh/min_obs and sort by
        likelihood (stack_search.cpp:221-284). Traced as the span ``search``.

        ``on_gpu=True`` uses GPU-path semantics (insertion gated by min_obs
        and the in-kernel sigma-G filter when enabled); ``False`` uses
        CPU-path semantics (no gating, no sigma-G, keeps
        min(results_per_pixel, num_candidates) per pixel). Both run on the
        search's device. ``KB_SNAP_ROW_ERROR=<px>`` snaps the candidates' vy
        first (:func:`~kbmod_tpu_torch.ops.search.snap_vy_rows`); the
        snapped vy is searched and reported.
        """
        with tracing.span("search"):
            self._search_all(search_list, on_gpu)

    def _search_all(self, search_list, on_gpu):
        p = self.params
        max_results = self.compute_max_results()
        p.total_results = max_results
        logger.info(
            f"Searching X=[{p.x_start_min}, {p.x_start_max}] Y=[{p.y_start_min}, {p.y_start_max}]\n"
            f"Allocating space for {max_results} results."
        )

        if isinstance(search_list, TrajectoryList):
            cands = search_list.get_arrays()
            vxs, vys = cands["vx"], cands["vy"]
        else:
            vxs = np.array([t.vx for t in search_list], dtype=np.float32)
            vys = np.array([t.vy for t in search_list], dtype=np.float32)
        if len(vxs) == 0:
            raise RuntimeError("No candidate trajectories to search.")

        snap_err = float(os.environ.get("KB_SNAP_ROW_ERROR", "0") or 0.0)
        if snap_err > 0.0:
            vys, n_classes = search_ops.snap_vy_rows(vys, self._zeroed_times, snap_err)
            logger.info(
                f"Row-class snapping (max err {snap_err}px): {len(vys)} candidates -> {n_classes} vy classes."
            )

        if on_gpu:
            rpp = p.results_per_pixel
            gate_min_obs = True
            do_sigmag = p.do_sigmag_filter
        else:
            rpp = min(p.results_per_pixel, len(vxs))
            gate_min_obs = False
            do_sigmag = False

        psi, phi, valid = self._eval_planes()
        common = dict(
            min_obs=p.min_observations,
            min_lh=p.min_lh,
            do_sigmag=do_sigmag,
            sgl_L=p.sgl_L,
            sgl_H=p.sgl_H,
            sigmag_coeff=p.sigmag_coeff,
            gate_min_obs=gate_min_obs,
            compact_min_lh=self._compact_min_lh(),
        )
        if on_gpu and p.min_lh > 0:
            # Gate top-K insertion at min_lh too (same >= as the post-hoc
            # filter, so post-filter results are unchanged): sub-threshold
            # slots then stay empty and the device-side map compaction
            # engages.
            common["gate_min_lh"] = True
        search_fn = search_ops.core_search
        mesh = sharded.search_mesh(self.device)
        if mesh is not None:
            # The mesh-sharded search, as a per-tile search with core_search's
            # signature, so that it composes with checkpointing.
            common["shard_mode"] = sharded.shard_mode()
            logger.info(f"Sharded search over {mesh}, {common['shard_mode']} mode.")

            def search_fn(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp_, **kw):
                return sharded_core_search(
                    psi_, phi_, valid_, times_, vxs_, vys_, mesh,
                    x_min=x0, x_max=x1, y_min=y0, y_max=y1, results_per_pixel=rpp_, **kw,
                )

        args = (psi, phi, valid, self._zeroed_times, vxs, vys,
                p.x_start_min, p.x_start_max, p.y_start_min, p.y_start_max, rpp)
        self.timings = {"psi_phi_ms": self.timings.get("psi_phi_ms", 0.0)}
        if self._checkpoint_dir:
            raw = checkpointed_core_search(
                *args, self._checkpoint_dir, tile_rows=self._checkpoint_tile_rows, search_fn=search_fn,
                timings=self.timings, **common,
            )
        else:
            raw = search_fn(*args, timings=self.timings, **common)
        num_results = len(raw["x"])
        logger.debug(f"Core search returned {num_results} results.")
        tracing.count("rows.listed", num_results)

        with tracing.span("search.list"):
            self.results = TrajectoryList(raw)
            self.results.filter_by_likelihood(p.min_lh)
            self.results.filter_by_obs_count(p.min_observations)
            logger.debug(
                f"After filtering by LH and min_obs {len(self.results)} results "
                f"({num_results - len(self.results)} removed)."
            )
            self.results.sort_by_likelihood()
            self.results.assert_valid()
        tracing.count("rows.searched", len(self.results))

    # --- result access ---

    def get_all_psi_phi_curves(self, trajectories):
        """(N, 2T) matrix of [psi curve | phi curve] per trajectory with 0.0
        at invalid samples (stack_search.cpp:302-318)."""
        if isinstance(trajectories, TrajectoryList):
            arr = trajectories.get_arrays()
            xs, ys, vxs, vys = arr["x"], arr["y"], arr["vx"], arr["vy"]
        else:
            xs = np.array([t.x for t in trajectories], dtype=np.int32)
            ys = np.array([t.y for t in trajectories], dtype=np.int32)
            vxs = np.array([t.vx for t in trajectories], dtype=np.float32)
            vys = np.array([t.vy for t in trajectories], dtype=np.float32)
        psi, phi, valid = self._eval_planes()
        psi_v, phi_v = search_ops.extract_psi_phi_curves(
            psi, phi, valid, self._zeroed_times, xs, ys, vxs, vys
        )
        return np.concatenate([psi_v, phi_v], axis=1)

    def get_number_total_results(self):
        """Current number of stored results (stack_search.h:52)."""
        return len(self.results)

    def get_results(self, start, count):
        logger.debug(f"Reading results [{start}, {start + count})")
        if start < 0:
            raise RuntimeError("start must be >= 0")
        if count <= 0:
            raise RuntimeError("count must be > 0")
        return self.results.get_batch(start, count)

    def get_all_results(self):
        return self.results.get_list()

    def set_results(self, new_results):
        self.results.set_trajectories(new_results)

    def clear_results(self):
        self.results = TrajectoryList(0)
