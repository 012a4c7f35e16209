"""SearchRunner: the top-level KBMOD search pipeline of the port.

Port of the JAX package's run_search.py (API-compatible with the reference's
kbmod.run_search): image QA, candidate generation, the core device search,
sigma-G filtering, clustering, stamp generation, results file writing, with
per-phase wall-time/memory stats and a soft timeout.

``SearchRunner(config=None, device=None)`` runs on CUDA unless the caller
asks for the CPU (``device="cpu"``, here or in ``run_search``); its resolved
device is where the search, the sigma-G clipping and the coadds run.
``config["cpu_only"]`` keeps the reference's meaning: the search's CPU-path
semantics (``search_all(..., on_gpu=False)``), not a choice of device.

``cnn_filter`` vets the stamps with the port's ResNet; it needs a weights
file (``cnn_model``), and the repository ships none.

``KB_SEARCH_CKPT_DIR`` (with ``KB_SEARCH_CKPT_TILE_ROWS``, default 256)
checkpoints the search per row tile, so that a killed run resumes
mid-search; ``KB_PROFILE_DIR`` traces the whole run with ``torch.profiler``
(CPU and CUDA activities) into a Chrome trace file there.

Not ported yet, and refused rather than ignored: WorkUnit inputs and RA/Dec
output (they need the port's WorkUnit).
"""

import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

from kbmod_tpu_torch.device import device_free_bytes, resolve_device
from kbmod_tpu_torch.filters.clustering_filters import apply_clustering
from kbmod_tpu_torch.filters.clustering_grid import apply_trajectory_grid_filter
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
from kbmod_tpu_torch.filters.sns_filters import peak_offset_filter, predictive_line_cluster
from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps, append_coadds, filter_stamps_by_cnn
from kbmod_tpu_torch.ops.psi_phi import _conv_batch_budget, _padded_width
from kbmod_tpu_torch.ops.search import (
    EVAL_CHUNK, EXACT_BYTES_PER_SAMPLE, EXACT_CHUNK_SAMPLES, EXACT_ROW_TILE, sigmag_pool_factor,
)
from kbmod_tpu_torch.ops.search_kernel import K2_CHUNK
from kbmod_tpu_torch.parallel.sharded import TIME_CHUNK_ELEMENTS, search_mesh
from kbmod_tpu_torch.results import Results, write_results_to_files_destructive
from kbmod_tpu_torch.search import StackSearch, TrajectoryList
from kbmod_tpu_torch.trajectory_generator import create_trajectory_generator

logger = logging.getLogger("kbmod.run_search")

# Rows of psi/phi curves load_and_filter_results gathers and clips at once.
RESULTS_BATCH = 100_000
# Device bytes one (row, time) sample of a gather holds at most: the int64
# pixel and index tensors, the masks and the gathered float32 values
# (ops/search.py ``_gather_curves``).
GATHER_BYTES_PER_SAMPLE = 96
# Device bytes one curve sample holds while torch.nanquantile sorts it.
QUANTILE_BYTES_PER_SAMPLE = 64
# The elements of one band of the dedup expansion (search_plan.py
# ``_expand_topk_classes``), and the bytes each holds there.
EXPAND_BAND = 1 << 24
EXPAND_BYTES_PER_ELEMENT = 64


def _resolve_start_bounds(config, axis, image_extent):
    """Starting-pixel bounds along one axis, or None for the image default.

    Explicit ``{x,y}_pixel_bounds`` win; otherwise a positive
    ``{x,y}_pixel_buffer`` widens the image extent symmetrically so
    trajectories may start off-chip and drift on.
    """
    bounds = config[f"{axis}_pixel_bounds"]
    if bounds and len(bounds) == 2:
        return int(bounds[0]), int(bounds[1])
    buffer = config[f"{axis}_pixel_buffer"]
    if buffer and buffer > 0:
        return -int(buffer), image_extent + int(buffer)
    return None


def configure_kb_search_stack(search, config):
    """Push a SearchConfiguration's filtering, bounds, and in-kernel
    sigma-G settings into a StackSearch (binding surface of the reference's
    run_search.py:25-72), and the per-row-tile checkpointing of
    ``KB_SEARCH_CKPT_DIR`` (tiles of ``KB_SEARCH_CKPT_TILE_ROWS`` rows)."""
    search.set_min_obs(int(config["num_obs"]))
    search.set_min_lh(config["lh_level"])
    search.set_results_per_pixel(config["results_per_pixel"])

    x_bounds = _resolve_start_bounds(config, "x", search.get_image_width())
    if x_bounds is not None:
        search.set_start_bounds_x(*x_bounds)
    y_bounds = _resolve_start_bounds(config, "y", search.get_image_height())
    if y_bounds is not None:
        search.set_start_bounds_y(*y_bounds)

    if config["sigmaG_filter"] and config["gpu_filter"]:
        lo, hi = config["sigmaG_lims"]
        logger.debug(f"In-kernel sigma-G enabled (percentiles [{lo}, {hi}]).")
        search.enable_gpu_sigmag_filter(
            np.array([lo, hi]) / 100.0,
            SigmaGClipping.find_sigma_g_coeff(lo, hi),
            config["lh_level"],
        )
    else:
        search.disable_gpu_sigmag_filter()

    # Per-row-tile checkpoints, so that a killed pipeline resumes mid-search
    # (the JAX package's run_search.py:81-90; env-gated to keep the
    # configuration's schema the reference's).
    ckpt_dir = os.environ.get("KB_SEARCH_CKPT_DIR")
    if ckpt_dir:
        search.enable_search_checkpointing(ckpt_dir, tile_rows=checkpoint_tile_rows())
    search.clear_results()


def checkpoint_tile_rows():
    """Rows of a checkpoint tile: ``KB_SEARCH_CKPT_TILE_ROWS``, default 256."""
    return int(os.environ.get("KB_SEARCH_CKPT_TILE_ROWS", "256"))


def search_memory_budget(config, stack, num_candidates, device):
    """The most device memory, in bytes, the port allocates for
    ``do_core_search`` on this configuration and stack, term by term (each
    an upper bound; "total" is their sum):

    - planes: the kept float psi/phi/validity planes (9 bytes a pixel and
      time) or the interleaved uint8/uint16 code pairs (2 or 4 bytes);
    - build: the build's transients: K1's float inputs and outputs for a
      PSF batch of images (48 bytes a pixel with the quantized build's
      encode temporaries), and for the float path the unpacked planes and
      masks the packing holds beside the kept ones;
    - padding: K2's copy of the float planes when the width is not a
      multiple of its 16-pixel chunk;
    - maps: the (K', SH, SW) lh/index maps (8 bytes a slot), K' = the
      pool factor (``KB_SIGMAG_TOPK_FACTOR``, default 4) times K under the
      in-kernel sigma-G pool, and their compaction on the card (17: the
      mask, int64 positions, the values);
    - expand: the dedup expansion of the quantized search (a second set of
      maps and one band of its sort);
    - layouts: the offsets and the grouped kernels' window layouts;
    - gathers: one EVAL_CHUNK-row winner re-scoring gather over all T;
    - curves: one RESULTS_BATCH-row curve gather and its sigma-G quantiles;
    - exact: under ``KB_SIGMAG_MODE=exact``, the decoded planes of a
      quantized stack (9 bytes a pixel and time), one candidate chunk's
      curves over a row tile (EXACT_BYTES_PER_SAMPLE a sample) and the
      tile's lists with their merge sort (24 bytes a slot);
    - checkpoint: under ``KB_SEARCH_CKPT_DIR`` the fingerprint's digest of
      one plane (three int64 words an element of the widest plane set);
      the maps, expansion, gathers and exact-mode terms then count one
      tile of ``KB_SEARCH_CKPT_TILE_ROWS`` rows instead of the window;
    - shards: when ``search_all`` shards (``parallel.sharded.search_mesh``):
      in candidates mode the K'-deep maps of each shard on this device and,
      in a group, of each process's merge (8 bytes a slot), and one step of
      the merge, which takes one part at a time (two parts' maps, their
      sort with int64 order, the copy and the output: 64 bytes a slot); in
      pixels mode the shards' rows and their concatenation, and as much
      again for the processes' (16 bytes a slot each); in time mode one
      candidate chunk's sums, partial sums, gathers and lh temporaries and
      its merge (128 bytes a (candidate, pixel) slot of the chunk, at most
      ``TIME_CHUNK_ELEMENTS`` or one candidate's pixels) and the merge's
      sort and output (28 bytes a slot).
    """
    T, H, W = stack.num_times, stack.height, stack.width
    C = int(num_candidates)
    nb = int(config["encode_num_bytes"])
    quantized = nb in (1, 2)

    def extent(axis, image_extent):
        bounds = _resolve_start_bounds(config, axis, image_extent)
        return image_extent if bounds is None else bounds[1] - bounds[0]

    SH, SW = extent("y", H), extent("x", W)
    ckpt = bool(os.environ.get("KB_SEARCH_CKPT_DIR"))
    # The rows whose maps one search holds at a time.
    SHs = min(SH, checkpoint_tile_rows()) if ckpt else SH
    on_gpu = not config["cpu_only"]
    k = int(config["results_per_pixel"])
    if not on_gpu:
        k = min(k, C)
    sigmag_pool = on_gpu and config["sigmaG_filter"] and config["gpu_filter"]
    exact = sigmag_pool and os.environ.get("KB_SIGMAG_MODE", "overprovision") == "exact"
    over = sigmag_pool_factor()
    k_search = max(min(C, over * k if sigmag_pool and not exact else k), k)

    px, hw = T * H * W, H * W
    # Images of one PSF batch of the build (ops/psi_phi.py), doubled where
    # there are several batches: the next batch's inputs arrive while the
    # last one's are still held.
    batch = min(T, max(1, int(_conv_batch_budget(device) // (16 * hw))))
    live = batch * (2 if batch < T else 1)
    terms = {}
    if quantized:
        terms["planes"] = 2 * nb * T * H * _padded_width(W)
        terms["build"] = 48 * live * hw
        terms["padding"] = 0
        terms["expand"] = 16 * k_search * SHs * SW + EXPAND_BAND * EXPAND_BYTES_PER_ELEMENT
    else:
        terms["planes"] = 9 * px
        terms["build"] = max(8 * px + 16 * live * hw, 11 * px)
        terms["padding"] = 0 if W % K2_CHUNK == 0 else 9 * T * H * (-(-W // K2_CHUNK) * K2_CHUNK)
        terms["expand"] = 0
    terms["maps"] = (8 + 17) * k_search * SHs * SW
    terms["layouts"] = 16 * C * T + 52 * C * T + 16 * C
    terms["gathers"] = GATHER_BYTES_PER_SAMPLE * min(EVAL_CHUNK, k_search * SHs * SW) * T
    rows = min(RESULTS_BATCH, k_search * SH * SW)
    terms["curves"] = (GATHER_BYTES_PER_SAMPLE + QUANTILE_BYTES_PER_SAMPLE) * rows * T
    terms["exact"] = 0
    if exact:
        tile = min(EXACT_ROW_TILE, SHs) * SW
        chunk = max(1, EXACT_CHUNK_SAMPLES // (tile * T))
        terms["exact"] = (
            (9 * px if quantized else 0)
            + EXACT_BYTES_PER_SAMPLE * min(chunk, C) * tile * T
            + 24 * (k_search + min(chunk, C)) * tile
        )
    terms["checkpoint"] = 48 * H * _padded_width(W) if ckpt else 0
    terms["shards"] = 0
    mesh = search_mesh(device)
    if mesh is not None:
        slots = k_search * SHs * SW
        mode = os.environ.get("KB_SHARD_MODE", "candidates")
        if mode == "time":
            chunk = min(max(C, 1), max(1, TIME_CHUNK_ELEMENTS // (SHs * SW)))
            terms["shards"] = 128 * chunk * SHs * SW + 28 * slots
        elif mode == "pixels":
            terms["shards"] = 16 * (2 if mesh.world_size > 1 else 1) * slots
        else:
            here = sum(d == mesh.root for d in mesh.devices)
            gathered = mesh.world_size if mesh.world_size > 1 else 0
            terms["shards"] = (8 * (here + gathered) + 64) * slots
    terms["total"] = sum(terms.values())
    return terms


def check_gpu_memory(config, stack, trj_generator=None, device=None):
    """Whether the search fits the card's free memory, by the port's own
    budget (:func:`search_memory_budget`), which counts what the port
    allocates. The JAX package budgets its TPU word stream instead."""
    dev = resolve_device(device)
    num_candidates = 0 if trj_generator is None else len(trj_generator)
    budget = search_memory_budget(config, stack, num_candidates, dev)
    free = device_free_bytes(dev)
    logger.debug(
        f"Device memory check: need {budget['total'] / 2**30:.2f} GiB "
        f"({ {kk: round(vv / 2**30, 2) for kk, vv in budget.items()} }), free {free / 2**30:.2f} GiB"
    )
    return free > budget["total"]


@contextmanager
def profiled(profile_dir, device):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA on a
    card) into a Chrome trace ``kbmod_trace_<pid>_<ms>.json`` under
    ``profile_dir``; no tracing when ``profile_dir`` is empty or None. The
    trace is stopped and written in a ``finally``, so a failing run still
    leaves it. The port's kernel wrappers mark their launches
    ("kbmod K1 psi_phi_conv", ...) with ``record_function``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, f"kbmod_trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        logger.info(f"Profile trace written to {path}.")


def stat_gpu_memory_mb(device):
    """Human-readable device memory stats."""
    if device.type != "cuda":
        return "No CUDA device in use."
    used = torch.cuda.memory_allocated(device) / (1024.0 * 1024.0)
    total = torch.cuda.get_device_properties(device).total_memory / (1024.0 * 1024.0)
    return f"Device memory: {used:.2f} MB allocated of {total:.2f} MB total."


class SearchRunner:
    """Runs the KBMOD grid search with per-phase stats and soft timeout.

    ``device``: where the search, the sigma-G clipping and the coadds run;
    None means CUDA (raising without a card when a run starts), "cpu" runs
    the kernels' plain twins. ``run_search(..., device=...)`` overrides it.
    """

    def __init__(self, config=None, device=None):
        self.phase_times = {}
        self.phase_memory = {}
        self.timeout = None
        self.debug = False
        self.config = None
        self._device = device
        self.device = None if device is None else resolve_device(device)
        self.apply_config(config)

    def apply_config(self, config):
        if config is None:
            return
        config.validate()
        self.config = config
        if config["debug"]:
            logging.basicConfig(level=logging.DEBUG)
            self.debug = True
        if self.timeout is None and config["timeout_hours"] is not None:
            self.timeout = time.time() + config["timeout_hours"] * 3600.0
            logger.debug(f"Search will timeout at {time.ctime(self.timeout)}.")

    def _check_timeout(self):
        """Soft timeout, checked only between phases."""
        if self.timeout is not None and time.time() > self.timeout:
            self.display_phase_stats()
            raise TimeoutError("Search has exceeded the maximum allowed time.")

    def _rss(self):
        if psutil is None:
            return 0
        return psutil.Process().memory_info().rss

    def _start_phase(self, phase_name):
        self._check_timeout()
        logger.debug(f"Starting {phase_name}.")
        self.phase_times[phase_name] = [time.time(), None]
        self.phase_memory[phase_name] = [self._rss(), None]

    def _end_phase(self, phase_name):
        self._check_timeout()
        if phase_name not in self.phase_times:
            raise KeyError(f"Phase {phase_name} has not been started.")
        self.phase_times[phase_name][1] = time.time()
        delta_t = self.phase_times[phase_name][1] - self.phase_times[phase_name][0]
        logger.debug(f"Finished {phase_name} in {delta_t} seconds.")
        self.phase_memory[phase_name][1] = self._rss()

    def display_phase_stats(self):
        for phase in self.phase_times:
            print(f"{phase}:")
            if self.phase_times[phase][1] is not None:
                print(f"    Time (sec) = {self.phase_times[phase][1] - self.phase_times[phase][0]}")
            else:
                print("    Time (sec) = Unfinished")
            print(f"    Memory Start (mb) = {self.phase_memory[phase][0] / (1024.0 * 1024.0)}")
            if self.phase_memory[phase][1] is not None:
                print(f"    Memory End (mb) = {self.phase_memory[phase][1] / (1024.0 * 1024.0)}")
            else:
                print("    Memory End (mb) = Unfinished")

    def load_and_filter_results(self, search, config, batch_size=RESULTS_BATCH):
        """Compile raw search results into a Results table, attaching
        psi/phi curves and applying sigma-G + stats refiltering in batches
        (reference run_search.py:251-337). The clipping runs on the
        runner's device, or the search's when the runner has none yet."""
        self._start_phase("load_and_filter_results")
        num_times = search.get_num_images()

        bnds = config["sigmaG_lims"] if config["sigmaG_lims"] is not None else [25, 75]
        clipper = SigmaGClipping(bnds[0], bnds[1], 2, config["clip_negative"], device=self.device or search.device)

        keep = Results(track_filtered=config["track_filtered"])

        result_list = search.results  # TrajectoryList (struct of arrays)
        num_raw = len(result_list)
        logger.info(f"Device search produced {num_raw} raw trajectories.")
        if num_raw < 1:
            self._end_phase("load_and_filter_results")
            return keep
        arrays = result_list.get_arrays()
        logger.info(f"Raw likelihood range: [{arrays['lh'][-1]}, {arrays['lh'][0]}]")

        # Near-duplicate prefilter on the raw trajectories (vectorized grid).
        if config["near_dup_thresh"] is not None and config["near_dup_thresh"] > 0:
            self._start_phase("near duplicate removal")
            bin_width = config["near_dup_thresh"]
            zt = np.asarray(search.zeroed_times)
            max_dt = float(np.max(zt) - np.min(zt))
            arrays, _ = apply_trajectory_grid_filter(arrays, bin_width, max_dt)
            logger.info(
                f"Near-duplicate grid prefilter (bin={bin_width}px, dt={max_dt}): "
                f"{len(arrays['x'])} of {num_raw} kept."
            )
            self._end_phase("near duplicate removal")

        num_kept = len(arrays["x"])
        batches = []
        batch_start = 0
        while batch_start < num_kept:
            self._check_timeout()
            batch_end = min(batch_start + batch_size, num_kept)
            batch = {k: v[batch_start:batch_end] for k, v in arrays.items()}
            batch_results = Results.from_trajectories(TrajectoryList(batch), track_filtered=config["track_filtered"])

            if config["generate_psi_phi"]:
                psi_phi_batch = search.get_all_psi_phi_curves(TrajectoryList(batch))
                batch_results.add_psi_phi_data(psi_phi_batch[:, :num_times], psi_phi_batch[:, num_times:])

            if config["sigmaG_filter"]:
                if not config["generate_psi_phi"]:
                    raise ValueError("Unable to do sigma-G filtering without psi and phi curves.")
                apply_clipped_sigma_g(clipper, batch_results)
                row_mask = np.asarray(batch_results["obs_count"]) >= config["num_obs"]
                if config["lh_level"] > 0.0:
                    row_mask = row_mask & (np.asarray(batch_results["likelihood"]) >= config["lh_level"])
                batch_results.filter_rows(row_mask, "sigma-g")
                logger.debug(f"After sigma-G filtering, batch size = {len(batch_results)}")

            batches.append(batch_results)
            batch_start += batch_size

        # One vstack for the whole loop: per-batch extend() is quadratic
        # in total rows.
        keep.extend_batches(batches)
        self._end_phase("load_and_filter_results")
        return keep

    def do_core_search(self, config, stack, trj_generator):
        """Build the psi/phi array, run the device search, and load the
        filtered results (reference run_search.py:339-394). On a card the
        port's memory budget must fit first."""
        self._start_phase("do_core_search")
        if self.device is None:
            self.device = resolve_device(self._device)

        use_gpu = not config["cpu_only"]
        if use_gpu and self.device.type == "cuda" and not check_gpu_memory(
            config, stack, trj_generator, self.device
        ):
            raise ValueError("Insufficient device memory to conduct the search.")

        search = StackSearch(
            stack.sci,
            stack.var,
            stack.psfs,
            stack.zeroed_times,
            config["encode_num_bytes"],
            device=self.device,
        )
        configure_kb_search_stack(search, config)

        self._start_phase("grid search")
        logger.debug(f"Trajectory Generator: {trj_generator}")
        vxs, vys = trj_generator.velocity_arrays()
        candidates = TrajectoryList(
            {
                "x": np.zeros(len(vxs), dtype=np.int32),
                "y": np.zeros(len(vxs), dtype=np.int32),
                "vx": vxs,
                "vy": vys,
                "lh": np.zeros(len(vxs), dtype=np.float32),
                "flux": np.zeros(len(vxs), dtype=np.float32),
                "obs_count": np.zeros(len(vxs), dtype=np.int32),
            }
        )
        logger.debug(f"Using {len(candidates)} candidates per pixel.")
        try:
            search.search_all(candidates, use_gpu)
        except Exception:
            logger.error("Error during grid search. Cleaning up memory.")
            del search
            raise
        self._end_phase("grid search")

        keep = self.load_and_filter_results(search, config)
        del search
        self._end_phase("do_core_search")
        return keep

    def _truncate_to_max_results(self, keep, config):
        """Cap the row count at config max_results (best likelihood first),
        after all trajectory-space filtering and before stamps are attached
        (reference run_search.py:482-490 for the ordering contract)."""
        limit = config["max_results"]
        if limit <= -1 or len(keep) <= limit:
            return
        self._start_phase("max_results")
        logger.info(f"Keeping the {limit} highest-likelihood of {len(keep)} rows.")
        keep.sort("likelihood", descending=True)
        keep.filter_rows(np.arange(limit), "max_results")
        self._end_phase("max_results")

    def _stamp_phase(self, keep, config, stack):
        """Attach coadd stamps, then run every stamp-space vetting step.

        One umbrella phase wraps four config-gated sub-steps; the set of
        steps and their order is the reference's pipeline contract
        (run_search.py:492-531): coadds (always, plus the legacy "stamp"
        alias), peak-offset veto, predictive line clustering, CNN vetting
        (not ported yet: it raises), and optionally the full per-time stamp
        cube.
        """
        radius = config["stamp_radius"]
        legacy = config["stamp_type"]
        self._start_phase("stamp generation")

        self._start_phase("appending co-adds")
        append_coadds(keep, stack, set(config["coadds"]) | {legacy}, radius,
                      nightly=config["nightly_coadds"], device=self.device)
        if f"coadd_{legacy}" in keep.colnames:
            keep.table["stamp"] = keep.table[f"coadd_{legacy}"]
        self._end_phase("appending co-adds")

        if config["peak_offset_max"] is not None:
            self._start_phase("peak_offset_filtering")
            peak_offset_filter(keep, peak_offset_max=config["peak_offset_max"])
            self._end_phase("peak_offset_filtering")

        if config["pred_line_cluster"]:
            params = config["pred_line_params"]
            if len(params) != 3:
                raise ValueError(f"pred_line_params needs [dist_lim, min_samples, proc_dist], got {params}")
            self._start_phase("predictive_line_clustering")
            predictive_line_cluster(keep, stack.times, *params)
            self._end_phase("predictive_line_clustering")

        if config["cnn_filter"]:
            if config["cnn_model"] is None:
                raise ValueError("cnn_filter requires cnn_model.")
            self._start_phase("cnn filtering")
            filter_stamps_by_cnn(
                keep,
                config["cnn_model"],
                model_type=config["cnn_model_type"],
                coadd_type=config["cnn_coadd_type"],
                stamp_radius=config["cnn_stamp_radius"],
                coadd_radius=radius,
                device=self.device,
            )
            self._end_phase("cnn filtering")

        if config["save_all_stamps"]:
            append_all_stamps(keep, stack, radius, device=self.device)
        self._end_phase("stamp generation")

    def run_search(self, config, stack, trj_generator=None, workunit=None, extra_meta=None, device=None):
        """The highest-level entry: search an ImageStackPy with a
        SearchConfiguration (reference run_search.py:396-593) on
        ``device`` (default: the runner's, else CUDA). Raises
        NotImplementedError for a WorkUnit. With ``KB_PROFILE_DIR`` set the
        whole run is traced (:func:`profiled`)."""
        if workunit is not None:
            raise NotImplementedError("SearchRunner.run_search: WorkUnit inputs wait for the port's WCS and WorkUnit")
        if device is not None:
            self._device = device
        self.device = resolve_device(self._device)
        with profiled(os.environ.get("KB_PROFILE_DIR"), self.device):
            return self._run_search(config, stack, trj_generator, extra_meta)

    def _run_search(self, config, stack, trj_generator, extra_meta):
        self.apply_config(config)
        if self.debug:
            logger.debug(f"Device: {self.device}, CUDA available: {torch.cuda.is_available()}")
            logger.debug(stat_gpu_memory_mb(self.device))
            logger.debug(str(config))

        # Image QA: drop overly-masked images.
        if config["max_masked_pixels"] < 1.0:
            keep_mask = stack.get_masked_fractions() <= config["max_masked_pixels"]
            stack.filter_images(keep_mask)
        logger.debug(f"Searching over {stack.num_times} images after the obs-validity cut.")

        # num_obs can never exceed the number of usable (<90% masked)
        # images; -1 means "derive it from the stack".
        usable = int(np.count_nonzero(stack.get_masked_fractions() < 0.9))
        if usable == 0:
            raise ValueError("No valid images in input.")
        if config["num_obs"] == -1 or config["num_obs"] >= usable:
            logger.info(f"num_obs={config['num_obs']} capped to the {usable} usable images.")
            config.set("num_obs", usable)

        self._start_phase("KBMOD")

        trj_generator = trj_generator or create_trajectory_generator(config, work_unit=None)
        keep = self.do_core_search(config, stack, trj_generator)

        if config["do_clustering"] and len(keep) > 1:
            self._start_phase("clustering")
            cluster_params = {
                key: config[key] for key in ("cluster_type", "cluster_eps", "cluster_v_scale")
            }
            cluster_params["times"] = np.asarray(stack.times)
            apply_clustering(keep, cluster_params)
            self._end_phase("clustering")

        self._truncate_to_max_results(keep, config)
        self._stamp_phase(keep, config, stack)

        # Save results + metadata.
        self._start_phase("write results")
        meta_to_save = dict(extra_meta) if extra_meta is not None else {}
        meta_to_save["num_img"] = stack.num_times
        meta_to_save["dims"] = (stack.width, stack.height)
        keep.set_mjd_utc_mid(np.array(stack.times))

        if config["result_filename"] is not None:
            write_results_to_files_destructive(
                config["result_filename"],
                keep,
                extra_meta=meta_to_save,
                separate_col_files=config["separate_col_files"],
                drop_columns=config["drop_columns"],
                overwrite=True,
            )
            if config["save_config"]:
                # The run's exact config goes to a <stem>_provenance/ dir
                # next to the results file (the layout the reference's
                # readers expect; run_search.py:575-585). Needs PyYAML.
                from pathlib import Path

                result_path = Path(config["result_filename"])
                stem = result_path.name
                for ext in keep._supported_formats:
                    if stem.endswith(ext):
                        stem = stem[: -len(ext)]
                        break
                provenance = result_path.parent / f"{stem}_provenance"
                provenance.mkdir(parents=True, exist_ok=True)
                config.to_file(str(provenance / f"{stem}_config.yaml"), overwrite=True)
        self._end_phase("write results")

        self._end_phase("KBMOD")
        if config["debug"]:
            self.display_phase_stats()
        return keep

    def run_search_from_work_unit(self, work):
        """Run a search from a WorkUnit (not ported yet: it needs the port's
        WorkUnit and WCS)."""
        raise NotImplementedError("SearchRunner.run_search_from_work_unit waits for the port's WorkUnit and WCS")


def append_positions_to_results(workunit, results):
    """Append predicted pixel and (RA, Dec) positions per time to the
    results (not ported yet: it needs the port's WorkUnit and WCS)."""
    raise NotImplementedError("append_positions_to_results waits for the port's WorkUnit and WCS")
