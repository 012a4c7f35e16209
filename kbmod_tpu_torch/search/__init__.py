"""kbmod_tpu_torch.search: the search-engine API of the port.

The same names as the JAX package's ``search`` module, which exports those
of the reference's pybind11 module ``kbmod.search``
(src/kbmod/search/bindings.cpp:20-41): StackSearch, Trajectory,
TrajectoryList, the psi/phi array and evaluation helpers, the image-utils
and CPU-search bindings, ``StampType`` and the device and memory helpers.
"GPU" in these names means the CUDA card. The image helpers run on the card
unless given ``device="cpu"``; the memory helpers read
``torch.cuda.mem_get_info`` when called, never at import, and return 0
without a card, as the reference's bindings do.
"""

import numpy as np
import torch

from kbmod_tpu_torch.constants import KB_NO_DATA, pixel_value_valid
from kbmod_tpu_torch.ops.psi_phi import (
    PsiPhi,
    PsiPhiArray,
    PsiPhiArrayMeta,
    compute_scale_params_from_image_vect,
    decode_uint_scalar,
    encode_uint_scalar,
    fill_psi_phi_array,
    fill_psi_phi_array_from_image_arrays,
    generate_psi_phi_images,
    psi_phi_array_from_numpy,
)
from kbmod_tpu_torch.ops.search import (
    evaluate_trajectories,
    predict_index,
    sigmag_filtered_indices,
)
from kbmod_tpu_torch.search.checkpoint import checkpointed_core_search
from kbmod_tpu_torch.search.stack_search import StackSearch
from kbmod_tpu_torch.search.trajectory import Trajectory
from kbmod_tpu_torch.search.trajectory_list import (
    TrajectoryList,
    extract_all_trajectory_flux,
    extract_all_trajectory_lh,
    extract_all_trajectory_obs_count,
    extract_all_trajectory_vx,
    extract_all_trajectory_vy,
    extract_all_trajectory_x,
    extract_all_trajectory_y,
)
from kbmod_tpu_torch.utils.debug_timer import DebugTimer
from kbmod_tpu_torch.utils.logging_utils import Logging


# --- image-utils bindings (image_utils_cpp.cpp:179-196) ---

def convolve_image(image, psf, device=None):
    """Masked PSF convolution of one image (image_utils_cpp.cpp:103-108);
    numpy in, numpy out."""
    from kbmod_tpu_torch.ops.convolve import convolve_psf_and_image

    return np.asarray(convolve_psf_and_image(image, psf, device=device))


# The reference exposes explicit CPU/GPU dispatch; here ``device`` picks.
convolve_image_cpu = convolve_image
convolve_image_gpu = convolve_image


def square_psf_values(given_psf):
    """Element-wise squared PSF kernel (image_utils_cpp.cpp:110-120)."""
    return np.asanyarray(given_psf) ** 2


def generate_psi(sci, var, psf, device=None):
    """psi = conv(sci/var, PSF) (image_utils_cpp.cpp:126-153), through
    kernel K1; a numpy (H, W) float32 image, NaN where masked."""
    return generate_psi_phi_images(sci, var, psf, device=device)[0].cpu().numpy()


def generate_phi(var, psf, device=None):
    """phi = conv(1/var, PSF^2) (image_utils_cpp.cpp:155-177), through
    kernel K1; a numpy (H, W) float32 image, NaN where masked."""
    var = np.asanyarray(var)
    return generate_psi_phi_images(np.ones_like(var), var, psf, device=device)[1].cpu().numpy()


# --- CPU search bindings (cpu_search_algorithms.cpp:127-131) ---
# Both run where the PsiPhiArray's planes are: on the card for an array
# built there, on the host for one built with device="cpu".

def evaluate_trajectory_cpu(psi_phi_array, candidate):
    """Score one candidate trajectory against a PsiPhiArray, updating its
    obs_count/lh/flux in place (cpu_search_algorithms.cpp:20-60; no
    sigma-G)."""
    psi, phi, valid = psi_phi_array.decoded_psi_phi()
    stats = evaluate_trajectories(
        psi, phi, valid, psi_phi_array.times,
        np.array([candidate.x]), np.array([candidate.y]),
        np.array([candidate.vx], dtype=np.float32),
        np.array([candidate.vy], dtype=np.float32),
    )
    candidate.obs_count = int(stats["obs_count"][0])
    candidate.lh = float(stats["lh"][0])
    candidate.flux = float(stats["flux"][0])


def search_cpu_only(psi_phi_array, params, trj_to_search, results):
    """The CPU-path search (cpu_search_algorithms.cpp:62-124): every
    starting pixel keeps min(results_per_pixel, n_candidates) ungated
    results; ``results`` (a TrajectoryList) receives them."""
    from kbmod_tpu_torch.ops.search import core_search

    cands = trj_to_search.get_arrays()
    psi, phi, valid = psi_phi_array.decoded_psi_phi()
    raw = core_search(
        psi, phi, valid, psi_phi_array.times,
        cands["vx"], cands["vy"],
        params.x_start_min, params.x_start_max,
        params.y_start_min, params.y_start_max,
        min(params.results_per_pixel, len(trj_to_search)),
        min_obs=0, min_lh=-np.inf, gate_min_obs=False,
    )
    results.set_arrays(raw)


class StampType:
    """Coadd stamp types (bindings.cpp:33-38)."""

    STAMP_SUM = 0
    STAMP_MEAN = 1
    STAMP_MEDIAN = 2
    STAMP_VAR_WEIGHTED = 3


def kb_has_gpu():
    """True when a CUDA card is available."""
    return torch.cuda.is_available()


# The reference's build flags (bindings.cpp:20-30). HAS_CUDA is resolved
# when read (module __getattr__ below), not at import; HAS_OMP reports
# nothing meaningful here and stays False, as in the JAX package.
HAS_OMP = False


def __getattr__(name):
    if name == "HAS_CUDA":
        return kb_has_gpu()
    raise AttributeError(f"module 'kbmod_tpu_torch.search' has no attribute {name}")


def _mem_info():
    """(free, total) bytes of the current card, or (0, 0) without one.
    Initialises CUDA, so it is only ever called from the helpers below."""
    if not kb_has_gpu():
        return 0, 0
    return torch.cuda.mem_get_info()


def kb_get_gpu_free_memory():
    """Free card memory in bytes (kernel_helpers.cpp:35-50); 0 without a
    card."""
    return int(_mem_info()[0])


def kb_get_gpu_total_memory():
    """Total card memory in bytes; 0 without a card."""
    return int(_mem_info()[1])


def get_gpu_free_memory():
    return kb_get_gpu_free_memory()


def get_gpu_total_memory():
    return kb_get_gpu_total_memory()


def stat_gpu_memory_mb():
    """Human-readable card memory (kernel_helpers.cpp:52-66)."""
    if not kb_has_gpu():
        return "No accelerator device available."
    free, total = _mem_info()
    used = (total - free) / (1024.0 * 1024.0)
    return f"Device memory: {used:.2f} MB used of {total / (1024.0 * 1024.0):.2f} MB total."


def print_cuda_stats():
    print(stat_gpu_memory_mb())


def validate_gpu(req_memory=0):
    """Check a card exists and has at least req_memory bytes free
    (kernel_helpers.cpp:68-84)."""
    if not kb_has_gpu():
        return False
    return kb_get_gpu_free_memory() >= req_memory


__all__ = [
    "KB_NO_DATA",
    "HAS_CUDA",
    "HAS_OMP",
    "DebugTimer",
    "Logging",
    "PsiPhiArray",
    "PsiPhiArrayMeta",
    "StackSearch",
    "StampType",
    "Trajectory",
    "TrajectoryList",
    "kb_has_gpu",
    "kb_get_gpu_free_memory",
    "kb_get_gpu_total_memory",
    "get_gpu_free_memory",
    "get_gpu_total_memory",
    "stat_gpu_memory_mb",
    "print_cuda_stats",
    "validate_gpu",
    "pixel_value_valid",
    "fill_psi_phi_array",
    "fill_psi_phi_array_from_image_arrays",
    "compute_scale_params_from_image_vect",
    "encode_uint_scalar",
    "decode_uint_scalar",
    "sigmag_filtered_indices",
    "PsiPhi",
    "convolve_image",
    "convolve_image_cpu",
    "convolve_image_gpu",
    "square_psf_values",
    "generate_psi",
    "generate_phi",
    "generate_psi_phi_images",
    "evaluate_trajectory_cpu",
    "search_cpu_only",
    "evaluate_trajectories",
    "predict_index",
    "extract_all_trajectory_x",
    "extract_all_trajectory_y",
    "extract_all_trajectory_vx",
    "extract_all_trajectory_vy",
    "extract_all_trajectory_lh",
    "extract_all_trajectory_flux",
    "extract_all_trajectory_obs_count",
    "checkpointed_core_search",
    "psi_phi_array_from_numpy",
]
