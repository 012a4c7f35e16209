"""kbmod_tpu_torch.search: the search-engine API of the port (float path).

The same names as the JAX package's ``search`` module for the parts ported
so far: StackSearch, Trajectory, TrajectoryList, the checkpointed core
search and the psi/phi array and evaluation helpers behind them.
"""

from kbmod_tpu_torch.ops.psi_phi import (
    PsiPhi,
    PsiPhiArray,
    PsiPhiArrayMeta,
    fill_psi_phi_array,
    fill_psi_phi_array_from_image_arrays,
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

__all__ = [
    "PsiPhi",
    "PsiPhiArray",
    "PsiPhiArrayMeta",
    "StackSearch",
    "Trajectory",
    "TrajectoryList",
    "checkpointed_core_search",
    "evaluate_trajectories",
    "extract_all_trajectory_flux",
    "extract_all_trajectory_lh",
    "extract_all_trajectory_obs_count",
    "extract_all_trajectory_vx",
    "extract_all_trajectory_vy",
    "extract_all_trajectory_x",
    "extract_all_trajectory_y",
    "fill_psi_phi_array",
    "fill_psi_phi_array_from_image_arrays",
    "predict_index",
    "psi_phi_array_from_numpy",
    "sigmag_filtered_indices",
]
