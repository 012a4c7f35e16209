# %% [markdown]
# # Evaluating clustering choices
#
# The PyTorch port's counterpart of the reference's
# `kbmod_evaluate_clustering.ipynb`: a real search returns many
# near-duplicate trajectories per object; the clustering filter collapses
# them. This walkthrough builds a duplicate-rich result set around known
# objects and compares the `cluster_type` variants. The port clusters on
# the host (scipy's connected components of the eps graph, no
# scikit-learn), so it needs no card.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from kbmod_tpu_torch.filters.clustering_filters import apply_clustering
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.trajectory_utils import match_trajectory_sets

rng = np.random.default_rng(17)
times = np.linspace(0.0, 4.0, 10)

# %% [markdown]
# ## Duplicate-rich results around three true objects
#
# Each true object spawns 25 jittered near-duplicates (what a dense
# velocity grid produces around a real detection).

# %%
true_trjs = [
    Trajectory(x=20, y=30, vx=8.0, vy=2.0, flux=300.0),
    Trajectory(x=90, y=40, vx=-5.0, vy=6.0, flux=350.0),
    Trajectory(x=60, y=100, vx=2.5, vy=-7.0, flux=280.0),
]
dupes = []
for trj in true_trjs:
    for _ in range(25):
        dupes.append(
            Trajectory(
                x=trj.x + int(rng.integers(-2, 3)),
                y=trj.y + int(rng.integers(-2, 3)),
                vx=trj.vx + rng.normal(0, 0.3),
                vy=trj.vy + rng.normal(0, 0.3),
                flux=trj.flux,
                lh=20.0 + rng.normal(0, 1.0),
                obs_count=len(times),
            )
        )
rng.shuffle(dupes)

# %% [markdown]
# ## Compare cluster_type variants
#
# `all` / `position` cluster in parameter space (DBSCAN), `nn_*` keep the
# highest-likelihood member per neighborhood, `grid_*` bin start/end
# points (the reference's scalable default).

# %%
for cluster_type in ["all", "position", "mid_position", "nn_start_end", "grid_start_end"]:
    results = Results.from_trajectories(list(dupes))
    apply_clustering(
        results,
        {"cluster_type": cluster_type, "cluster_eps": 5.0,
         "times": times, "cluster_v_scale": 1.0},
    )
    kept = results.make_trajectory_list()
    matches = match_trajectory_sets(true_trjs, kept, threshold=5.0,
                                    times=[times[0], times[-1]])
    recovered = int(np.sum(matches >= 0))
    print(f"{cluster_type:>15}: {len(dupes):3d} -> {len(kept):3d} rows, "
          f"{recovered}/{len(true_trjs)} objects kept")
    assert recovered == len(true_trjs)

print("clustering evaluation example done")
