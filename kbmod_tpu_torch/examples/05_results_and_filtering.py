# %% [markdown]
# # Results and filtering
#
# The PyTorch port's counterpart of the reference's
# `kbmod_results_and_filtering.ipynb`: the `Results` table, the filter
# families (sigma-G, clustering, stamp filters), filtered-row tracking
# and reverting, and file IO with side-car columns. The search (K1 and K2),
# the sigma-G clipping and the stamps run on the CUDA card; define
# `DEVICE = "cpu"` first to run them on the host.

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import tempfile

import numpy as np

from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.filters.clustering_filters import apply_clustering
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
from kbmod_tpu_torch.filters.stamp_filters import append_coadds, append_all_stamps
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import StackSearch, Trajectory
from kbmod_tpu_torch.trajectory_generator import VelocityGridSearch

# Where the search, the clipping and the stamps run: None is the CUDA
# card, "cpu" the host.
DEVICE = globals().get("DEVICE")

times = create_fake_times(12, t0=60000.0, obs_per_day=3)
ds = FakeDataSet(160, 160, times, use_seed=8)
for trj in (Trajectory(x=40, y=50, vx=8.0, vy=2.0, flux=350.0),
            Trajectory(x=100, y=110, vx=-5.0, vy=6.0, flux=300.0)):
    ds.insert_object(trj)
stack = ds.stack_py

# %% [markdown]
# ## Core search -> Results

# %%
search = StackSearch(
    np.asarray(stack.sci), np.asarray(stack.var),
    [np.asarray(p) for p in stack.psfs], np.asarray(stack.zeroed_times), -1,
    device=DEVICE)
search.set_min_obs(8)
search.search_all(list(VelocityGridSearch(9, -8.0, 8.0, 9, -8.0, 8.0)), True)
trjs = search.get_results(0, 2000)
results = Results.from_trajectories(trjs, track_filtered=True)
print(len(results), "raw results")

# %% [markdown]
# ## Sigma-G clipping
#
# Appends psi/phi curves, clips outlier observations, recomputes
# likelihoods, and drops rows falling below the cut.

# %%
curves = search.get_all_psi_phi_curves(trjs)
T = stack.num_times
results.add_psi_phi_data(curves[:, :T], curves[:, T:])
clipper = SigmaGClipping(25, 75, clip_negative=True, device=DEVICE)
apply_clipped_sigma_g(clipper, results)
results.filter_rows(results["likelihood"] > 12.0, "lh_level")
print(len(results), "after sigma-G + lh cut; filtered counts:", dict(results.filtered_stats))

# %% [markdown]
# ## Clustering (dedup)

# %%
apply_clustering(results, {
    "cluster_type": "all", "cluster_eps": 10.0, "cluster_v_scale": 1.0,
    "times": np.asarray(stack.zeroed_times),
})
print(len(results), "after clustering")

# %% [markdown]
# ## Stamps and IO

# %%
append_coadds(results, stack, ["mean", "median"], 7, device=DEVICE)
append_all_stamps(results, stack, 5, device=DEVICE)
workdir = tempfile.mkdtemp()
# Image-like columns (all_stamps) split into side-car files.
from kbmod_tpu_torch.results import write_results_to_files_destructive

write_results_to_files_destructive(
    f"{workdir}/results.ecsv", results, separate_col_files=["all_stamps"])
back = Results.read_table(f"{workdir}/results.ecsv")
print("round-trip columns:", sorted(back.colnames))

# %% [markdown]
# ## Reverting a filter
#
# With `track_filtered=True` every dropped row is kept under its filter
# name and can be restored.

# %%
print("revertable filters:", list(dict(results.filtered_stats)))
results.revert_filter("lh_level")
print(len(results), "after reverting the lh cut")
