# %% [markdown]
# # TrajectoryExplorer
#
# The PyTorch port's counterpart of the reference's
# `TrajectoryExplorer.ipynb`: interactively score single trajectories, scan
# a pencil grid around a guess, and refine results. The explorer builds
# psi/phi once on the device (the K1 kernel on the card) and runs each
# scan as one K2 search there. It runs on the CUDA card and raises without
# one; define `DEVICE = "cpu"` first to run on the host.

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import numpy as np

from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.trajectory_explorer import TrajectoryExplorer

# Where the explorer runs: None is the CUDA card, "cpu" the host.
DEVICE = globals().get("DEVICE")

times = create_fake_times(15, t0=60000.0, obs_per_day=3)
ds = FakeDataSet(200, 200, times, use_seed=21)
truth = Trajectory(x=80, y=60, vx=9.0, vy=-4.0, flux=400.0)
ds.insert_object(truth)

explorer = TrajectoryExplorer(ds.stack_py, device=DEVICE)

# %% [markdown]
# ## Score one trajectory
#
# Returns a full `Results` row: likelihood, flux, psi/phi curves, stamps,
# and the sigma-G validity column.

# %%
row = explorer.evaluate_linear_trajectory(80, 60, 9.0, -4.0)
print(f"lh={row['likelihood'][0]:.1f} flux={row['flux'][0]:.1f} "
      f"obs={row['obs_count'][0]}")
print("columns:", row.colnames)

# %% [markdown]
# ## Scan a pencil grid around a guess
#
# A coarse guess (e.g. from a shortlist) is refined by scoring the whole
# neighborhood in velocity space.

# %%
grid = explorer.evaluate_around_linear_trajectory(
    80, 60, 8.0, -3.0, pixel_radius=2, max_ang_offset=0.4, ang_step=0.1,
    max_vel_offset=4.0, vel_step=1.0,
)
best = np.argmax(grid["likelihood"])
print(f"grid best: vx={grid['vx'][best]:.2f} vy={grid['vy'][best]:.2f} "
      f"lh={grid['likelihood'][best]:.1f}  (truth vx=9, vy=-4)")

# %% [markdown]
# ## Refine

# %%
refined = explorer.refine_linear_trajectory(80, 60, 8.5, -3.5)
b = np.argmax(refined["likelihood"])
print(f"refined: x={refined['x'][b]} y={refined['y'][b]} "
      f"vx={refined['vx'][b]:.2f} vy={refined['vy'][b]:.2f}")
