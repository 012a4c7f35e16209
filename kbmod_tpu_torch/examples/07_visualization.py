# %% [markdown]
# # Visualization
#
# The PyTorch port's counterpart of the reference's `kbmod_visualize.ipynb`:
# plotting images, stamp grids, lightcurves and full result-row
# summaries. All figures save to PNG when run headless. The coadd and
# stamp cutouts run on the CUDA card (define `DEVICE = "cpu"` first to cut
# them on the host); the plots need matplotlib.

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import tempfile, os

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from kbmod_tpu_torch.analysis.plotting import (
    plot_image,
    plot_multiple_images,
    plot_result_row_summary,
    plot_time_series,
)
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.filters.stamp_filters import append_coadds, append_all_stamps
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import Trajectory

# Where the stamps are cut: None is the CUDA card, "cpu" the host.
DEVICE = globals().get("DEVICE")

outdir = tempfile.mkdtemp()
times = create_fake_times(10, t0=60000.0, obs_per_day=2)
ds = FakeDataSet(128, 128, times, use_seed=17)
trj = Trajectory(x=50, y=60, vx=7.0, vy=3.0, flux=500.0)
ds.insert_object(trj)
stack = ds.stack_py

# %% [markdown]
# ## Images

# %%
fig, ax = plt.subplots(figsize=(4, 4))
plot_image(stack.sci[0], ax=ax, title="epoch 0")
fig.savefig(os.path.join(outdir, "image.png"))

fig = plt.figure(figsize=(8, 4))
plot_multiple_images(stack.sci[:4], figure=fig, columns=4)
fig.savefig(os.path.join(outdir, "epochs.png"))

# %% [markdown]
# ## A result row: stamps + lightcurve + summary

# %%
results = Results.from_trajectories([trj])
append_coadds(results, stack, ["mean", "median", "sum"], 7, device=DEVICE)
append_all_stamps(results, stack, 7, device=DEVICE)

curve = results["coadd_mean"][0][7, :]  # central row of the mean stamp
fig, ax = plt.subplots()
plot_time_series(curve, ax=ax, title="central row of the mean coadd")
fig.savefig(os.path.join(outdir, "series.png"))

fig = plt.figure(figsize=(9, 6))
plot_result_row_summary(results[0], times=np.asarray(stack.zeroed_times), figure=fig)
fig.savefig(os.path.join(outdir, "summary.png"))
print("wrote", sorted(os.listdir(outdir)))
