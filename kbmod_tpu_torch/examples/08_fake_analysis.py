# %% [markdown]
# # Analyzing injected fakes
#
# The PyTorch port's counterpart of the reference's
# `analysis/FakeAnalysis.ipynb` and `kbmod_search_results_for_fakes.ipynb`:
# insert a fake moving object, join its known sky positions against a
# WorkUnit, fit a trajectory to the recovered pixel track, and inspect
# stamps along it. The join, the fit and the stamps are host work; the
# plots need matplotlib (headless backend here), so it needs no card.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import matplotlib
matplotlib.use("Agg")

import numpy as np

from kbmod_tpu_torch.analysis.analyze_fakes import FakeInfo
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.wcs_utils import make_fake_wcs

# %% [markdown]
# ## A WorkUnit with one injected object

# %%
num_times = 8
times = create_fake_times(num_times, t0=57130.0, obs_per_day=4)
ds = FakeDataSet(64, 72, times, noise_level=1.5, use_seed=21)
true_trj = Trajectory(x=12, y=14, vx=4.0, vy=-1.5, flux=400.0)
ds.insert_object(true_trj)
wu = ds.get_work_unit()
wu.wcs = make_fake_wcs(25.0, -10.0, 64, 72, deg_per_pixel=0.01)

# %% [markdown]
# ## FakeInfo: the fake's known ephemeris
#
# In production this comes from an injection catalog
# (`load_fake_info_from_ecsv`); here we derive it from the true
# trajectory so the example is self-contained.

# %%
obstimes = np.asarray(wu.get_all_obstimes())
zeroed = obstimes - obstimes[0]
xs = true_trj.x + true_trj.vx * zeroed
ys = true_trj.y + true_trj.vy * zeroed
ra, dec = wu.wcs.pixel_to_world_values(xs, ys)
fake = FakeInfo(obstimes, ra, dec, mag=np.full(num_times, 22.0), name="fake_001")
print(f"{fake.name}: {len(fake)} ephemeris points")

# %% [markdown]
# ## Join against the WorkUnit and fit the pixel track

# %%
fake.join_with_workunit(wu, radius=3)
print(f"seen at {fake.num_times_seen}/{len(fake)} times")
print(f"fitted velocity ({fake.trj.vx:.2f}, {fake.trj.vy:.2f}) "
      f"vs true ({true_trj.vx}, {true_trj.vy})")
print(f"trajectory fit MSE {fake.compute_fit_mse():.4f} px^2")

# %% [markdown]
# ## Stamps along the fake's track + summary plot

# %%
fake.compare_stamps(inds=[0, len(fake) - 1])
fake.plot_summary(title="fake_001 recovery")
print("fake analysis example done")
