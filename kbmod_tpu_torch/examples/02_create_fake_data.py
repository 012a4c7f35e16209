# %% [markdown]
# # Creating fake data
#
# The PyTorch port's counterpart of the reference's
# `create_fake_data.ipynb`: synthesize an image stack with noise, masks and
# inserted objects, and persist it as a (sharded) WorkUnit. All of it is
# host work (numpy and the port's own FITS writer), so it needs no card.

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import tempfile

import numpy as np

from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.search import Trajectory

# Four observations a night for five nights.
times = create_fake_times(20, t0=60000.0, obs_per_day=4, intra_night_gap=0.01,
                          inter_night_gap=1)
ds = FakeDataSet(400, 300, times, noise_level=2.0, psf_val=1.0,
                 mask_fraction=0.02, use_seed=101)
print(f"stack: {ds.stack_py.num_times} x {ds.stack_py.height} x {ds.stack_py.width}")

# %% [markdown]
# ## Insert moving objects
#
# `insert_object` paints a PSF-shaped source along the trajectory in every
# image (the inserted list is kept for later recovery matching).

# %%
rng = np.random.default_rng(5)
for _ in range(3):
    ds.insert_object(Trajectory(
        x=int(rng.uniform(50, 350)), y=int(rng.uniform(50, 250)),
        vx=float(rng.uniform(-10, 10)), vy=float(rng.uniform(-10, 10)),
        flux=float(rng.uniform(200, 400)),
    ))
print("inserted:", [str(t) for t in ds.trajectories])

# %% [markdown]
# ## Save as a WorkUnit
#
# Single-file FITS in the reference's on-disk layout, or sharded (one
# file per image) for lazy loading of large stacks. The files are byte for
# byte those of the JAX package.

# %%
workdir = tempfile.mkdtemp()
work = ds.get_work_unit()
work.to_fits(f"{workdir}/fake.fits")
work.to_sharded_fits("fake_sharded.fits", workdir)

from kbmod_tpu_torch.work_unit import WorkUnit

lazy = WorkUnit.from_sharded_fits("fake_sharded.fits", workdir, lazy=True)
print("lazy WorkUnit, images load on demand:", lazy.lazy)
lazy.load_images()
print("loaded:", lazy.im_stack.num_times, "images")
