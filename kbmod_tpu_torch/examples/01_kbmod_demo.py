# %% [markdown]
# # kbmod_tpu_torch demo
#
# The end-to-end workflow on demo data in the PyTorch port, the counterpart
# of the reference's `notebooks/KBMOD_Demo.ipynb`: create a small WorkUnit
# with an injected moving object, run the full search pipeline on the CUDA
# card, and look at the recovered trajectories.
#
# Run as a script (`python kbmod_tpu_torch/examples/01_kbmod_demo.py`) or
# open in any percent-format-aware notebook UI (VS Code, Jupytext). Every
# entry point runs on the card and raises without one; to run on the host,
# define `DEVICE = "cpu"` first (a script:
# `runpy.run_path(path, init_globals={"DEVICE": "cpu"})`).

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import tempfile, os
import numpy as np

from kbmod_tpu_torch.fake_data.demo_helper import make_demo_data
from kbmod_tpu_torch.run_search import SearchRunner
from kbmod_tpu_torch.work_unit import WorkUnit

# Where the search runs: None is the CUDA card, "cpu" the host.
DEVICE = globals().get("DEVICE")

workdir = tempfile.mkdtemp()
wu_file = os.path.join(workdir, "demo.fits")
make_demo_data(wu_file)  # 20 x 256 x 256 stack with one inserted object
work = WorkUnit.from_fits(wu_file)
print(f"WorkUnit: {work.im_stack.num_times} images, "
      f"{work.im_stack.height}x{work.im_stack.width}")

# %% [markdown]
# ## Run the search
#
# The configuration travels inside the WorkUnit. The demo config searches
# a small velocity grid; `SearchRunner` runs every pipeline phase on the
# device (psi/phi build by the K1 kernel, core search by K2, sigma-G,
# clustering, stamps).

# %%
results = SearchRunner(device=DEVICE).run_search_from_work_unit(work)
print(f"{len(results)} results")
print(results.colnames)

# %% [markdown]
# ## Inspect the best result

# %%
best = np.argmax(results["likelihood"])
row = results[best]
print(f"best: x={row['x']} y={row['y']} vx={row['vx']:.2f} vy={row['vy']:.2f} "
      f"lh={row['likelihood']:.1f} obs={row['obs_count']}")

# %%
# Results persist to any of .ecsv/.parquet/.hdf5.
out = os.path.join(workdir, "results.ecsv")
results.write_table(out)
print("wrote", out)
