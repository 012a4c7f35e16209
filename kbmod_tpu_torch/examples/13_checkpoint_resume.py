# %% [markdown]
# # Search checkpointing and resume
#
# An extension of the reference, which restarts a killed search phase from
# scratch: the core search runs in starting-pixel row tiles (the K2 kernel
# a tile on the CUDA card), each tile's top-K checkpoints to disk, and a
# relaunched search resumes from the finished tiles. The survey-scale
# kill+resume demonstration is `python -m
# kbmod_tpu_torch.scripts.survey_full_grid`; in production pipelines set
# `KB_SEARCH_CKPT_DIR` and `SearchRunner` does this transparently. Define
# `DEVICE = "cpu"` first to run on the host.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import os
import tempfile

import numpy as np
import torch

from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.search.checkpoint import checkpointed_core_search

# Where the search runs: None is the CUDA card, "cpu" the host.
DEVICE = globals().get("DEVICE")
dev = resolve_device(DEVICE)

# %% [markdown]
# ## A small search, checkpointed per 16-row tile
#
# The planes live on the device: psi and phi as float32, the valid mask
# as uint8.

# %%
T, H, W = 5, 48, 40
rng = np.random.default_rng(13)
times = np.linspace(0.0, 1.0, T)
psi = rng.normal(0, 0.1, (T, H, W)).astype(np.float32)
phi = np.full((T, H, W), 4.0, dtype=np.float32)
valid = np.ones((T, H, W), dtype=bool)
psi, phi, valid = (torch.as_tensor(a, device=dev) for a in (psi, phi, valid.astype(np.uint8)))
vxs = np.array([3.0, -2.0, 5.0], dtype=np.float32)
vys = np.array([1.0, 4.0, -2.0], dtype=np.float32)

ckpt_dir = tempfile.mkdtemp(prefix="kb_ckpt_demo_")
kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, results_per_pixel=2,
          checkpoint_dir=ckpt_dir, tile_rows=16)
res1 = checkpointed_core_search(psi, phi, valid, times, vxs, vys, **kw)
tiles = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("tile_"))
print(f"{len(tiles)} tile checkpoints: {tiles}")

# %% [markdown]
# ## A relaunch resumes from the finished tiles
#
# Delete one tile to simulate a crash that killed the run mid-tile: the
# resume recomputes exactly that tile and reuses the rest.

# %%
os.remove(os.path.join(ckpt_dir, tiles[1]))
res2 = checkpointed_core_search(psi, phi, valid, times, vxs, vys, **kw)
np.testing.assert_array_equal(res1["lh"], res2["lh"])
print("resume reproduced the full result exactly")

# %% [markdown]
# ## Stale checkpoints are fingerprint-detected
#
# The manifest fingerprints the full search inputs (every plane digested
# on the device); changing anything (data, grid, bounds) invalidates old
# tiles instead of silently mixing results from different searches.

# %%
psi_changed = psi + 0.01
res3 = checkpointed_core_search(psi_changed, phi, valid, times, vxs, vys, **kw)
assert not np.array_equal(res1["lh"], res3["lh"])
print("changed inputs -> checkpoints discarded, fresh search ran")

import shutil
shutil.rmtree(ckpt_dir)
print("checkpoint/resume example done")
