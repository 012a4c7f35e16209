# %% [markdown]
# # Multi-card sharded search
#
# A walkthrough with no reference-notebook counterpart (the reference is
# single-GPU): run the core search over the port's `Mesh`, an ordered list
# of torch devices, one shard each, sharding either the candidate grid
# (top-K merged across shards) or the starting-pixel rows. The same code
# runs on one card, on every card of a host, or across the processes of a
# `torch.distributed` group. A device may hold more than one shard: here
# the mesh has at least two shards whatever the run sees (two on one card,
# or two on the host with `DEVICE = "cpu"`), so that the merge really runs.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.ops.search import core_search
from kbmod_tpu_torch.parallel.sharded import build_mesh, sharded_core_search

# Where the search runs: None is the CUDA card(s), "cpu" the host.
DEVICE = globals().get("DEVICE")
dev = resolve_device(DEVICE)
cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if dev.type == "cuda" else []
mesh = build_mesh(devices=cards if len(cards) >= 2 else [dev, dev])
print(f"mesh: {mesh.size} shards on {[str(d) for d in mesh.devices]}")

# %% [markdown]
# ## A small stack with one bright object
#
# The planes live on the device: psi and phi as float32, the valid mask
# as uint8.

# %%
T, H, W = 6, 40, 48
rng = np.random.default_rng(9)
times = np.linspace(0.0, 1.0, T)
psi = rng.normal(0, 0.1, (T, H, W)).astype(np.float32)
phi = np.full((T, H, W), 4.0, dtype=np.float32)
x0, y0, vx, vy = 10, 12, 8.0, 3.0
for t in range(T):
    psi[t, int(y0 + vy * times[t]), int(x0 + vx * times[t])] += 4.0
valid = np.ones((T, H, W), dtype=bool)
planes = [torch.as_tensor(a, device=mesh.root) for a in (psi, phi, valid.astype(np.uint8))]

vel = rng.uniform(2.0, 10.0, 64).astype(np.float32)
ang = rng.uniform(-0.6, 0.6, 64).astype(np.float32)
vxs, vys = (np.cos(ang) * vel).astype(np.float32), (np.sin(ang) * vel).astype(np.float32)
vxs[0], vys[0] = vx, vy  # make sure the true trajectory is in the grid

# %% [markdown]
# ## Candidate-sharded search
#
# The velocity grid is split across the mesh; each shard searches every
# pixel against its candidate slice (the K2 kernel on a card), and the
# per-pixel top-K lists are merged on the mesh's first device (across
# processes, gathered with `torch.distributed.all_gather`).

# %%
kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, results_per_pixel=4,
          min_obs=4, min_lh=2.0)
res_sharded = sharded_core_search(
    *planes, times, vxs, vys, mesh, shard_mode="candidates", **kw)

# %% [markdown]
# ## Identical to the single-device search

# %%
res_single = core_search(*planes, times, vxs, vys, **kw)
np.testing.assert_allclose(res_sharded["lh"], res_single["lh"], rtol=1e-5, atol=1e-5)
best = int(np.argmax(res_sharded["lh"]))
print(f"best lh {res_sharded['lh'][best]:.1f} at "
      f"({res_sharded['x'][best]}, {res_sharded['y'][best]}) "
      f"v=({res_sharded['vx'][best]:.1f}, {res_sharded['vy'][best]:.1f})")

# %% [markdown]
# ## Pixel-sharded mode
#
# For very wide images, shard the starting-pixel rows instead — no
# cross-shard merge is needed (each pixel's top-K lives on one shard).

# %%
res_pix = sharded_core_search(
    *planes, times, vxs, vys, mesh, shard_mode="pixels", **kw)
np.testing.assert_allclose(res_pix["lh"], res_single["lh"], rtol=1e-5, atol=1e-5)
print("sharded search matches the single-device search in both modes")
