# %% [markdown]
# # Joining results against known objects
#
# The PyTorch port's counterpart of the reference's
# `reference/join_known_objects_example.ipynb`: match recovered
# trajectories against a catalog of known-object ephemerides
# (e.g. SkyBoT / JPL queries in production), flag recoveries, and
# optionally remove the matched observations so only novel candidates
# remain. The matching is host work (a k-d tree over sky positions), so it
# needs no card.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.table import Table
from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos
from kbmod_tpu_torch.wcs_utils import make_fake_wcs

# %% [markdown]
# ## A result set and a known-object catalog
#
# The first result trajectory follows catalog object "2005 XY100"
# exactly; the second is a novel candidate.

# %%
wcs = make_fake_wcs(200.0, -7.0, 500, 500, 1.0 / 3600.0)
obstimes = 57130.0 + np.arange(6) * 0.1

known_trj = Trajectory(x=250, y=250, vx=10.0, vy=5.0, flux=120.0, lh=40.0, obs_count=6)
novel_trj = Trajectory(x=40, y=60, vx=-6.0, vy=1.0, flux=90.0, lh=22.0, obs_count=6)
results = Results.from_trajectories([known_trj, novel_trj])
results.table["obs_valid"] = np.ones((2, len(obstimes)), dtype=bool)

coords = trajectory_predict_skypos(known_trj, wcs, obstimes)
catalog = Table({
    "Name": np.array(["2005 XY100"] * len(obstimes), dtype=object),
    "RA": coords.ra_deg,
    "DEC": coords.dec_deg,
    "mjd_mid": obstimes,
})

# %% [markdown]
# ## Match within separation + time thresholds

# %%
matcher = KnownObjsMatcher(catalog, obstimes, "known", sep_thresh=2.0, time_thresh_s=600.0)
matcher.match(results, wcs)
for i in range(len(results)):
    hits = results["known"][i]
    print(f"result {i}: matched {dict((k, int(np.sum(v))) for k, v in hits.items()) or 'nothing'}")

# %% [markdown]
# ## Require a minimum number of matched observations
#
# `match_on_min_obs` / `match_on_obs_ratio` summarize the per-observation
# matches into per-result recovery columns.

# %%
matcher.match_on_min_obs(results, 4)
col = matcher.match_min_obs_col(4)
print(f"{col}: {list(results[col])}")
assert results[col][0] == ["2005 XY100"] and results[col][1] == []

# %% [markdown]
# ## Drop the known object, keep the novel candidate

# %%
matcher.mark_matched_obs_invalid(results, drop_empty_rows=True)
print(f"{len(results)} result(s) remain; survivor starts at "
      f"({results['x'][0]}, {results['y'][0]})")
assert len(results) == 1 and results["x"][0] == novel_trj.x
print("known-objects example done")
