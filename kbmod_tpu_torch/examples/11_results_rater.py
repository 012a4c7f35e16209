# %% [markdown]
# # Rating results by hand
#
# The PyTorch port's counterpart of the reference's
# `analysis/ResultRater.ipynb`: an interactive stamp viewer for labeling
# candidates as real / bogus / unknown. In a notebook the arrow buttons
# drive it; here we drive the same API programmatically (headless
# matplotlib backend). It is host work and needs no card.

# %%
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import matplotlib
matplotlib.use("Agg")
import tempfile

import numpy as np

from kbmod_tpu_torch.analysis.results_rater import ResultsRater
from kbmod_tpu_torch.fake_data.fake_result_creator import (
    add_fake_coadds_to_results,
    make_fake_results,
)
from kbmod_tpu_torch.results import Results

# %% [markdown]
# ## Fake results with coadd stamps to rate

# %%
rng = np.random.default_rng(31)
results = make_fake_results(8, 120, 120, 6, rng=rng)
add_fake_coadds_to_results(results, 5, ["mean", "median"], rng=rng)

outfile = tempfile.NamedTemporaryFile(suffix=".ecsv", delete=False).name
rater = ResultsRater(results, outfile=outfile, stamp_size=2.0)

# %% [markdown]
# ## Navigate and label
#
# Classes are indexed like the notebook's buttons
# (1 = Valid, 2 = Noise, 3 = Unknown); notes are free text per row.

# %%
rater.set_class(1)
rater.set_notes("clean point source track")
rater.next_result()
rater.set_class(2)
rater.set_notes("diffraction spike")
rater.goto_index(5)
rater.set_class(3)
rater.previous_result()
print(f"currently at result {rater.idx} of {len(results)}")

# %% [markdown]
# ## Ratings persist in the results table (`user_class` / `notes`)

# %%
rater.save_to_file(outfile)
reloaded = ResultsRater.from_file(outfile)
print(f"reloaded {len(reloaded.results)} rated rows; "
      f"labels: {list(reloaded.results['user_class'])}")
assert reloaded.results["user_class"][0] == "Valid (1)"
assert reloaded.results["notes"][1] == "diffraction spike"
print("results-rater example done")
