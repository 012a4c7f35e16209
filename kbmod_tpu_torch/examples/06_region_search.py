# %% [markdown]
# # Region search
#
# The PyTorch port's counterpart of the reference's
# `region_search/Region Searching Workbook.ipynb`: organize a survey's
# worth of unprocessed images into RA/Dec patches, reflex-correct for a
# guessed distance, and export per-patch ImageCollections ready for
# per-patch searches. All of it is host work (numpy, the port's host WCS),
# so it needs no card.

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import numpy as np

from kbmod_tpu_torch.image_collection import ImageCollection
from kbmod_tpu_torch.region_search import RegionSearch, Patch, patch_arcmin_to_pixels
from kbmod_tpu_torch.table import Table
from kbmod_tpu_torch.wcs_utils import make_fake_wcs, serialize_wcs

# A synthetic ImageCollection: 12 pointings dithered around one field,
# three epochs each.
rng = np.random.default_rng(3)
rows = []
deg_pp = 0.5 / 3600.0
for i in range(12):
    ra = 215.0 + rng.uniform(-0.3, 0.3)
    dec = -12.0 + rng.uniform(-0.3, 0.3)
    wcs = make_fake_wcs(ra, dec, 1024, 1024, deg_pp)
    rows.append({
        "location": f"/data/survey/visit_{1000 + i}.fits",
        "mjd_mid": 60000.0 + (i % 3),
        "ra": ra, "dec": dec,
        "wcs": serialize_wcs(wcs),
        "visit": 1000 + i, "detector": i % 4, "band": "r",
        "obs_lon": -70.75, "obs_lat": -30.24, "obs_elev": 2650.0,
        "ra_tl": ra - 0.07, "dec_tl": dec + 0.07,
        "ra_tr": ra + 0.07, "dec_tr": dec + 0.07,
        "ra_bl": ra - 0.07, "dec_bl": dec - 0.07,
        "ra_br": ra + 0.07, "dec_br": dec - 0.07,
        "config": "{}",
    })
cols = {k: [r[k] for r in rows] for k in rows[0]}
ic = ImageCollection(Table(cols))
print(len(ic), "images in the collection")

# %% [markdown]
# ## Build the patch grid and match images
#
# Patches are RA/Dec-aligned overlapping boxes; images are matched by
# footprint overlap after reflex correction at each guess distance (at
# 40 AU the correction moves footprints by up to ~1.4 deg, so the grid
# must cover the corrected positions).

# %%
rs = RegionSearch(ic, guess_dists=[40.0])
rs.generate_patches(
    arcminutes=20.0, overlap_percentage=50.0, image_width=1024,
    image_height=1024, pixel_scale=0.5, dec_range=(-14.0, -10.0),
    ra_range=(212.0, 218.0),
)
print(len(rs.get_patches()), "patches;",
      patch_arcmin_to_pixels(20.0, 0.5), "px per patch side")

# %%
matches = rs.match_ic_to_patches(guess_dist=40.0)
sizes = {p: len(v) for p, v in matches.items() if len(v)}
print(f"{len(sizes)} patches contain data; busiest has "
      f"{max(sizes.values())} images")

# %% [markdown]
# ## Export one patch for a search run

# %%
busiest = max(sizes, key=sizes.get)
sub = rs.get_image_collection_from_patch(busiest, guess_dist=40.0)
out = rs.export_image_collection(ic_to_export=sub, guess_dist=40.0, patch=busiest)
print(f"patch {busiest}: exported collection with {len(out)} images")
