# %% [markdown]
# # Reprojection demo
#
# The PyTorch port's counterpart of the reference's
# `reprojection/reproject_demo.ipynb`: align differently-pointed images to
# a common WCS (mosaicking same-time chips), and reproject into the EBD
# (parallax-corrected barycentric) frame. The source coordinates are
# computed on the host in float64; the resampling, the DeForest-style
# adaptive anti-aliased kernel, runs in PyTorch on the CUDA card (define
# `DEVICE = "cpu"` first to run it on the host).

# %%
# Make the repo importable when run as a plain script.
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import numpy as np

from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.reprojection import reproject_work_unit
from kbmod_tpu_torch.wcs_utils import make_fake_wcs

# Where the resampling runs: None is the CUDA card, "cpu" the host.
DEVICE = globals().get("DEVICE")

times = create_fake_times(6, t0=60000.0, obs_per_day=2)
ds = FakeDataSet(128, 128, times, use_seed=31)
work = ds.get_work_unit()

# Give each image a slightly offset pointing.
deg_pp = 0.5 / 3600.0
for i in range(6):
    wcs = make_fake_wcs(210.0, -15.0, 128, 128, deg_pp)
    wcs.crpix = wcs.crpix + np.array([1.5 * i, 0.7 * i])
    work.org_img_meta["per_image_wcs"][i] = wcs

# %% [markdown]
# ## Reproject to a common frame

# %%
common = make_fake_wcs(210.0, -15.0, 144, 144, deg_pp)
aligned = reproject_work_unit(work, common, frame="original", device=DEVICE)
print(f"reprojected: {aligned.im_stack.num_times} layers of "
      f"{aligned.im_stack.height}x{aligned.im_stack.width}")
print("valid px in layer 0:", int(np.isfinite(aligned.im_stack.sci[0]).sum()))

# %% [markdown]
# ## EBD frame
#
# For distant objects, most apparent motion is Earth's parallax. Fitting
# per-image barycentric WCSes at a guessed distance and reprojecting
# through them makes a distant object's track linear.

# %%
work2 = ds.get_work_unit()
for i in range(6):
    work2.org_img_meta["per_image_wcs"][i] = work.org_img_meta["per_image_wcs"][i]
work2.barycentric_distance = 40.0  # AU
ebd = reproject_work_unit(work2, common, frame="ebd", device=DEVICE)
print("frame:", ebd.reprojection_frame)
print("fitted geocentric distances:",
      [round(float(d), 3) for d in ebd.org_img_meta["geocentric_distance"][:3]], "...")
