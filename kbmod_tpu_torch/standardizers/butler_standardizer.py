"""Standardizer for Vera C. Rubin Butler datasets (copy of the JAX
package's standardizers/butler_standardizer.py).

Requires the (optional) LSST middleware: import fails cleanly when
``lsst.daf.butler`` is absent, mirroring the reference's optional-import
gate (src/kbmod/standardizers/butler_standardizer.py:125).
"""

import numpy as np

import lsst.daf.butler as dafButler  # noqa: F401 — optional dependency gate

from kbmod_tpu_torch.core.image_stack_py import LayeredImagePy
from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.geom.wcs import WCS
from kbmod_tpu_torch.standardizers.standardizer import Standardizer, StandardizerConfig
from kbmod_tpu_torch.standardizers.kbmodv1 import bitfield_to_boolean_mask

__all__ = ["ButlerStandardizer", "ButlerStandardizerConfig"]


class ButlerStandardizerConfig(StandardizerConfig):
    do_mask = True
    """Perform masking if True."""

    do_bitmask = True
    """Mask mask_flags from the Exposure's mask plane."""

    grow_mask = True
    """Grow the mask footprint by grow_kernel_shape."""

    grow_kernel_shape = (10, 10)
    """Square kernel by which mask footprints are grown."""

    mask_flags = ["BAD", "EDGE", "NO_DATA", "SUSPECT", "UNMASKEDNAN"]
    """Flags applied when masking."""

    psf_std = 1.0
    """Fallback Gaussian PSF std when the exposure carries no PSF model."""

    zero_point = 31.0
    """Photometric zero point to scale images to (if standardize_zero_point)."""

    standardize_zero_point = False
    """Scale science/variance to a common zero point."""


class ButlerStandardizer(Standardizer):
    """Standardizes Rubin ``Exposure`` objects retrieved through a Butler.

    Parameters
    ----------
    tgt : `DatasetRef`, `DatasetId`, or uuid
        Reference to the dataset to standardize.
    butler : `lsst.daf.butler.Butler`
        The Butler to fetch from.
    """

    name = "ButlerStandardizer"
    priority = 2
    can_volunteer = False  # requires a butler kwarg; cannot resolve blind
    configClass = ButlerStandardizerConfig

    @classmethod
    def resolveTarget(cls, tgt):
        # Can standardize DatasetRef/DatasetId-like targets (requires the
        # butler to be passed explicitly).
        is_ref = hasattr(tgt, "id") or type(tgt).__name__ in ("DatasetRef", "DatasetId", "UUID")
        return is_ref, {}

    def __init__(self, tgt, butler=None, config=None, **kwargs):
        if butler is None:
            raise ValueError("ButlerStandardizer requires a butler.")
        super().__init__(str(tgt), config=config, **kwargs)
        self.butler = butler
        self.ref = tgt
        self.exposure = butler.get(tgt) if not hasattr(tgt, "read") else tgt
        self.processable = [self.exposure]

    def _visit_info(self):
        return self.exposure.getInfo().getVisitInfo()

    def standardizeMetadata(self):
        info = self._visit_info()
        mjd = info.date.toAstropy().mjd if hasattr(info.date, "toAstropy") else float(info.date.get())
        wcs = self.standardizeWCS()[0]
        height, width = self.exposure.image.array.shape
        if wcs is not None:
            ra, dec = wcs.pixel_to_world_values((width - 1) / 2, (height - 1) / 2)
        else:
            ra = dec = 0.0
        return {
            "location": self.location,
            "mjd_mid": [mjd],
            "ra": [float(ra)],
            "dec": [float(dec)],
            "wcs": self.standardizeWCS(),
            "bbox": self.standardizeBBox(),
            "filter": [self.exposure.getFilter().bandLabel if self.exposure.getFilter() else None],
            "visit": [getattr(self.ref, "dataId", {}).get("visit", None) if hasattr(self.ref, "dataId") else None],
            # The Butler dataset id (uuid) — inject_sources_into_ic and
            # the reference's Butler workflows key on this column.
            "dataId": [str(getattr(self.ref, "id", self.ref))],
        }

    def standardizeScienceImage(self):
        return [np.asarray(self.exposure.image.array, dtype=np.float32)]

    def standardizeVarianceImage(self):
        return [np.asarray(self.exposure.variance.array, dtype=np.float32)]

    def standardizeMaskImage(self):
        if not self.config["do_mask"]:
            return [np.zeros_like(self.exposure.image.array, dtype=bool)]
        mask_plane = self.exposure.mask
        bitfield = np.asarray(mask_plane.array)
        if self.config["do_bitmask"]:
            flag_map = {name: 2**bit for name, bit in mask_plane.getMaskPlaneDict().items()}
            flags = [f for f in self.config["mask_flags"] if f in flag_map]
            mask = bitfield_to_boolean_mask(bitfield, flags, flag_map)
        else:
            mask = bitfield != 0
        if self.config["grow_mask"]:
            from scipy.signal import convolve2d

            mask = convolve2d(mask, np.ones(self.config["grow_kernel_shape"]), mode="same").astype(bool)
        return [mask]

    def standardizeWCS(self):
        sky_wcs = self.exposure.getWcs()
        if sky_wcs is None:
            return [None]
        fits_meta = sky_wcs.getFitsMetadata().toDict()
        try:
            return [WCS.from_header(fits_meta)]
        except Exception:
            return [None]

    def standardizeBBox(self):
        wcs = self.standardizeWCS()[0]
        if wcs is None:
            return [None]
        height, width = self.exposure.image.array.shape
        ra, dec = wcs.pixel_to_world_values([0, width - 1, (width - 1) / 2], [0, height - 1, (height - 1) / 2])
        return [{"ra": ra[2], "dec": dec[2], "ra_tl": ra[0], "dec_tl": dec[0], "ra_br": ra[1], "dec_br": dec[1]}]

    def standardizePSF(self):
        psf = self.exposure.getPsf()
        if psf is not None:
            try:
                kernel = psf.computeKernelImage(psf.getAveragePosition()).array
                return [np.asarray(kernel, dtype=np.float32)]
            except Exception:
                pass
        return [PSF.make_gaussian_kernel(self.config["psf_std"])]

    def toLayeredImage(self):
        meta = self.standardizeMetadata()
        sci = self.standardizeScienceImage()
        var = self.standardizeVarianceImage()
        mask = self.standardizeMaskImage()
        psf = self.standardizePSF()
        return [
            LayeredImagePy(s, v, mask=m, time=t, psf=p)
            for s, v, m, p, t in zip(sci, var, mask, psf, meta["mjd_mid"])
        ]
