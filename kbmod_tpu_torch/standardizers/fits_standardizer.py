"""FITS-file standardizers.

Copy of the JAX package's standardizers/fits_standardizer.py (host numpy).
Behavior-compatible with the reference's fits_standardizer.py: a base
class managing FITS HDU lists (via kbmod_tpu_torch.io.fits_io), with
single-extension and multi-extension specializations. Science/variance/
mask extraction, WCS/BBox standardization, and conversion to
LayeredImagePy.
"""

import os

import numpy as np

from kbmod_tpu_torch.core.image_stack_py import LayeredImagePy
from kbmod_tpu_torch.core.psf import PSF
from kbmod_tpu_torch.io import fits_io
from kbmod_tpu_torch.standardizers.standardizer import Standardizer, StandardizerConfig
from kbmod_tpu_torch.wcs_utils import extract_wcs_from_hdu_header

__all__ = [
    "FitsStandardizer",
    "FitsStandardizerConfig",
    "SingleExtensionFits",
    "MultiExtensionFits",
]


class FitsStandardizerConfig(StandardizerConfig):
    psf_std = 1.0
    """Standard deviation of the Gaussian PSF assigned to each image."""

    standardize_effective_time = True
    """Shift timestamps to the exposure midpoint when EXPTIME is known."""


class FitsStandardizer(Standardizer):
    """Base standardizer for FITS files on the local filesystem."""

    name = None
    priority = 0
    can_volunteer = False
    configClass = FitsStandardizerConfig
    valid_extensions = (".fit", ".fits", ".fits.fz")

    @classmethod
    def resolveFromPath(cls, tgt):
        """(canStandardize, {'hdulist': ...}) when tgt is a readable FITS
        path or an already-open HDUList (the reference's resolveTarget
        likewise accepts both; fits_standardizer.py:118-162)."""
        if isinstance(tgt, fits_io.HDUList):
            return len(tgt) > 0, {"hdulist": tgt}
        if not isinstance(tgt, str) or not os.path.isfile(tgt):
            return False, {}
        if not tgt.lower().endswith(cls.valid_extensions):
            return False, {}
        try:
            hdulist = fits_io.read_fits(tgt)
        except Exception:
            return False, {}
        return True, {"hdulist": hdulist}

    @classmethod
    def resolveTarget(cls, tgt):
        return cls.resolveFromPath(tgt)

    def __init__(self, location=None, hdulist=None, config=None, **kwargs):
        if location is None and hdulist is None:
            raise ValueError("Expected location or HDUList, got neither.")
        if hdulist is None:
            hdulist = fits_io.read_fits(location)
        if location is None:
            location = getattr(hdulist, "filename", ":memory:")
        super().__init__(location, config=config, **kwargs)
        self.hdulist = hdulist
        self.primary = hdulist[0].header
        self.processable = []
        self._wcs = None
        self._bbox = None

    @property
    def wcs(self):
        if self._wcs is None:
            self._wcs = self.standardizeWCS()
        return self._wcs

    @property
    def bbox(self):
        if self._bbox is None:
            self._bbox = self.standardizeBBox()
        return self._bbox

    def close(self):
        self.hdulist = None

    # --- shared standardization machinery ---

    def _compute_mjd(self, header):
        """MJD of the exposure midpoint from common header keys."""
        mjd = None
        for key in ("MJD-MID", "MJD_MID", "MJDMID"):
            if key in header:
                return float(header[key])
        for key in ("MJD-OBS", "MJD_OBS", "MJD", "EXPMJD", "MJDSTART", "MJD-STR"):
            if key in header:
                mjd = float(header[key])
                break
        if mjd is None and "DATE-AVG" in header:
            from kbmod_tpu_torch.geom.time_utils import datetime_to_mjd
            import datetime as dt

            try:
                stamp = str(header["DATE-AVG"])
                mjd = datetime_to_mjd(dt.datetime.fromisoformat(stamp))
            except ValueError:
                mjd = None
        if mjd is None:
            return None
        if self.config["standardize_effective_time"] and "EXPTIME" in header:
            mjd += 0.5 * float(header["EXPTIME"]) / 86400.0
        return mjd

    def standardizeWCS(self):
        return [extract_wcs_from_hdu_header(ext.header) for ext in self.processable]

    def standardizeBBox(self):
        bboxes = []
        for ext, wcs in zip(self.processable, self.wcs):
            if wcs is None or ext.data is None:
                bboxes.append(None)
                continue
            height, width = ext.data.shape
            corners_x = [0, width - 1, 0, width - 1, (width - 1) / 2]
            corners_y = [0, 0, height - 1, height - 1, (height - 1) / 2]
            ra, dec = wcs.pixel_to_world_values(corners_x, corners_y)
            bboxes.append(
                {
                    "ra": ra[4],
                    "dec": dec[4],
                    "ra_tl": ra[0], "dec_tl": dec[0],
                    "ra_tr": ra[1], "dec_tr": dec[1],
                    "ra_bl": ra[2], "dec_bl": dec[2],
                    "ra_br": ra[3], "dec_br": dec[3],
                }
            )
        return bboxes

    def standardizeMetadata(self):
        metadata = {"location": self.location}
        mjds = []
        ras = []
        decs = []
        for ext, wcs in zip(self.processable, self.wcs):
            mjd = self._compute_mjd(ext.header) or self._compute_mjd(self.primary) or 0.0
            mjds.append(mjd)
            if wcs is not None and ext.data is not None:
                height, width = ext.data.shape
                ra, dec = wcs.pixel_to_world_values((width - 1) / 2, (height - 1) / 2)
                ras.append(float(ra))
                decs.append(float(dec))
            else:
                ras.append(float(self.primary.get("RA", 0.0) or 0.0))
                decs.append(float(self.primary.get("DEC", 0.0) or 0.0))
        metadata["mjd_mid"] = mjds
        metadata["ra"] = ras
        metadata["dec"] = decs
        metadata["wcs"] = self.wcs
        metadata["bbox"] = self.bbox
        if "FILTER" in self.primary:
            metadata["filter"] = [self.primary["FILTER"]] * len(self.processable)
        if "OBSID" in self.primary:
            metadata["visit"] = [self.primary["OBSID"]] * len(self.processable)
        return metadata

    def standardizeScienceImage(self):
        return [np.asarray(ext.data, dtype=np.float32) for ext in self.processable]

    def standardizePSF(self):
        std = self.config["psf_std"]
        return [PSF.make_gaussian_kernel(std) for _ in self.processable]

    def toLayeredImage(self):
        """Standardize everything and bundle as LayeredImagePy objects."""
        meta = self.standardizeMetadata()
        sciences = self.standardizeScienceImage()
        variances = self.standardizeVarianceImage()
        masks = self.standardizeMaskImage()
        psfs = self.standardizePSF()

        mjds = meta["mjd_mid"]
        layered = []
        for sci, var, mask, psf, mjd in zip(sciences, variances, masks, psfs, mjds):
            layered.append(LayeredImagePy(sci, var, mask=mask, time=mjd, psf=psf))
        return layered


class SingleExtensionFits(FitsStandardizer):
    """FITS files whose primary HDU carries the science image."""

    name = "SingleExtensionFits"
    priority = 1
    can_volunteer = True

    def __init__(self, location=None, hdulist=None, config=None, **kwargs):
        super().__init__(location=location, hdulist=hdulist, config=config, **kwargs)
        self.processable = [self.hdulist[0]]

    @classmethod
    def resolveTarget(cls, tgt):
        can_std, resources = cls.resolveFromPath(tgt)
        if not can_std:
            return False, {}
        hdulist = resources["hdulist"]
        return (hdulist[0].data is not None and np.asarray(hdulist[0].data).ndim == 2), resources

    def standardizeVarianceImage(self):
        # Without a variance plane, assume Poisson-ish: var = |sci|.
        return [np.abs(np.asarray(ext.data, dtype=np.float32)) for ext in self.processable]

    def standardizeMaskImage(self):
        return [np.zeros_like(np.asarray(ext.data), dtype=np.float32) for ext in self.processable]


class MultiExtensionFits(FitsStandardizer):
    """FITS files with image data in extensions."""

    name = "MultiExtensionFits"
    priority = 1
    can_volunteer = True

    @staticmethod
    def _isImageLikeHDU(hdu):
        return hdu.data is not None and np.asarray(hdu.data).ndim == 2

    def __init__(self, location=None, hdulist=None, config=None, set_processable=True, **kwargs):
        super().__init__(location=location, hdulist=hdulist, config=config, **kwargs)
        if set_processable:
            self.processable = [hdu for hdu in self.hdulist[1:] if self._isImageLikeHDU(hdu)]

    @classmethod
    def resolveTarget(cls, tgt):
        can_std, resources = cls.resolveFromPath(tgt)
        if not can_std:
            return False, {}
        hdulist = resources["hdulist"]
        return (len(hdulist) > 1 and any(cls._isImageLikeHDU(h) for h in hdulist[1:])), resources

    def standardizeVarianceImage(self):
        variances = []
        for ext in self.processable:
            variances.append(np.abs(np.asarray(ext.data, dtype=np.float32)))
        return variances

    def standardizeMaskImage(self):
        return [np.zeros_like(np.asarray(ext.data), dtype=np.float32) for ext in self.processable]
