"""Standardizer for legacy DECam FITS products from the KBMOD v0.5 era
(reference: src/kbmod/standardizers/fits_standardizers/kbmodv05.py):
extensions [primary header, science, mask, variance] with a Rubin-style
bitmask config. Copy of the JAX package's standardizers/kbmodv05.py."""

import datetime as dt

import numpy as np

from kbmod_tpu_torch.geom.time_utils import datetime_to_mjd
from kbmod_tpu_torch.standardizers.fits_standardizer import MultiExtensionFits
from kbmod_tpu_torch.standardizers.kbmodv1 import KBMODV1Config, bitfield_to_boolean_mask

__all__ = ["KBMODV0_5", "KBMODV0_5Config"]


class KBMODV0_5Config(KBMODV1Config):
    pass


class KBMODV0_5(MultiExtensionFits):
    """Legacy DECam standardizer: HDUs = [header, science, mask, variance]."""

    name = "KBMODV0_5"
    priority = -1
    can_volunteer = False
    configClass = KBMODV0_5Config

    @classmethod
    def resolveTarget(cls, tgt):
        can_std, resources = super().resolveTarget(tgt)
        if not can_std:
            return False, {}
        hdulist = resources["hdulist"]
        if len(hdulist) < 4:
            return False, {}
        shapes = []
        for i in (1, 2, 3):
            if hdulist[i].data is None:
                return False, {}
            shapes.append(np.asarray(hdulist[i].data).shape)
        if any(len(s) != 2 for s in shapes) or shapes[0] != shapes[1] or shapes[0] != shapes[2]:
            return False, {}
        return "DATE-AVG" in hdulist[0].header, resources

    def __init__(self, location=None, hdulist=None, config=None, **kwargs):
        super().__init__(location=location, hdulist=hdulist, config=config, set_processable=False, **kwargs)
        self.processable = [self.hdulist[1]]

    def translateHeader(self):
        """mjd/mjd_mid from DATE-AVG (or MJD-OBS / DATE-OBS / MJD), plus
        optional filter and visit identifiers."""
        header = {}
        if "DATE-AVG" in self.primary:
            mjd = datetime_to_mjd(dt.datetime.fromisoformat(str(self.primary["DATE-AVG"])))
        elif "MJD-OBS" in self.primary:
            mjd = float(self.primary["MJD-OBS"])
        elif "DATE-OBS" in self.primary:
            mjd = datetime_to_mjd(dt.datetime.fromisoformat(str(self.primary["DATE-OBS"])))
        elif "MJD" in self.primary:
            mjd = float(self.primary["MJD"])
        else:
            raise KeyError("Missing date key in the primary header.")
        header["mjd"] = mjd
        header["mjd_mid"] = mjd
        for key, hkey in [("FILTER", "FILTER"), ("visit", "EXPID"), ("OBSID", "OBSID")]:
            if hkey in self.primary:
                header[key] = self.primary[hkey]
        return header

    def standardizeMetadata(self):
        metadata = super().standardizeMetadata()
        translated = self.translateHeader()
        n = len(self.processable)
        for key, value in translated.items():
            metadata[key] = [value] * n
        return metadata

    def _standardizeMask(self):
        if not self.config["do_mask"]:
            return np.zeros_like(np.asarray(self.processable[0].data), dtype=bool)
        mask = np.asarray(self.hdulist[2].data)
        if self.config["do_bitmask"]:
            mask = bitfield_to_boolean_mask(mask, self.config["mask_flags"], self.config["bit_flag_map"])
        else:
            mask = mask != 0
        if self.config["do_threshold"]:
            mask = mask | (np.asarray(self.processable[0].data) > self.config["brightness_threshold"])
        if self.config["grow_mask"]:
            from scipy.signal import convolve2d

            mask = convolve2d(mask, np.ones(self.config["grow_kernel_shape"]), mode="same").astype(bool)
        return mask

    def standardizeMaskImage(self):
        return [self._standardizeMask() for _ in self.processable]

    def standardizeVarianceImage(self):
        return [np.asarray(self.hdulist[3].data, dtype=np.float32) for _ in self.processable]
