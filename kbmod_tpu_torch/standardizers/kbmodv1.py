"""Standardizer for Rubin Science Pipelines imdiff products as specified
during KBMOD V1 development (reference: src/kbmod/standardizers/
fits_standardizers/kbmodv1.py). Volunteers for FITS whose primary header
carries the Rubin compressed-product signature (ZTENSION/ZPCOUNT/ZGCOUNT +
CCDNUM); reads IMAGE/MASK/VARIANCE extensions with a configurable Rubin
bitmask. Copy of the JAX package's standardizers/kbmodv1.py (host numpy and
scipy)."""

import datetime as dt

import numpy as np

from kbmod_tpu_torch.geom.time_utils import datetime_to_mjd
from kbmod_tpu_torch.standardizers.fits_standardizer import MultiExtensionFits, FitsStandardizerConfig

__all__ = ["KBMODV1", "KBMODV1Config", "bitfield_to_boolean_mask"]


def bitfield_to_boolean_mask(bitfield, mask_flags, flag_map):
    """True where any of the named flags' bits are set (the equivalent of
    astropy's bitfield_to_boolean_mask with flip_bits=True)."""
    select = 0
    for flag in mask_flags:
        select |= int(flag_map[flag])
    return (np.asarray(bitfield).astype(np.int64) & select) != 0


class KBMODV1Config(FitsStandardizerConfig):
    do_mask = True
    """Perform masking if True, otherwise return an empty mask."""

    do_bitmask = True
    """Mask ``mask_flags`` from the mask plane in the FITS file."""

    do_threshold = False
    """Mask all pixels above the given count threshold."""

    grow_mask = True
    """Grow the mask footprint by ``grow_kernel_shape``."""

    brightness_threshold = 10
    """Pixels with a value greater than this threshold will be masked."""

    grow_kernel_shape = (10, 10)
    """Square kernel by which mask footprints are grown."""

    bit_flag_map = {
        "BAD": 2**0,
        "CLIPPED": 2**9,
        "CR": 2**3,
        "CROSSTALK": 2**10,
        "DETECTED": 2**5,
        "DETECTED_NEGATIVE": 2**6,
        "EDGE": 2**4,
        "INEXACT_PSF": 2**11,
        "INTRP": 2**2,
        "NOT_DEBLENDED": 2**12,
        "NO_DATA": 2**8,
        "REJECTED": 2**13,
        "SAT": 2**1,
        "SENSOR_EDGE": 2**14,
        "SUSPECT": 2**7,
        "UNMASKEDNAN": 2**15,
    }
    """Flag name -> bit value."""

    mask_flags = ["BAD", "EDGE", "NO_DATA", "SUSPECT", "UNMASKEDNAN"]
    """Flags applied when masking."""


class KBMODV1(MultiExtensionFits):
    """Rubin Science Pipelines imdiff standardizer (KBMOD V1 era)."""

    name = "KBMODV1"
    priority = 2
    configClass = KBMODV1Config

    @classmethod
    def resolveTarget(cls, tgt):
        can_std, resources = super().resolveTarget(tgt)
        if not can_std:
            return False, {}
        primary = resources["hdulist"][0].header
        is_rubin = all(key in primary for key in ("ZTENSION", "ZPCOUNT", "ZGCOUNT", "CCDNUM"))
        return can_std and is_rubin, resources

    def __init__(self, location=None, hdulist=None, config=None, **kwargs):
        super().__init__(location=location, hdulist=hdulist, config=config, set_processable=False, **kwargs)
        self.processable = [self.hdulist["IMAGE"]]

    def translateHeader(self):
        """Per-exposure metadata from the primary header: mjd_mid (DATE-AVG
        + half the requested exposure + DECam shutter time), observatory
        position, filter/visit identifiers."""
        header = {}
        obs_datetime = dt.datetime.fromisoformat(str(self.primary["DATE-AVG"]))
        offset_to_mid = (float(self.primary["EXPREQ"]) + 0.5) / 2.0 / 86400.0
        header["mjd_mid"] = datetime_to_mjd(obs_datetime) + offset_to_mid
        header["obs_lon"] = self.primary.get("OBS-LONG")
        header["obs_lat"] = self.primary.get("OBS-LAT")
        header["obs_elev"] = self.primary.get("OBS-ELEV")
        for key, hkey in [
            ("FILTER", "FILTER"), ("IDNUM", "IDNUM"), ("visit", "EXPID"),
            ("OBSID", "OBSID"), ("DTNSANAM", "DTNSANAM"), ("AIRMASS", "AIRMASS"),
            ("GAINA", "GAINA"), ("GAINB", "GAINB"),
        ]:
            if hkey in self.primary:
                header[key] = self.primary[hkey]
        if "DIMM2SEE" in self.primary:
            d2s = self.primary["DIMM2SEE"]
            header["DIMM2SEE"] = 0.0 if str(d2s) == "NaN" else float(d2s)
        return header

    def standardizeMetadata(self):
        metadata = super().standardizeMetadata()
        translated = self.translateHeader()
        n = len(self.processable)
        for key, value in translated.items():
            metadata[key] = [value] * n
        metadata["mjd_mid"] = [translated["mjd_mid"]] * n
        return metadata

    def _standardizeMask(self):
        if not self.config["do_mask"]:
            return np.zeros_like(np.asarray(self.processable[0].data), dtype=bool)

        mask = np.asarray(self.hdulist["MASK"].data)
        if self.config["do_bitmask"]:
            mask = bitfield_to_boolean_mask(mask, self.config["mask_flags"], self.config["bit_flag_map"])
        else:
            mask = mask != 0

        if self.config["do_threshold"]:
            mask = mask | (np.asarray(self.processable[0].data) > self.config["brightness_threshold"])

        if self.config["grow_mask"]:
            from scipy.signal import convolve2d

            grow_kernel = np.ones(self.config["grow_kernel_shape"])
            mask = convolve2d(mask, grow_kernel, mode="same").astype(bool)
        return mask

    def standardizeMaskImage(self):
        return [self._standardizeMask() for _ in self.processable]

    def standardizeVarianceImage(self):
        return [np.asarray(self.hdulist["VARIANCE"].data, dtype=np.float32) for _ in self.processable]
