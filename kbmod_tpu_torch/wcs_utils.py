"""WCS helper utilities.

Copy of the JAX package's wcs_utils.py (pure numpy), API-compatible with
the reference's kbmod.wcs_utils (src/kbmod/wcs_utils.py): ecliptic angle
computation, WCS (de)serialization to/from strings and header dicts,
fake-WCS construction, and equality checks, implemented on
kbmod_tpu_torch.geom.wcs.WCS instead of astropy.
"""

import json
import math

import numpy as np

from kbmod_tpu_torch.geom.wcs import WCS
from kbmod_tpu_torch.geom.ecliptic import equatorial_to_ecliptic, ecliptic_to_equatorial


def calc_ecliptic_angle(wcs, center_pixel=(1000, 2000), step=12):
    """The angle (radians, in pixel space) of the ecliptic at a given pixel:
    move ``step`` pixels' worth along the ecliptic from the center pixel and
    measure the pixel-space direction (reference wcs_utils.py:10-56)."""
    ra0, dec0 = wcs.pixel_to_world_values(center_pixel[0], center_pixel[1])
    lon0, lat0 = equatorial_to_ecliptic(ra0, dec0)
    # Step along the ecliptic (constant latitude) by step * pixel_scale.
    dlon = step * wcs.pixel_scale_deg()
    ra1, dec1 = ecliptic_to_equatorial(lon0 + dlon, lat0)
    x0, y0 = wcs.world_to_pixel_values(ra0, dec0)
    x1, y1 = wcs.world_to_pixel_values(ra1, dec1)
    return float(np.arctan2(y1 - y0, x1 - x0))


def serialize_wcs(wcs):
    """WCS -> JSON header string (round-trips with deserialize_wcs)."""
    if wcs is None:
        return ""
    return json.dumps(wcs.to_header())


def deserialize_wcs(wcs_str):
    """JSON header string (or dict) -> WCS (None for empty/'none')."""
    if wcs_str is None:
        return None
    if isinstance(wcs_str, dict):
        return WCS.from_header(wcs_str)
    if isinstance(wcs_str, bytes):
        wcs_str = wcs_str.decode()
    if wcs_str == "" or wcs_str.lower() == "none":
        return None
    return WCS.from_header(json.loads(wcs_str))


def wcs_to_dict(wcs):
    """WCS -> header dict (astropy-compatible keyword names)."""
    return {} if wcs is None else wcs.to_header()


def wcs_from_dict(data):
    """Header dict -> WCS."""
    if not data:
        return None
    return WCS.from_header(data)


def append_wcs_to_hdu_header(wcs, header):
    """Write the WCS keywords into a FITS header (dict-like)."""
    if wcs is not None:
        for key, value in wcs.to_header().items():
            header[key] = value
    return header


def extract_wcs_from_hdu_header(header):
    """Read a WCS from a FITS header; None when no CRVAL keys present."""
    if header is None or "CRVAL1" not in header:
        return None
    try:
        return WCS.from_header(header)
    except Exception:
        return None


def make_fake_wcs(center_ra, center_dec, height, width, deg_per_pixel=None):
    """Create a simple north-up TAN WCS centered on (center_ra, center_dec)
    covering height x width pixels (reference wcs_utils.py:167-213)."""
    if deg_per_pixel is None:
        deg_per_pixel = 0.25 / 3600.0  # 0.25 arcsec/pixel
    crpix = [width / 2.0 + 0.5, height / 2.0 + 0.5]
    crval = [center_ra, center_dec]
    # RA increases to the left on the sky; use the conventional negative
    # CD1_1 so east is -x.
    cd = [[-deg_per_pixel, 0.0], [0.0, deg_per_pixel]]
    return WCS(crpix, crval, cd, shape=(height, width))


def make_fake_wcs_info(center_ra, center_dec, height, width, deg_per_pixel=None):
    """Like make_fake_wcs but returning the raw header dict."""
    return make_fake_wcs(center_ra, center_dec, height, width, deg_per_pixel).to_header()


def wcs_fits_equal(wcs_a, wcs_b):
    """Check that two WCS objects are equal at FITS-keyword level."""
    if wcs_a is None or wcs_b is None:
        return wcs_a is wcs_b
    ha = wcs_a.to_header()
    hb = wcs_b.to_header()
    if set(ha.keys()) != set(hb.keys()):
        return False
    for key, va in ha.items():
        vb = hb[key]
        if isinstance(va, float):
            if not math.isclose(va, vb, rel_tol=1e-12, abs_tol=1e-12):
                return False
        elif va != vb:
            return False
    return True
