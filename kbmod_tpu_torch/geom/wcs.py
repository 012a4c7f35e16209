"""A self-contained World Coordinate System (no astropy).

Copy of the JAX package's geom/wcs.py (pure numpy), with its imports
pointed at the port. The reference relies on astropy.wcs
(src/kbmod/wcs_utils.py); this module implements the FITS-WCS math
directly: CRPIX/CRVAL/CD (or CDELT+PC) keywords, the zenithal projections
real survey data uses (TAN, SIN, STG, ARC, ZEA), SIP polynomial distortion
(``RA---TAN-SIP`` A/B forward and AP/BP inverse coefficients, with a Newton
fallback when the inverse polynomials are absent), and a 0-based pixel API
matching astropy's ``origin=0`` convention. Vectorized numpy transforms on
the host.
"""

import math

import numpy as np

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi

# Zenithal projections: theta(R) and R(theta) with R in radians of
# native radial distance (FITS WCS paper II, Calabretta & Greisen 2002).
_ZENITHAL = {
    "TAN": (
        lambda R: np.arctan2(1.0, R),
        lambda theta: 1.0 / np.tan(np.maximum(theta, 1e-12)),
    ),
    "SIN": (
        lambda R: np.arccos(np.clip(R, 0.0, 1.0)),
        lambda theta: np.cos(theta),
    ),
    "ARC": (
        lambda R: np.pi / 2 - R,
        lambda theta: np.pi / 2 - theta,
    ),
    "STG": (
        lambda R: np.pi / 2 - 2 * np.arctan(R / 2.0),
        lambda theta: 2.0 * np.tan((np.pi / 2 - theta) / 2.0),
    ),
    "ZEA": (
        lambda R: np.pi / 2 - 2 * np.arcsin(np.clip(R / 2.0, -1.0, 1.0)),
        lambda theta: 2.0 * np.sin((np.pi / 2 - theta) / 2.0),
    ),
}


class SIP:
    """SIP distortion polynomials (Shupe et al. 2005).

    ``a``/``b`` map relative pixel (u, v) -> distortion added before the
    linear CD transform; ``ap``/``bp`` are the optional inverse
    polynomials. Coefficients are dicts {(i, j): value} with i + j <=
    order, exactly the A_i_j / B_i_j / AP_i_j / BP_i_j header cards.
    """

    def __init__(self, a=None, b=None, ap=None, bp=None):
        self.a = dict(a) if a else {}
        self.b = dict(b) if b else {}
        self.ap = dict(ap) if ap else {}
        self.bp = dict(bp) if bp else {}

    @staticmethod
    def _poly(coeffs, u, v):
        out = np.zeros(np.broadcast(u, v).shape, dtype=float)
        for (i, j), c in coeffs.items():
            out = out + c * (u**i) * (v**j)
        return out

    def forward(self, u, v):
        """(u, v) -> (u + A(u,v), v + B(u,v))."""
        return u + self._poly(self.a, u, v), v + self._poly(self.b, u, v)

    @property
    def has_inverse(self):
        return bool(self.ap or self.bp)

    def inverse(self, U, V, newton_iters=5):
        """Invert the forward map: find (u, v) with forward(u, v) = (U, V).

        Uses AP/BP when present (astropy's convention: u = U + AP(U, V)),
        refined/backstopped by Newton fixed-point iterations that converge
        to < 1e-6 px for survey-scale distortions.
        """
        if self.has_inverse:
            u = U + self._poly(self.ap, U, V)
            v = V + self._poly(self.bp, U, V)
        else:
            u, v = np.asarray(U, dtype=float), np.asarray(V, dtype=float)
        for _ in range(newton_iters):
            fu, fv = self.forward(u, v)
            u = u - (fu - U)
            v = v - (fv - V)
        return u, v

    # --- header (de)serialization ---

    @staticmethod
    def _coeffs_from_header(header, prefix):
        get = header.get if hasattr(header, "get") else header.__getitem__
        order = get(f"{prefix}_ORDER", None)
        if order is None:
            return {}
        coeffs = {}
        for i in range(int(order) + 1):
            for j in range(int(order) + 1 - i):
                key = f"{prefix}_{i}_{j}"
                if key in header:
                    coeffs[(i, j)] = float(get(key))
        return coeffs

    @classmethod
    def from_header(cls, header):
        a = cls._coeffs_from_header(header, "A")
        b = cls._coeffs_from_header(header, "B")
        ap = cls._coeffs_from_header(header, "AP")
        bp = cls._coeffs_from_header(header, "BP")
        if not (a or b or ap or bp):
            return None
        return cls(a, b, ap, bp)

    def to_header(self):
        out = {}
        for prefix, coeffs in (("A", self.a), ("B", self.b), ("AP", self.ap), ("BP", self.bp)):
            if not coeffs:
                continue
            out[f"{prefix}_ORDER"] = max(i + j for i, j in coeffs)
            for (i, j), c in coeffs.items():
                out[f"{prefix}_{i}_{j}"] = float(c)
        return out


class WCS:
    """FITS WCS with zenithal projections and optional SIP distortion.

    Parameters
    ----------
    crpix : (2,) float
        Reference pixel (1-based, FITS convention: crpix[0] = x/col axis).
    crval : (2,) float
        Reference sky position (RA, Dec) in degrees.
    cd : (2, 2) float
        The CD matrix in degrees/pixel: [dRA-like xi; dDec-like eta] =
        CD @ [u; v] with u, v relative pixels.
    shape : (2,) int or None
        Optional (height, width) of the image (naxis2, naxis1).
    ctype : str
        Projection code: one of TAN, SIN, ARC, STG, ZEA (default TAN).
    sip : SIP or None
        SIP distortion polynomials (applied to relative pixels before CD).
    """

    def __init__(self, crpix, crval, cd, shape=None, ctype="TAN", sip=None):
        self.crpix = np.asarray(crpix, dtype=float)
        self.crval = np.asarray(crval, dtype=float)
        self.cd = np.asarray(cd, dtype=float).reshape(2, 2)
        self.array_shape = tuple(int(s) for s in shape) if shape is not None else None
        ctype = str(ctype).upper()
        if ctype not in _ZENITHAL:
            raise ValueError(
                f"Unsupported WCS projection {ctype!r}; supported: {sorted(_ZENITHAL)}"
            )
        self.ctype = ctype
        self.sip = sip

    # --- astropy-compatible aliases ---

    @property
    def pixel_shape(self):
        """(width, height) like astropy's pixel_shape."""
        if self.array_shape is None:
            return None
        return (self.array_shape[1], self.array_shape[0])

    @property
    def cd_inv(self):
        return np.linalg.inv(self.cd)

    def copy(self):
        sip = SIP(self.sip.a, self.sip.b, self.sip.ap, self.sip.bp) if self.sip else None
        return WCS(
            self.crpix.copy(), self.crval.copy(), self.cd.copy(), self.array_shape,
            ctype=self.ctype, sip=sip,
        )

    def deepcopy(self):
        return self.copy()

    # --- transforms (0-based pixels) ---

    def _plane_to_sky(self, xi, eta):
        """Intermediate world coords (radians) -> (ra, dec) radians."""
        ra0 = self.crval[0] * DEG2RAD
        dec0 = self.crval[1] * DEG2RAD
        cos_d0 = math.cos(dec0)
        sin_d0 = math.sin(dec0)
        if self.ctype == "TAN":
            # Closed-form gnomonic de-projection (the hot path).
            den = cos_d0 - eta * sin_d0
            dra = np.arctan2(xi, den)
            ra = (ra0 + dra) % (2 * math.pi)
            dec = np.arctan((sin_d0 + eta * cos_d0) * np.cos(dra) / den)
            return ra, dec
        # Generic zenithal: native spherical (phi, theta) then rotation
        # with the native pole at CRVAL and LONPOLE = 180 deg.
        R = np.hypot(xi, eta)
        theta = _ZENITHAL[self.ctype][0](R)
        phi = np.arctan2(xi, -eta)
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        cos_phi = np.cos(phi)
        # Native -> celestial rotation with LONPOLE = 180 deg:
        # cos(phi - phi_p) = -cos(phi), sin(phi - phi_p) = -sin(phi).
        dec = np.arcsin(np.clip(sin_t * sin_d0 - cos_t * cos_phi * cos_d0, -1.0, 1.0))
        dra = np.arctan2(cos_t * np.sin(phi), sin_t * cos_d0 + cos_t * cos_phi * sin_d0)
        return (ra0 + dra) % (2 * math.pi), dec

    def _sky_to_plane(self, ra, dec):
        """(ra, dec) radians -> intermediate world coords (radians)."""
        ra0 = self.crval[0] * DEG2RAD
        dec0 = self.crval[1] * DEG2RAD
        dra = ra - ra0
        cos_dec = np.cos(dec)
        sin_dec = np.sin(dec)
        cos_d0 = math.cos(dec0)
        sin_d0 = math.sin(dec0)
        if self.ctype == "TAN":
            den = sin_dec * sin_d0 + cos_dec * cos_d0 * np.cos(dra)
            xi = cos_dec * np.sin(dra) / den
            eta = (sin_dec * cos_d0 - cos_dec * sin_d0 * np.cos(dra)) / den
            return xi, eta
        theta = np.arcsin(np.clip(sin_dec * sin_d0 + cos_dec * cos_d0 * np.cos(dra), -1.0, 1.0))
        phi = np.arctan2(cos_dec * np.sin(dra), cos_dec * sin_d0 * np.cos(dra) - sin_dec * cos_d0)
        R = _ZENITHAL[self.ctype][1](theta)
        return R * np.sin(phi), -R * np.cos(phi)

    def pixel_to_world_values(self, x, y):
        """(x, y) 0-based pixels -> (ra, dec) degrees. Vectorized."""
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        u = x + 1.0 - self.crpix[0]
        v = y + 1.0 - self.crpix[1]
        if self.sip is not None:
            u, v = self.sip.forward(u, v)
        xi = (self.cd[0, 0] * u + self.cd[0, 1] * v) * DEG2RAD
        eta = (self.cd[1, 0] * u + self.cd[1, 1] * v) * DEG2RAD
        ra, dec = self._plane_to_sky(xi, eta)
        return ra * RAD2DEG, dec * RAD2DEG

    def world_to_pixel_values(self, ra, dec):
        """(ra, dec) degrees -> (x, y) 0-based pixels. Vectorized."""
        ra = np.asarray(ra, dtype=float) * DEG2RAD
        dec = np.asarray(dec, dtype=float) * DEG2RAD
        xi, eta = self._sky_to_plane(ra, dec)
        xi = xi * RAD2DEG
        eta = eta * RAD2DEG
        inv = self.cd_inv
        u = inv[0, 0] * xi + inv[0, 1] * eta
        v = inv[1, 0] * xi + inv[1, 1] * eta
        if self.sip is not None:
            u, v = self.sip.inverse(u, v)
        return u + self.crpix[0] - 1.0, v + self.crpix[1] - 1.0

    # astropy-style conveniences used throughout the pipeline
    def pixel_to_world(self, x, y):
        ra, dec = self.pixel_to_world_values(x, y)
        return SkyCoordLite(ra, dec)

    def world_to_pixel(self, coord):
        return self.world_to_pixel_values(coord.ra_deg, coord.dec_deg)

    # --- pixel scale ---

    def pixel_scale_deg(self):
        """Approximate pixel scale in degrees/pixel (sqrt of |det CD|)."""
        return math.sqrt(abs(np.linalg.det(self.cd)))

    # --- header round trip ---

    def to_header(self):
        suffix = "-SIP" if self.sip is not None else ""
        header = {
            "WCSAXES": 2,
            "CTYPE1": f"RA---{self.ctype}{suffix}",
            "CTYPE2": f"DEC--{self.ctype}{suffix}",
            "CRPIX1": float(self.crpix[0]),
            "CRPIX2": float(self.crpix[1]),
            "CRVAL1": float(self.crval[0]),
            "CRVAL2": float(self.crval[1]),
            "CD1_1": float(self.cd[0, 0]),
            "CD1_2": float(self.cd[0, 1]),
            "CD2_1": float(self.cd[1, 0]),
            "CD2_2": float(self.cd[1, 1]),
            "CUNIT1": "deg",
            "CUNIT2": "deg",
            "RADESYS": "ICRS",
        }
        if self.sip is not None:
            header.update(self.sip.to_header())
        if self.array_shape is not None:
            header["NAXIS1"] = int(self.array_shape[1])
            header["NAXIS2"] = int(self.array_shape[0])
        return header

    @staticmethod
    def _parse_ctype(value):
        """'RA---TAN-SIP' -> ('TAN', True); missing/empty -> ('TAN', False)."""
        if not value:
            return "TAN", False
        parts = [p for p in str(value).strip().split("-") if p]
        has_sip = bool(parts) and parts[-1].upper() == "SIP"
        if has_sip:
            parts = parts[:-1]
        proj = parts[-1].upper() if len(parts) >= 2 else "TAN"
        return proj, has_sip

    @classmethod
    def from_header(cls, header, strict=True):
        """Build from a FITS-like header dict. Accepts CD or CDELT+PC
        keyword styles, zenithal CTYPEs with an optional -SIP suffix, and
        the reference's DIMM1/DIMM2 image-shape carriers
        (wcs_utils.py:57-99).

        With ``strict`` (the default) a header missing any of
        CRPIX1/2/CRVAL1/2 raises ValueError instead of silently producing
        a plausible-looking wrong WCS; pass strict=False to fill zeros
        (test fixtures only).
        """
        get = header.get if hasattr(header, "get") else header.__getitem__
        required = ("CRPIX1", "CRPIX2", "CRVAL1", "CRVAL2")
        missing = [k for k in required if k not in header]
        if missing and strict:
            raise ValueError(f"WCS header missing required keywords: {missing}")
        crpix = [float(get("CRPIX1", 0.0)), float(get("CRPIX2", 0.0))]
        crval = [float(get("CRVAL1", 0.0)), float(get("CRVAL2", 0.0))]
        if "CD1_1" in header:
            cd = [
                [float(get("CD1_1", 0.0)), float(get("CD1_2", 0.0))],
                [float(get("CD2_1", 0.0)), float(get("CD2_2", 0.0))],
            ]
        else:
            cdelt1 = float(get("CDELT1", 1.0))
            cdelt2 = float(get("CDELT2", 1.0))
            pc11 = float(get("PC1_1", 1.0))
            pc12 = float(get("PC1_2", 0.0))
            pc21 = float(get("PC2_1", 0.0))
            pc22 = float(get("PC2_2", 1.0))
            cd = [[cdelt1 * pc11, cdelt1 * pc12], [cdelt2 * pc21, cdelt2 * pc22]]
        ctype, has_sip = cls._parse_ctype(get("CTYPE1", None))
        sip = SIP.from_header(header) if has_sip or any(
            k in header for k in ("A_ORDER", "B_ORDER")
        ) else None
        shape = None
        if "NAXIS1" in header and "NAXIS2" in header:
            shape = (int(get("NAXIS2")), int(get("NAXIS1")))
        elif "DIMM1" in header and "DIMM2" in header:
            shape = (int(get("DIMM2")), int(get("DIMM1")))
        return cls(crpix, crval, cd, shape, ctype=ctype, sip=sip)

    def __eq__(self, other):
        if not isinstance(other, WCS):
            return NotImplemented
        sip_a = self.sip.to_header() if self.sip else {}
        sip_b = other.sip.to_header() if other.sip else {}
        return (
            np.allclose(self.crpix, other.crpix)
            and np.allclose(self.crval, other.crval)
            and np.allclose(self.cd, other.cd)
            and self.ctype == other.ctype
            and sip_a == sip_b
        )

    def __repr__(self):
        return f"WCS(crpix={self.crpix.tolist()}, crval={self.crval.tolist()}, cd={self.cd.tolist()})"


class SkyCoordLite:
    """A minimal sky-coordinate holder (degrees), vectorized."""

    def __init__(self, ra_deg, dec_deg):
        self.ra_deg = np.asarray(ra_deg, dtype=float)
        self.dec_deg = np.asarray(dec_deg, dtype=float)

    @property
    def ra(self):
        return _Angle(self.ra_deg)

    @property
    def dec(self):
        return _Angle(self.dec_deg)

    def separation_deg(self, other):
        """Angular separation in degrees (Vincenty formula)."""
        l1 = self.ra_deg * DEG2RAD
        b1 = self.dec_deg * DEG2RAD
        l2 = other.ra_deg * DEG2RAD
        b2 = other.dec_deg * DEG2RAD
        dl = l2 - l1
        num = np.hypot(np.cos(b2) * np.sin(dl), np.cos(b1) * np.sin(b2) - np.sin(b1) * np.cos(b2) * np.cos(dl))
        den = np.sin(b1) * np.sin(b2) + np.cos(b1) * np.cos(b2) * np.cos(dl)
        return np.arctan2(num, den) * RAD2DEG

    def __len__(self):
        return self.ra_deg.size

    def __repr__(self):
        return f"SkyCoordLite(ra={self.ra_deg}, dec={self.dec_deg})"


class _Angle:
    """Tiny astropy-Angle-alike exposing .deg / .rad / .arcsec."""

    def __init__(self, deg):
        self._deg = np.asarray(deg, dtype=float)

    @property
    def deg(self):
        return self._deg

    @property
    def degree(self):
        return self._deg

    @property
    def rad(self):
        return self._deg * DEG2RAD

    @property
    def arcsec(self):
        return self._deg * 3600.0

    def __repr__(self):
        return f"Angle({np.array2string(np.atleast_1d(self._deg), precision=6)} deg)"

    def __float__(self):
        return float(self._deg)

    def __array__(self, dtype=None):
        return np.asarray(self._deg, dtype=dtype)
