"""The plain reference of the reflex-corrected ("EBD") WorkUnit
reprojection and of the sky positions of its results: plain PyTorch in
float64 (a ``dtype`` asks for less, as the control does), written from the
published descriptions, with no code or state of the program.

- ``Tan``: the gnomonic (TAN) projection both ways (Calabretta & Greisen
  2002, FITS WCS paper II) from a WCS's CRPIX (1-based), CRVAL and CD
  (degrees a pixel) taken as data, on 0-based pixels, written with vectors:
  the plane tangent to the sphere at CRVAL's direction e0, with e_ra
  (east) and e_dec (north) along it, holds the point e0 + xi e_ra + eta
  e_dec of a sky direction p, (xi, eta) = (p . e_ra, p . e_dec) / (p . e0),
  and (xi, eta) = CD (x + 1 - CRPIX1, y + 1 - CRPIX2).
- ``earth``: the Earth's position from the solar system's barycentre, J2000
  equatorial, in AU: the Earth's centre from the Sun by VSOP87 (Bretagnon &
  Francou 1988) as abridged in Meeus 1998, Astronomical Algorithms,
  Appendix III (the series L, B and R of the Earth, in the dynamical
  ecliptic and equinox of date), turned to the mean equator of date by the
  IAU 1976 obliquity of date and precessed to J2000 (Lieske 1977); plus the
  Sun's offset from the barycentre by the Earth and the four giant planets,
  weighted by their masses, the giants on Keplerian orbits (Standish,
  "Keplerian Elements for Approximate Positions of the Major Planets", JPL,
  Table 1, 1800-2050, elements with their rates). MJDs are UTC, taken to
  TT by TT - UTC = 69.184 s (the leap seconds since 2017).
  Departures: the abridged series leave out terms under about 25e-8 (in
  radians of longitude and AU of distance; about 1 arcsecond, or 5e-6 AU,
  in all), the FK5 correction of VSOP87 (0.09 arcseconds), the giants'
  pulls on one another (the Sun's offset off by about 1e-5 AU), the inner
  planets' pull on the Sun (under 2e-6 AU) and TDB - TT (2 ms).
- ``observer``: the Earth plus the site, WGS84 geodetic to geocentric,
  turned by the Greenwich mean sidereal time (IAU 1982, UT1 taken as UTC)
  and precessed from the mean equator of date to J2000 (Lieske 1977);
  nutation and polar motion are left out (under 1 km at the site).
- ``correct`` and ``invert``: the geometric parallax correction at an
  assumed barycentric distance d (KBMOD's ``correct_parallax_geometrically``):
  an observed direction u from the observer at E meets the sphere |P| = d at
  P = E + s u, s = -E.u + sqrt((E.u)^2 + d^2 - |E|^2), and the corrected
  direction is P's. The inverse takes P = d u to the direction of P - E.
  Either takes the observer's positions as data in place of ``observer``'s.
- The EBD WCS fit: a WCS fitted to an image in the EBD frame is right at a
  pixel where it maps the pixel to the corrected direction of where the
  image's own WCS maps it (``correct``). The reference fits none.
- ``resample``: DeForest's (2004) adaptive resampling (astropy reproject's
  ``reproject_adaptive``): an output pixel at source position c with
  Jacobian J (source over output pixels, central differences of half a
  pixel each way) weighs a source pixel p by exp(-q / (2 sigma^2)), q =
  (p - c)^T A'^-1 (p - c), A' = J J^T with its eigenvalues raised to at
  least 1 (the kernel never narrower than a source pixel), sigma = kernel
  width / (2 sqrt(2 ln 2)), and 0 where q > (kernel width x sample region
  width / 2)^2: kernel width 1.3 and sample region width 4. The output is
  the weighted mean over the valid source pixels (science and variance
  finite, inside the image); the footprint is the valid pixels' share of
  the whole weight, and a pixel is kept where it is at least 0.999 (NaN
  elsewhere). Departure: no flux conservation (the program's default).
- ``mosaic``: the constituents of one time are resampled and laid into one
  layer; a pixel kept by more than one of them is masked (NaN), as KBMOD's
  reprojection masks overlaps.
"""

import math

import torch

F64 = torch.float64
DEG = math.pi / 180.0
ARCSEC_PER_RAD = 180.0 / math.pi * 3600.0
AU_M = 149597870700.0
TT_MINUS_UTC_DAYS = 69.184 / 86400.0
OBLIQUITY = 84381.406 / 3600.0 * DEG  # IAU 2006, J2000
KERNEL_WIDTH = 1.3
SAMPLE_REGION_WIDTH = 4.0
FOOTPRINT_THRESHOLD = 0.999

# Standish, Table 1 (1800-2050): a (AU), e, I, L, longitude of perihelion,
# longitude of the ascending node (degrees), each with its rate a century.
ELEMENTS = {
    "jupiter": ((5.20288700, -0.00011607), (0.04838624, -0.00013253), (1.30439695, -0.00183714),
                (34.39644051, 3034.74612775), (14.72847983, 0.21252668), (100.47390909, 0.20469106)),
    "saturn": ((9.53667594, -0.00125060), (0.05386179, -0.00050991), (2.48599187, 0.00193609),
               (49.95424423, 1222.49362201), (92.59887831, -0.41897216), (113.66242448, -0.28867794)),
    "uranus": ((19.18916464, -0.00196176), (0.04725744, -0.00004397), (0.77263783, -0.00242939),
               (313.23810451, 428.48202785), (170.95427630, 0.40805281), (74.01692503, 0.04240589)),
    "neptune": ((30.06992276, 0.00026291), (0.00859048, 0.00005105), (1.77004347, 0.00035372),
                (-55.12002969, 218.45945325), (44.96476227, -0.32241464), (131.78422574, -0.00508664)),
}
# Masses in solar masses (IAU 2009 ratios); the Earth's alone.
MASSES = {"earth": 3.00348959632e-6, "jupiter": 1.0 / 1047.348644, "saturn": 1.0 / 3497.9018,
          "uranus": 1.0 / 22902.98, "neptune": 1.0 / 19412.26}
# VSOP87D of the Earth, abridged (Meeus, Appendix III): per series, per
# power of tau (Julian millennia from J2000), terms (A, B, C) of A cos(B +
# C tau), in 1e-8 radians (L, B) or 1e-8 AU (R).
VSOP_L = (
    ((175347046, 0, 0), (3341656, 4.6692568, 6283.0758500), (34894, 4.62610, 12566.15170),
     (3497, 2.7441, 5753.3849), (3418, 2.8289, 3.5231), (3136, 3.6277, 77713.7715), (2676, 4.4181, 7860.4194),
     (2343, 6.1352, 3930.2097), (1324, 0.7425, 11506.7698), (1273, 2.0371, 529.6910), (1199, 1.1096, 1577.3435),
     (990, 5.233, 5884.927), (902, 2.045, 26.298), (857, 3.508, 398.149), (780, 1.179, 5223.694),
     (753, 2.533, 5507.553), (505, 4.583, 18849.228), (492, 4.205, 775.523), (357, 2.920, 0.067),
     (317, 5.849, 11790.629), (284, 1.899, 796.298), (271, 0.315, 10977.079), (243, 0.345, 5486.778),
     (206, 4.806, 2544.314), (205, 1.869, 5573.143), (202, 2.458, 6069.777), (156, 0.833, 213.299),
     (132, 3.411, 2942.463), (126, 1.083, 20.775), (115, 0.645, 0.980), (103, 0.636, 4694.003),
     (102, 0.976, 15720.839), (102, 4.267, 7.114), (99, 6.21, 2146.17), (98, 0.68, 155.42), (86, 5.98, 161000.69),
     (85, 1.30, 6275.96), (85, 3.67, 71430.70), (80, 1.81, 17260.15), (79, 3.04, 12036.46), (75, 1.76, 5088.63),
     (74, 3.50, 3154.69), (74, 4.68, 801.82), (70, 0.83, 9437.76), (62, 3.98, 8827.39), (61, 1.82, 7084.90),
     (57, 2.78, 6286.60), (56, 4.39, 14143.50), (56, 3.47, 6279.55), (52, 0.19, 12139.55), (52, 1.33, 1748.02),
     (51, 0.28, 5856.48), (49, 0.49, 1194.45), (41, 5.37, 8429.24), (41, 2.40, 19651.05), (39, 6.17, 10447.39),
     (37, 6.04, 10213.29), (37, 2.57, 1059.38), (36, 1.71, 2352.87), (36, 1.78, 6812.77), (33, 0.59, 17789.85),
     (30, 0.44, 83996.85), (30, 2.74, 1349.87), (25, 3.16, 4690.48)),
    ((628331966747, 0, 0), (206059, 2.678235, 6283.075850), (4303, 2.6351, 12566.1517), (425, 1.590, 3.523),
     (119, 5.796, 26.298), (109, 2.966, 1577.344), (93, 2.59, 18849.23), (72, 1.14, 529.69), (68, 1.87, 398.15),
     (67, 4.41, 5507.55), (59, 2.89, 5223.69), (56, 2.17, 155.42), (45, 0.40, 796.30), (36, 0.47, 775.52),
     (29, 2.65, 7.11), (21, 5.34, 0.98), (19, 1.85, 5486.78), (19, 4.97, 213.30), (17, 2.99, 6275.96),
     (16, 0.03, 2544.31), (16, 1.43, 2146.17), (15, 1.21, 10977.08), (12, 2.83, 1748.02), (12, 3.26, 5088.63),
     (12, 5.27, 1194.45), (12, 2.08, 4694.00), (11, 0.77, 553.57), (10, 1.30, 6286.60), (10, 4.24, 1349.87),
     (9, 2.70, 242.73), (9, 5.64, 951.72), (8, 5.30, 2352.87), (6, 2.65, 9437.76), (6, 4.67, 4690.48)),
    ((52919, 0, 0), (8720, 1.0721, 6283.0758), (309, 0.867, 12566.152), (27, 0.05, 3.52), (16, 5.19, 26.30),
     (16, 3.68, 155.42), (10, 0.76, 18849.23), (9, 2.06, 77713.77), (7, 0.83, 775.52), (5, 4.66, 1577.34),
     (4, 1.03, 7.11), (4, 3.44, 5573.14), (3, 5.14, 796.30), (3, 6.05, 5507.55), (3, 1.19, 242.73),
     (3, 6.12, 529.69), (3, 0.31, 398.15), (3, 2.28, 553.57), (2, 4.38, 5223.69), (2, 3.75, 0.98)),
    ((289, 5.844, 6283.076), (35, 0, 0), (17, 5.49, 12566.15), (3, 5.20, 155.42), (1, 4.72, 3.52),
     (1, 5.30, 18849.23), (1, 5.97, 242.73)),
    ((114, 3.142, 0), (8, 4.13, 6283.08), (1, 3.84, 12566.15)),
    ((1, 3.14, 0),),
)
VSOP_B = (
    ((280, 3.199, 84334.662), (102, 5.422, 5507.553), (80, 3.88, 5223.69), (44, 3.70, 2352.87),
     (32, 4.00, 1577.34)),
    ((9, 3.90, 5507.55), (6, 1.73, 5223.69)),
)
VSOP_R = (
    ((100013989, 0, 0), (1670700, 3.0984635, 6283.0758500), (13956, 3.05525, 12566.15170),
     (3084, 5.1985, 77713.7715), (1628, 1.1739, 5753.3849), (1576, 2.8469, 7860.4194), (925, 5.453, 11506.770),
     (542, 4.564, 3930.210), (472, 3.661, 5884.927), (346, 0.964, 5507.553), (329, 5.900, 5223.694),
     (307, 0.299, 5573.143), (243, 4.273, 11790.629), (212, 5.847, 1577.344), (186, 5.022, 10977.079),
     (175, 3.012, 18849.228), (110, 5.055, 5486.778), (98, 0.89, 6069.78), (86, 5.69, 15720.84),
     (86, 1.27, 161000.69), (65, 0.27, 17260.15), (63, 0.92, 529.69), (57, 2.01, 83996.85), (56, 5.24, 71430.70),
     (49, 3.25, 2544.31), (47, 2.58, 775.52), (45, 5.54, 9437.76), (43, 6.01, 6275.96), (39, 5.36, 4694.00),
     (38, 2.39, 8827.39), (37, 0.83, 19651.05), (37, 4.90, 12139.55), (36, 1.67, 12036.46), (35, 1.84, 2942.46),
     (33, 0.24, 7084.90), (32, 0.18, 5088.63), (32, 1.78, 398.15), (28, 1.21, 6286.60), (28, 1.90, 6279.55),
     (26, 4.59, 10447.39)),
    ((103019, 1.107490, 6283.075850), (1721, 1.0644, 12566.1517), (702, 3.142, 0), (32, 1.02, 18849.23),
     (31, 2.84, 5507.55), (25, 1.32, 5223.69), (18, 1.42, 1577.34), (10, 5.91, 10977.08), (9, 1.42, 6275.96),
     (9, 0.27, 5486.78)),
    ((4359, 5.7846, 6283.0758), (124, 5.579, 12566.152), (12, 3.14, 0), (9, 3.63, 77713.77), (6, 1.87, 5573.14),
     (3, 5.47, 18849.23)),
    ((145, 4.273, 6283.076), (7, 3.92, 12566.15)),
    ((4, 2.56, 6283.08),),
)
WGS84_A, WGS84_F = 6378137.0, 1.0 / 298.257223563


def _t(x, dtype, device=None):
    return torch.as_tensor(x, dtype=dtype, device=device)


def unit(ra_deg, dec_deg, dtype=F64):
    """(..., 3) unit vectors of RA and Dec in degrees."""
    ra, dec = _t(ra_deg, dtype) * DEG, _t(dec_deg, dtype) * DEG
    return torch.stack([torch.cos(dec) * torch.cos(ra), torch.cos(dec) * torch.sin(ra), torch.sin(dec)], -1)


def radec(vec):
    """(RA in [0, 360), Dec) in degrees of (..., 3) vectors."""
    r = torch.linalg.vector_norm(vec, dim=-1)
    ra = torch.remainder(torch.atan2(vec[..., 1], vec[..., 0]) / DEG, 360.0)
    return ra, torch.asin(torch.clamp(vec[..., 2] / r, -1.0, 1.0)) / DEG


def separation_arcsec(a, b):
    """Angles between (..., 3) directions, in arcseconds (from the chord)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    chord = torch.linalg.vector_norm(a - b, dim=-1)
    return 2.0 * torch.asin(torch.clamp(chord / 2.0, max=1.0)) * ARCSEC_PER_RAD


class Tan:
    """A TAN WCS from (crpix, crval, cd) taken as data."""

    def __init__(self, crpix, crval, cd, dtype=F64, device=None):
        self.dtype, self.device = dtype, device
        self.crpix = _t(crpix, dtype, device)
        self.cd = _t(cd, dtype, device).reshape(2, 2)
        self.cd_inv = torch.linalg.inv(self.cd)
        a0, d0 = float(crval[0]) * DEG, float(crval[1]) * DEG
        self.e0 = unit(crval[0], crval[1], dtype).to(device)
        self.e_ra = _t([-math.sin(a0), math.cos(a0), 0.0], dtype, device)
        self.e_dec = _t([-math.sin(d0) * math.cos(a0), -math.sin(d0) * math.sin(a0), math.cos(d0)], dtype, device)

    def pixel_to_vec(self, x, y):
        """(..., 3) unit directions of 0-based pixels."""
        u = _t(x, self.dtype, self.device) + 1.0 - self.crpix[0]
        v = _t(y, self.dtype, self.device) + 1.0 - self.crpix[1]
        xi = (self.cd[0, 0] * u + self.cd[0, 1] * v) * DEG
        eta = (self.cd[1, 0] * u + self.cd[1, 1] * v) * DEG
        p = self.e0 + xi[..., None] * self.e_ra + eta[..., None] * self.e_dec
        return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)

    def vec_to_pixel(self, p):
        """0-based (x, y) of (..., 3) directions; NaN for a direction on or
        behind the tangent plane's horizon."""
        p = _t(p, self.dtype, self.device)
        den = (p * self.e0).sum(-1)
        ahead = den > 0
        den = torch.where(ahead, den, 1.0)
        xi = (p * self.e_ra).sum(-1) / den / DEG
        eta = (p * self.e_dec).sum(-1) / den / DEG
        x = self.cd_inv[0, 0] * xi + self.cd_inv[0, 1] * eta + self.crpix[0] - 1.0
        y = self.cd_inv[1, 0] * xi + self.cd_inv[1, 1] * eta + self.crpix[1] - 1.0
        nan = torch.full((), float("nan"), dtype=self.dtype, device=self.device)
        return torch.where(ahead, x, nan), torch.where(ahead, y, nan)


# --- the Earth and the observer ---


def _centuries(mjd_utc, dtype):
    return (_t(mjd_utc, dtype) + TT_MINUS_UTC_DAYS - 51544.5) / 36525.0


def _kepler(name, T):
    """Heliocentric J2000 ecliptic (..., 3) position of a body of Standish's
    table at T Julian centuries from J2000."""
    (a, e, inc, L, peri, node) = (c0 + c1 * T for c0, c1 in ELEMENTS[name])
    omega = (peri - node) * DEG
    M = torch.remainder(L - peri + 180.0, 360.0) * DEG - math.pi
    E = M + e * torch.sin(M)
    for _ in range(8):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    xp = a * (torch.cos(E) - e)
    yp = a * torch.sqrt(1.0 - e * e) * torch.sin(E)
    co, so = torch.cos(omega), torch.sin(omega)
    cn, sn = torch.cos(node * DEG), torch.sin(node * DEG)
    ci, si = torch.cos(inc * DEG), torch.sin(inc * DEG)
    x = (co * cn - so * sn * ci) * xp + (-so * cn - co * sn * ci) * yp
    y = (co * sn + so * cn * ci) * xp + (-so * sn + co * cn * ci) * yp
    z = (so * si) * xp + (co * si) * yp
    return torch.stack([x, y, z], -1)


def _vsop(series, tau):
    """One VSOP87 series (L, B or R) at tau Julian millennia, in radians or AU."""
    out = torch.zeros_like(tau)
    for k, terms in enumerate(series):
        a, b, c = (_t([term[i] for term in terms], tau.dtype, tau.device) for i in range(3))
        out = out + (a * torch.cos(b + c * tau[..., None])).sum(-1) * tau**k
    return out * 1e-8


def _equator_of_date_to_j2000(T):
    """(..., 3, 3) matrices taking mean-equator-of-date vectors to J2000
    (Lieske 1977): P = Rz(-z) Ry(theta) Rz(-zeta) takes J2000 to the date,
    its transpose back."""
    arcsec = DEG / 3600.0
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * arcsec
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * arcsec
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * arcsec
    return (_rz(-z) @ _ry(theta) @ _rz(-zeta)).transpose(-1, -2)


def _earth_heliocentric(T):
    """J2000 equatorial (..., 3) position of the Earth's centre from the Sun
    at T Julian centuries (TT) from J2000, in AU."""
    tau = T / 10.0
    lon, lat, r = _vsop(VSOP_L, tau), _vsop(VSOP_B, tau), _vsop(VSOP_R, tau)
    ecl = torch.stack([r * torch.cos(lat) * torch.cos(lon), r * torch.cos(lat) * torch.sin(lon),
                       r * torch.sin(lat)], -1)
    eps = (84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3) * (DEG / 3600.0)
    c, s = torch.cos(eps), torch.sin(eps)
    of_date = torch.stack([ecl[..., 0], c * ecl[..., 1] - s * ecl[..., 2], s * ecl[..., 1] + c * ecl[..., 2]], -1)
    return torch.einsum("...ij,...j->...i", _equator_of_date_to_j2000(T), of_date)


def ecliptic_to_equatorial(vec):
    c, s = math.cos(OBLIQUITY), math.sin(OBLIQUITY)
    return torch.stack([vec[..., 0], c * vec[..., 1] - s * vec[..., 2], s * vec[..., 1] + c * vec[..., 2]], -1)


def equatorial_to_ecliptic(vec):
    c, s = math.cos(OBLIQUITY), math.sin(OBLIQUITY)
    return torch.stack([vec[..., 0], c * vec[..., 1] + s * vec[..., 2], -s * vec[..., 1] + c * vec[..., 2]], -1)


def earth(mjd_utc, dtype=F64, heliocentric=False):
    """(..., 3) J2000 equatorial position of the Earth's centre in AU, from
    the barycentre (or from the Sun with ``heliocentric``)."""
    T = _centuries(mjd_utc, dtype)
    helio = _earth_heliocentric(T)
    if heliocentric:
        return helio
    total = 1.0 + sum(MASSES.values())
    giants = sum(MASSES[n] * ecliptic_to_equatorial(_kepler(n, T)) for n in ("jupiter", "saturn", "uranus", "neptune"))
    return helio - (MASSES["earth"] * helio + giants) / total


def site_vector(lat_deg, lon_deg, height_m, dtype=F64):
    """WGS84 geocentric (3,) position of a site in AU."""
    lat, lon = lat_deg * DEG, lon_deg * DEG
    e2 = WGS84_F * (2.0 - WGS84_F)
    n = WGS84_A / math.sqrt(1.0 - e2 * math.sin(lat) ** 2)
    xyz = [(n + height_m) * math.cos(lat) * math.cos(lon), (n + height_m) * math.cos(lat) * math.sin(lon),
           (n * (1.0 - e2) + height_m) * math.sin(lat)]
    return _t(xyz, dtype) / AU_M


def _rz(angle):
    """(..., 3, 3) matrices that turn a frame by ``angle`` about z (passive)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1), torch.stack([z, z, o], -1)], -2)


def _ry(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, -s], -1), torch.stack([z, o, z], -1), torch.stack([s, z, c], -1)], -2)


def site_offset(mjd_utc, site, dtype=F64):
    """(..., 3) J2000 equatorial offset of a site (a (3,) Earth-fixed vector)
    from the Earth's centre at each MJD."""
    mjd = _t(mjd_utc, dtype)
    d = mjd - 51544.5  # days from J2000 on the UT1 (~UTC) scale
    Tu = d / 36525.0
    gmst = torch.remainder(280.46061837 + 360.98564736629 * d + 0.000387933 * Tu**2 - Tu**3 / 38710000.0, 360.0)
    # Mean equator of date: the site turned east by GMST (the frame turned by -GMST).
    of_date = torch.einsum("...ij,j->...i", _rz(-gmst * DEG), _t(site, dtype, mjd.device))
    return torch.einsum("...ij,...j->...i", _equator_of_date_to_j2000(_centuries(mjd_utc, dtype)), of_date)


def observer(mjd_utc, site=None, dtype=F64):
    """(..., 3) barycentric J2000 equatorial position of the observer in AU:
    the Earth's centre, plus the site (a (3,) Earth-fixed vector in AU)."""
    pos = earth(mjd_utc, dtype)
    return pos if site is None else pos + site_offset(mjd_utc, site, dtype)


def _observer(mjd_utc, site, observer_au, like):
    E = observer(mjd_utc, site, like.dtype) if observer_au is None else _t(observer_au, like.dtype)
    return E.to(like.device)


def correct(directions, mjd_utc, distance, site=None, observer_au=None):
    """Corrected (..., 3) unit directions of observed (..., 3) directions at
    an assumed barycentric distance; NaN where the line of sight misses the
    sphere. ``observer_au``, (..., 3) barycentric positions, replaces the
    observer of ``mjd_utc`` and ``site``."""
    E = _observer(mjd_utc, site, observer_au, directions)
    eu = (E * directions).sum(-1)
    disc = eu**2 + distance**2 - (E * E).sum(-1)
    s = -eu + torch.sqrt(torch.clamp(disc, min=0.0))
    ok = (disc >= 0) & (s > 0)
    P = E + s[..., None] * directions
    P = P / torch.linalg.vector_norm(P, dim=-1, keepdim=True)
    return torch.where(ok[..., None], P, float("nan"))


def invert(directions, mjd_utc, distance, site=None, observer_au=None):
    """Observed (..., 3) unit directions of barycentric (..., 3) directions at
    ``distance``; ``observer_au`` as in ``correct``."""
    E = _observer(mjd_utc, site, observer_au, directions)
    rel = distance * directions - E
    return rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True)


def ecliptic_angle(common, x, y, step_deg=1e-3):
    """The direction of increasing ecliptic longitude at pixel (x, y) of a
    frame, in radians in pixel space."""
    p = equatorial_to_ecliptic(common.pixel_to_vec(x, y))
    lon = torch.atan2(p[..., 1], p[..., 0])
    lat = torch.asin(p[..., 2])
    lon = lon + step_deg * DEG
    q = torch.stack([torch.cos(lat) * torch.cos(lon), torch.cos(lat) * torch.sin(lon), torch.sin(lat)], -1)
    x1, y1 = common.vec_to_pixel(ecliptic_to_equatorial(q))
    return float(torch.atan2(y1 - y, x1 - x))


# --- resampling and mosaic ---


def source_coordinates(common, source, ys, xs):
    """(sy, sx, J) at output pixels (ys, xs) of the frame ``common``: the
    source pixel of each and the (..., 2, 2) Jacobian d(sy, sx) / d(y, x) by
    central differences of half a pixel. ``source`` maps directions to its
    pixels (``vec_to_pixel``)."""
    dtype = common.dtype
    ys = _t(ys, dtype, common.device)
    xs = _t(xs, dtype, common.device)

    def at(dy, dx):
        sx, sy = source.vec_to_pixel(common.pixel_to_vec(xs + dx, ys + dy))
        return sy, sx

    sy, sx = at(0.0, 0.0)
    yp, yn, xp, xn = at(0.5, 0.0), at(-0.5, 0.0), at(0.0, 0.5), at(0.0, -0.5)
    J = torch.stack([torch.stack([yp[0] - yn[0], xp[0] - xn[0]], -1),
                     torch.stack([yp[1] - yn[1], xp[1] - xn[1]], -1)], -2)
    return sy, sx, J


def resample(sci, var, sy, sx, J, kernel_width=KERNEL_WIDTH, sample_region_width=SAMPLE_REGION_WIDTH,
             threshold=FOOTPRINT_THRESHOLD):
    """(sci, var, kept) of one output grid resampled from one source image
    (module docstring); NaN where not kept. ``sci``/``var`` are (Hs, Ws)
    tensors in the grid's dtype on its device."""
    dtype = sy.dtype
    Hs, Ws = sci.shape
    sigma = kernel_width / (2.0 * math.sqrt(2.0 * math.log(2.0)))
    trunc = 0.5 * kernel_width * sample_region_width
    finite = torch.isfinite(sy) & torch.isfinite(sx) & torch.isfinite(J).all(-1).all(-1)
    cy = torch.where(finite, sy, 0.0)
    cx = torch.where(finite, sx, 0.0)
    Jf = torch.where(finite[..., None, None], J, torch.eye(2, dtype=dtype, device=sy.device))
    lam, vec = torch.linalg.eigh(Jf @ Jf.transpose(-1, -2))
    lam = torch.clamp(lam, min=1.0)
    inv = vec @ torch.diag_embed(1.0 / lam) @ vec.transpose(-1, -2)
    radius = int(math.ceil(trunc * math.sqrt(float(lam.max())))) + 1
    yc, xc = torch.round(cy).to(torch.int64), torch.round(cx).to(torch.int64)
    ok = torch.isfinite(sci) & torch.isfinite(var)
    sci0 = torch.where(ok, sci, 0.0).reshape(-1)
    var0 = torch.where(ok, var, 0.0).reshape(-1)
    okf = ok.reshape(-1)
    num_s = torch.zeros_like(cy)
    num_v = torch.zeros_like(cy)
    w_valid = torch.zeros_like(cy)
    w_all = torch.zeros_like(cy)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            py, px = yc + dy, xc + dx
            ey, ex = py.to(dtype) - cy, px.to(dtype) - cx
            q = inv[..., 0, 0] * ey * ey + 2.0 * inv[..., 0, 1] * ey * ex + inv[..., 1, 1] * ex * ex
            w = torch.where(q <= trunc * trunc, torch.exp(-0.5 * q / (sigma * sigma)), 0.0)
            inside = (py >= 0) & (py < Hs) & (px >= 0) & (px < Ws)
            idx = torch.clamp(py, 0, Hs - 1) * Ws + torch.clamp(px, 0, Ws - 1)
            wv = torch.where(inside & okf[idx], w, 0.0)
            num_s += wv * sci0[idx]
            num_v += wv * var0[idx]
            w_valid += wv
            w_all += w
    kept = finite & (w_valid >= threshold * w_all) & (w_all > 0)
    nan = torch.full((), float("nan"), dtype=dtype, device=sy.device)
    den = torch.where(kept, w_valid, 1.0)
    return torch.where(kept, num_s / den, nan), torch.where(kept, num_v / den, nan), kept


def mosaic(parts):
    """(sci, var, collisions) of one layer from the (sci, var, kept) of its
    constituents: each kept pixel laid in, and a pixel kept by more than one
    masked."""
    sci = torch.full_like(parts[0][0], float("nan"))
    var = torch.full_like(parts[0][1], float("nan"))
    count = torch.zeros(sci.shape, dtype=torch.int64, device=sci.device)
    for s, v, kept in parts:
        sci = torch.where(kept, s, sci)
        var = torch.where(kept, v, var)
        count += kept
    collide = count > 1
    return torch.where(collide, float("nan"), sci), torch.where(collide, float("nan"), var), int(collide.sum())
