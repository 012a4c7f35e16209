"""Equatorial <-> ecliptic coordinate rotations and a low-precision solar
ephemeris (used for barycentric/parallax geometry without astropy).

Copy of the JAX package's geom/ecliptic.py (pure numpy). All angles in
degrees unless noted. The ecliptic frame uses the J2000 mean obliquity; the
solar position uses the standard low-precision algorithm (accurate to ~0.01
deg, plenty for reflex-correction geometry whose dominant uncertainty is
the guessed barycentric distance).
"""

import math

import numpy as np

# J2000 mean obliquity of the ecliptic (IAU 2006), degrees.
OBLIQUITY_DEG = 23.439279444444445
_EPS = math.radians(OBLIQUITY_DEG)
_COS_EPS = math.cos(_EPS)
_SIN_EPS = math.sin(_EPS)

AU_KM = 149597870.7


def equatorial_to_ecliptic(ra_deg, dec_deg):
    """(RA, Dec) -> ecliptic (lon, lat), all degrees. Vectorized."""
    ra = np.radians(np.asarray(ra_deg, dtype=float))
    dec = np.radians(np.asarray(dec_deg, dtype=float))
    x = np.cos(dec) * np.cos(ra)
    y = np.cos(dec) * np.sin(ra)
    z = np.sin(dec)
    # Rotate about the x-axis by +obliquity.
    ye = _COS_EPS * y + _SIN_EPS * z
    ze = -_SIN_EPS * y + _COS_EPS * z
    lon = np.degrees(np.arctan2(ye, x)) % 360.0
    lat = np.degrees(np.arcsin(np.clip(ze, -1.0, 1.0)))
    return lon, lat


def ecliptic_to_equatorial(lon_deg, lat_deg):
    """Ecliptic (lon, lat) -> (RA, Dec), all degrees. Vectorized."""
    lon = np.radians(np.asarray(lon_deg, dtype=float))
    lat = np.radians(np.asarray(lat_deg, dtype=float))
    x = np.cos(lat) * np.cos(lon)
    ye = np.cos(lat) * np.sin(lon)
    ze = np.sin(lat)
    y = _COS_EPS * ye - _SIN_EPS * ze
    z = _SIN_EPS * ye + _COS_EPS * ze
    ra = np.degrees(np.arctan2(y, x)) % 360.0
    dec = np.degrees(np.arcsin(np.clip(z, -1.0, 1.0)))
    return ra, dec


def sun_position_ecliptic(mjd, of_date=False):
    """Geometric ecliptic longitude (deg) and distance (AU) of the Sun at
    the given MJD (UTC).

    Geometric (no aberration, no nutation) equation-of-center series with
    the longitude precessed from the mean equinox of date back to J2000 —
    the frame every (RA, Dec) in the package lives in. Omitting the
    precession correction displaces the derived Earth position by
    ~0.014 deg/yr of longitude, which dominated the parallax-correction
    error budget (~0.01 deg at 50 AU for 2023 epochs); with it the
    remaining error is the neglected planetary/lunar perturbations
    (~2e-3 deg of longitude ~ 3e-5 AU)."""
    mjd = np.asarray(mjd, dtype=float)
    # Julian centuries from J2000.0 (JD 2451545.0 = MJD 51544.5).
    T = (mjd - 51544.5) / 36525.0
    L0 = 280.46646 + 36000.76983 * T + 0.0003032 * T * T
    M = np.radians(357.52911 + 35999.05029 * T - 0.0001537 * T * T)
    C = (
        (1.914602 - 0.004817 * T) * np.sin(M)
        + (0.019993 - 0.000101 * T) * np.sin(2 * M)
        + 0.000289 * np.sin(3 * M)
    )
    lon = L0 + C  # true geometric longitude, mean equinox of date
    if not of_date:
        # General precession in longitude (IAU76): 5029.0966"/century.
        lon = lon - (1.3969713 * T + 0.000308 * T * T)
    ecc = 0.016708634 - 0.000042037 * T
    nu = M + np.radians(C)
    dist = 1.000001018 * (1.0 - ecc * ecc) / (1.0 + ecc * np.cos(nu))
    return lon % 360.0, dist


# Keplerian mean elements for the giant planets (Standish, "Approximate
# Positions of the Planets", J2000 ecliptic): a (AU), e, I, L0, Ldot
# (deg/century), longitude of perihelion, longitude of node, and mass in
# solar masses. Used only for the Sun's barycentric offset (up to ~0.01 AU,
# Jupiter-dominated), which matters because object distances are specified
# from the solar-system barycenter.
_GIANTS = (
    (5.20288700, 0.04838624, 1.30439695, 34.39644051, 3034.74612775, 14.72847983, 100.47390909, 1.0 / 1047.3486),
    (9.53667594, 0.05386179, 2.48599187, 49.95424423, 1222.49362201, 92.59887831, 113.66242448, 1.0 / 3497.898),
    (19.18916464, 0.04725744, 0.77263783, 313.23810451, 428.48202785, 170.95427630, 74.01692503, 1.0 / 22902.98),
    (30.06992276, 0.00859048, 1.77004347, -55.12002969, 218.45945325, 44.96476227, 131.78422574, 1.0 / 19412.24),
)


def _kepler_solve(M, e, iters=6):
    """Eccentric anomaly from mean anomaly (radians), Newton iterations."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def sun_barycentric_position(mjd):
    """Ecliptic (x, y, z) of the Sun relative to the solar-system
    barycenter, in AU (J2000 ecliptic frame)."""
    mjd = np.asarray(mjd, dtype=float)
    T = (mjd - 51544.5) / 36525.0
    acc = np.zeros(np.shape(T) + (3,))
    total_m = 0.0
    for a, e, inc, L0, Ldot, peri, node, m in _GIANTS:
        L = np.radians(L0 + Ldot * T)
        w = np.radians(peri - node)
        nd = math.radians(node)
        inc_r = math.radians(inc)
        M = L - np.radians(peri)
        E = _kepler_solve(M, e)
        xo = a * (np.cos(E) - e)
        yo = a * math.sqrt(1.0 - e * e) * np.sin(E)
        cw, sw = np.cos(w), np.sin(w)
        cn, sn = math.cos(nd), math.sin(nd)
        ci, si = math.cos(inc_r), math.sin(inc_r)
        x = (cw * cn - sw * sn * ci) * xo + (-sw * cn - cw * sn * ci) * yo
        y = (cw * sn + sw * cn * ci) * xo + (-sw * sn + cw * cn * ci) * yo
        z = (sw * si) * xo + (cw * si) * yo
        acc = acc + m * np.stack([x, y, z], axis=-1)
        total_m += m
    return -acc / (1.0 + total_m)


def earth_position_ecliptic(mjd, barycentric=True):
    """Ecliptic (x, y, z) of the Earth in AU at MJD (UTC), in the J2000
    ecliptic frame, relative to the solar-system barycenter (default) or
    the Sun.

    The Earth is opposite the Sun's geocentric direction; latitude ~0."""
    lon, dist = sun_position_ecliptic(mjd)
    lon_e = np.radians((np.asarray(lon) + 180.0) % 360.0)
    x = dist * np.cos(lon_e)
    y = dist * np.sin(lon_e)
    z = np.zeros_like(x)
    helio = np.stack([x, y, z], axis=-1)
    if not barycentric:
        return helio
    return helio + sun_barycentric_position(mjd)


def radec_unit_vector(ra_deg, dec_deg):
    """Unit vector(s) in equatorial cartesian coordinates."""
    ra = np.radians(np.asarray(ra_deg, dtype=float))
    dec = np.radians(np.asarray(dec_deg, dtype=float))
    return np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)], axis=-1)


def unit_vector_radec(vec):
    """Cartesian (..., 3) -> (ra_deg, dec_deg)."""
    vec = np.asarray(vec, dtype=float)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    ra = np.degrees(np.arctan2(y, x)) % 360.0
    dec = np.degrees(np.arcsin(np.clip(z / r, -1.0, 1.0)))
    return ra, dec


def ecliptic_vec_to_equatorial_vec(vec):
    """Rotate cartesian ecliptic coords to equatorial."""
    vec = np.asarray(vec, dtype=float)
    x = vec[..., 0]
    ye = vec[..., 1]
    ze = vec[..., 2]
    y = _COS_EPS * ye - _SIN_EPS * ze
    z = _SIN_EPS * ye + _COS_EPS * ze
    return np.stack([x, y, z], axis=-1)


def earth_position_equatorial(mjd):
    """Heliocentric equatorial (x, y, z) of the Earth in AU at MJD."""
    return ecliptic_vec_to_equatorial_vec(earth_position_ecliptic(mjd))


# ----------------------------------------------------------------------
# Topocentric observer position (site offset in the J2000 frame)
# ----------------------------------------------------------------------

def gmst_deg(mjd):
    """Greenwich Mean Sidereal Time in degrees (IAU 1982, UT1 ~ UTC)."""
    mjd = np.asarray(mjd, dtype=float)
    d = mjd + 2400000.5 - 2451545.0
    T = d / 36525.0
    gmst = (
        280.46061837
        + 360.98564736629 * d
        + 0.000387933 * T**2
        - T**3 / 38710000.0
    )
    return gmst % 360.0


def _precession_angles_rad(T):
    """Lieske (1977) equatorial precession angles (zeta, z, theta) in
    radians for T Julian centuries since J2000."""
    as2r = math.radians(1.0 / 3600.0)
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * as2r
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * as2r
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * as2r
    return zeta, z, theta


def _rot_z(angle, vec):
    c, s = np.cos(angle), np.sin(angle)
    x = c * vec[..., 0] - s * vec[..., 1]
    y = s * vec[..., 0] + c * vec[..., 1]
    return np.stack([x, y, vec[..., 2]], axis=-1)


def _rot_y(angle, vec):
    c, s = np.cos(angle), np.sin(angle)
    x = c * vec[..., 0] + s * vec[..., 2]
    z = -s * vec[..., 0] + c * vec[..., 2]
    return np.stack([x, vec[..., 1], z], axis=-1)


def itrs_to_j2000(vec_itrs, mjd):
    """Rotate an Earth-fixed (ITRS) vector into the J2000 equatorial
    frame: Earth rotation (GMST) then precession (mean-of-date ->
    J2000). Nutation/polar motion (< 20 arcsec of orientation, sub-km on
    an Earth-radius lever) are neglected — well under the parallax error
    budget at survey distances."""
    mjd = np.atleast_1d(np.asarray(mjd, dtype=float))
    vec = np.broadcast_to(np.asarray(vec_itrs, dtype=float), mjd.shape + (3,))
    tod = _rot_z(np.deg2rad(gmst_deg(mjd)), vec)
    T = (mjd + 2400000.5 - 2451545.0) / 36525.0
    zeta, z, theta = _precession_angles_rad(T)
    # Active rotations: J2000 -> mean-of-date is Az(z) Ay(-theta) Az(zeta)
    # (the passive Rz(-z) Ry(theta) Rz(-zeta) of the standard texts);
    # invert for mean-of-date -> J2000.
    out = _rot_z(-zeta, tod)
    out = _rot_y(theta, out)
    out = _rot_z(-z, out)
    return out


def observer_position_equatorial(mjd, point_on_earth_m=None):
    """Barycentric J2000 equatorial position of an observer (AU): the
    Earth's center plus the rotated geocentric site offset. With
    ``point_on_earth_m=None`` returns the geocenter (the reference's
    correct_parallax takes the site as an EarthLocation,
    reprojection_utils.py:25-120)."""
    earth = earth_position_equatorial(mjd)
    if point_on_earth_m is None:
        return earth
    site_au = np.asarray(point_on_earth_m, dtype=float) / AU_KM / 1000.0
    return earth + itrs_to_j2000(site_au, mjd).reshape(earth.shape)
