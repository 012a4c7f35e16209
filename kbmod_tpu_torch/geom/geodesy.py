"""WGS84 geodetic <-> geocentric conversions (no astropy): a copy of the
JAX package's geom/geodesy.py.

The reference stores observatory locations as astropy EarthLocations and
serializes them as OBS_LAT/OBS_LON/OBS_ELEV header cards
(work_unit.py:565-571, 917-921); kbmod_tpu_torch holds geocentric XYZ meters
internally, so these conversions bridge the two on file IO.
"""

import math

WGS84_A = 6378137.0  # semi-major axis, m
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2


def geodetic_to_geocentric(lat_deg, lon_deg, height_m):
    """(lat, lon, height) -> WGS84 geocentric (x, y, z) meters."""
    lat = math.radians(float(lat_deg))
    lon = math.radians(float(lon_deg))
    h = float(height_m)
    sin_lat = math.sin(lat)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (n + h) * math.cos(lat) * math.cos(lon)
    y = (n + h) * math.cos(lat) * math.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return (x, y, z)


def geocentric_to_geodetic(x, y, z, iters=6):
    """WGS84 geocentric (x, y, z) meters -> (lat_deg, lon_deg, height_m).

    Bowring-style fixed point; sub-millimeter after a few iterations for
    terrestrial points.
    """
    x, y, z = float(x), float(y), float(z)
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    lat = math.atan2(z, p * (1.0 - WGS84_E2))
    for _ in range(int(iters)):
        sin_lat = math.sin(lat)
        n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
        h = p / math.cos(lat) - n if abs(math.cos(lat)) > 1e-12 else z / sin_lat - n * (1.0 - WGS84_E2)
        lat = math.atan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sin_lat = math.sin(lat)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    h = p / math.cos(lat) - n if abs(math.cos(lat)) > 1e-12 else z / sin_lat - n * (1.0 - WGS84_E2)
    return (math.degrees(lat), math.degrees(lon), h)
