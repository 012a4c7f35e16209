"""Geometry helpers of the port: the MJD and calendar conversions
(time_utils), the WCS (wcs), the ecliptic rotations and ephemeris
(ecliptic) and the WGS84 geodetic conversions (geodesy)."""
