"""Geometry helpers of the port: the MJD and calendar conversions
(time_utils), the WCS (wcs) and the ecliptic rotations (ecliptic)."""
