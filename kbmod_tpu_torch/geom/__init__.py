"""Geometry helpers of the port: the MJD and calendar conversions
(time_utils). The WCS and coordinate transforms are not ported yet."""
