"""MJD <-> calendar helpers (astropy.time replacement for the small subset
kbmod needs)."""

import datetime

MJD_EPOCH = datetime.datetime(1858, 11, 17, tzinfo=datetime.timezone.utc)


def mjd_to_datetime(mjd):
    """MJD (UTC) -> timezone-aware datetime."""
    return MJD_EPOCH + datetime.timedelta(days=float(mjd))


def datetime_to_mjd(dt):
    """datetime -> MJD (UTC)."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return (dt - MJD_EPOCH).total_seconds() / 86400.0


def mjd_to_day_string(mjd):
    """MJD -> 'YYYY-MM-DD'."""
    return mjd_to_datetime(mjd).strftime("%Y-%m-%d")


def mjd_to_night(mjd, utc_offset_hours=-4.0):
    """Group an MJD into an observing night string. The default offset
    approximates Chilean observatories (Rubin/CTIO): the night label is the
    local calendar date at the start of the night."""
    return mjd_to_datetime(mjd + utc_offset_hours / 24.0 - 0.5).strftime("%Y-%m-%d")
