"""The plain reference of the reflex-corrected reprojection
(``benchmarks/reference/ebd.py``) on its own: its Earth ephemeris against
the astropy/DE432s golden values that the port's tests pin, its TAN
projection and parallax correction both ways, the resample of an
unchanged frame and the mosaic's collisions."""

import math
from datetime import datetime, timezone

import pytest
import torch

from benchmarks.reference import ebd


def _mjd(iso):
    dt = datetime.fromisoformat(iso).replace(tzinfo=timezone.utc)
    return (dt - datetime(1858, 11, 17, tzinfo=timezone.utc)).total_seconds() / 86400.0


# The reference's equinox case (kbmod tests/test_reprojection_utils.py,
# pinned by the port's tests/test_reprojection.py::TestParallaxGoldenValues):
# seen from the geocentre, these directions of an object at 50 AU are
# (ra 90, dec 23.43952556) from the barycentre, by astropy with DE432s.
GOLDEN = [("2023-03-20T16:00:00", 88.74513571, 23.43426475), ("2023-09-24T04:00:00", 91.24261107, 23.43437467)]
WANT = (90.0, 23.43952556)


@pytest.mark.parametrize("iso, ra, dec", GOLDEN)
def test_ephemeris_against_the_golden_values(iso, ra, dec):
    got = ebd.correct(ebd.unit(ra, dec), _mjd(iso), 50.0)
    g_ra, g_dec = (float(v) for v in ebd.radec(got))
    # The port's test allows 2e-4 deg in RA and 1e-4 deg in Dec; VSOP87's
    # Earth reads 0.061 and 0.053 arcsec here (1.5e-5 AU at 50 AU).
    assert abs(g_ra - WANT[0]) < 2e-5 and abs(g_dec - WANT[1]) < 2e-5
    assert float(ebd.separation_arcsec(got, ebd.unit(*WANT))) < 0.08


def test_earth_is_about_an_au_from_the_sun():
    t = torch.linspace(60000.0, 60365.0, 13, dtype=torch.float64)
    r = torch.linalg.vector_norm(ebd.earth(t, heliocentric=True), dim=-1)
    assert float(r.min()) > 0.982 and float(r.max()) < 1.018
    offset = torch.linalg.vector_norm(ebd.earth(t) - ebd.earth(t, heliocentric=True), dim=-1)
    assert float(offset.max()) < 0.02  # the Sun's barycentric offset, Jupiter's mostly


def test_tan_both_ways():
    step = 0.263 / 3600.0
    tan = ebd.Tan((100.5, 40.5), (26.9, 11.1), ((-step, 0.0), (0.0, step)))
    x = torch.tensor([0.0, 99.5, 250.0, -30.0], dtype=torch.float64)
    y = torch.tensor([0.0, 39.5, 7.0, 300.0], dtype=torch.float64)
    gx, gy = tan.vec_to_pixel(tan.pixel_to_vec(x, y))
    assert torch.allclose(gx, x, atol=1e-9) and torch.allclose(gy, y, atol=1e-9)
    # CRPIX is the 1-based pixel of CRVAL; east is left.
    ra, dec = ebd.radec(tan.pixel_to_vec(torch.tensor(99.5), torch.tensor(39.5)))
    assert abs(float(ra) - 26.9) < 1e-12 and abs(float(dec) - 11.1) < 1e-12
    ra1, _ = ebd.radec(tan.pixel_to_vec(torch.tensor(0.0), torch.tensor(39.5)))
    assert float(ra1) > 26.9


def test_correct_and_invert_are_inverses():
    site = ebd.site_vector(-30.16527778, -70.815, 2215.0)
    assert abs(float(torch.linalg.vector_norm(site)) * ebd.AU_M - 6.373e6) < 5e3
    u = ebd.unit([26.9, 30.0, 200.0], [11.1, -5.0, 40.0])
    t = torch.tensor([60605.2, 60606.2, 60700.0], dtype=torch.float64)
    corrected = ebd.correct(u, t, 40.0, site)
    back = ebd.invert(corrected, t, 40.0, site)
    assert float(ebd.separation_arcsec(back, u).max()) < 1e-6
    assert float(ebd.separation_arcsec(corrected, u).max()) > 10.0


def test_resample_of_an_unchanged_frame_keeps_the_image():
    g = torch.Generator().manual_seed(3)
    sci = torch.randn((20, 24), generator=g, dtype=torch.float64)
    var = torch.full((20, 24), 4.0, dtype=torch.float64)
    ys, xs = torch.meshgrid(torch.arange(20.0, dtype=torch.float64), torch.arange(24.0, dtype=torch.float64),
                            indexing="ij")
    J = torch.eye(2, dtype=torch.float64).expand(20, 24, 2, 2)
    out, v, kept = ebd.resample(sci, var, ys, xs, J)
    # Away from the edges the footprint is whole; the kernel is narrower
    # than a pixel's neighbours' weight, so the mean stays near the pixel.
    inner = kept[3:-3, 3:-3]
    assert bool(inner.all()) and not bool(kept[0].any())
    assert torch.allclose(v[kept], torch.full_like(v[kept], 4.0))
    weight = math.exp(-0.5 / (1.3 / (2 * math.sqrt(2 * math.log(2)))) ** 2)
    assert weight < 0.2 and float((out - sci)[3:-3, 3:-3].abs().max()) < 3 * weight * float(sci.abs().max())


def test_mosaic_masks_collisions():
    a = torch.tensor([1.0, 2.0, float("nan"), 4.0], dtype=torch.float64)
    b = torch.tensor([float("nan"), 5.0, 6.0, float("nan")], dtype=torch.float64)
    parts = [(a, a * 0 + 1, ~torch.isnan(a)), (b, b * 0 + 1, ~torch.isnan(b))]
    sci, var, collisions = ebd.mosaic(parts)
    assert collisions == 1
    assert sci[0] == 1.0 and torch.isnan(sci[1]) and sci[2] == 6.0 and sci[3] == 4.0 and torch.isnan(var[1])
