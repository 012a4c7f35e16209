"""The reflex-corrected WorkUnit cell cut to a size the CPU runs in seconds:
the same configuration, limits and traffic keys, with small CCDs that
overlap their neighbour (so every exposure is a mosaic with a collision),
a small patch, six exposures over two nights and a small grid."""

import copy

from benchmarks import run as bench_run

CELL = "ebd_reflex.four_nights"


def tiny_cell(name=CELL):
    """(benchmark, cell, configuration, traffic) of the EBD cell cut for the
    CPU."""
    bench, cell, config, traffic = bench_run.load_cell(name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    t0 = traffic["stack"]["times"][0]
    traffic["stack"].update(height=32, width=64, psf_sigmas=[1.0],
                            times=[t0 + night + k * 150.0 / 86400.0 for night in (0, 1) for k in range(3)])
    # CCD B overlaps CCD A by 6 columns, under the patch's columns 30-35.
    traffic["ccd"].update(height=48, width=40, gap=-6, patch_origin=[4, 8], dither_px=3)
    ecl = traffic["grid"]["given_ecliptic"]
    traffic["objects"]["random"].update(tiers=[[2, 300.0]], speed=[3.0, 6.0], angle=[ecl - 0.2, ecl + 0.2], margin=3,
                                        min_separation=30.0)
    traffic["grid"].update(velocities=[2.0, 8.0, 7], angles=[-0.4, 0.4, 5])
    traffic["check"] = {"listed_pixels": 8, "any_pixels": 4, "layer_pixels": 256, "wcs_pixels": 8}
    config["patch_rows"], config["patch_columns"] = 32, 64
    config["search"]["num_obs"] = 4
    return bench, cell, config, traffic


def tiny_run(seed=2**31 + 11, traced=False):
    bench, cell, config, traffic = tiny_cell()
    return bench, cell, bench_run.loop_class(traffic)(cell, config, traffic, seed, "cpu", traced=traced)
