"""Demo-data helper: the fake demo WorkUnit (copy of the JAX package's
fake_data/demo_helper.py)."""

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.search import Trajectory


def make_demo_data(filename=None):
    """Create the fake demo WorkUnit: a 256x256 stack of 20 images with a
    single bright injected object (vx=10 px/day) and a search configuration
    that covers it (mirrors the reference's demo data shape)."""
    img_width = 256
    img_height = 256
    num_times = 20

    fake_times = create_fake_times(num_times, t0=57130.2)
    ds = FakeDataSet(img_width, img_height, fake_times, use_seed=101)

    trj = Trajectory(x=50, y=40, vx=10, vy=0, flux=500)
    ds.insert_object(trj)

    settings = {
        "generator_config": {
            "name": "EclipticCenteredSearch",
            "velocities": [0, 20.0, 21],
            "angles": [-0.5, 0.5, 11],
            "angle_units": "radian",
            "given_ecliptic": 0.0,
        },
        "clip_negative": True,
        "sigmaG_lims": [15, 60],
    }
    config = SearchConfiguration.from_dict(settings)

    work = ds.get_work_unit(config=config)
    if filename is not None:
        work.to_fits(filename, overwrite=True)
    return work
