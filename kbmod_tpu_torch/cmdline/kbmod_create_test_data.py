"""Create fake test data (kbmod-create-test-data; reference:
src/kbmod_cmdline/kbmod_create_test_data.py).

    python -m kbmod_tpu_torch.cmdline.kbmod_create_test_data --outfile=test_wu.fits --num_times=20 --width=256 --height=256 \
        --num_objects=2 --flux=300

Host work only: the port's ``FakeDataSet`` is numpy, as the JAX package's.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create a fake WorkUnit for testing.")
    parser.add_argument("--outfile", required=True, help="Output WorkUnit FITS file.")
    parser.add_argument("--num_times", type=int, default=20)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--num_objects", type=int, default=1)
    parser.add_argument("--flux", type=float, default=300.0)
    parser.add_argument("--noise", type=float, default=2.0)
    parser.add_argument("--psf_std", type=float, default=1.0)
    parser.add_argument("--mask_fraction", type=float, default=0.0)
    parser.add_argument("--obs_per_day", type=int, default=4)
    parser.add_argument("--t0", type=float, default=60676.0)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times

    times = create_fake_times(args.num_times, t0=args.t0, obs_per_day=args.obs_per_day)
    ds = FakeDataSet(
        args.width,
        args.height,
        times,
        noise_level=args.noise,
        psf_val=args.psf_std,
        mask_fraction=args.mask_fraction,
        use_seed=args.seed,
    )
    inserted = [ds.insert_random_object(args.flux) for _ in range(args.num_objects)]
    ds.save_fake_data_to_work_unit(args.outfile)
    print(f"Wrote {args.outfile} with {args.num_objects} objects:")
    for trj in inserted:
        print(f"  {trj}")


if __name__ == "__main__":
    main()
