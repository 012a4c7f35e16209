"""Generate stamp coadds for saved results (kbmod-stamps; reference:
src/kbmod_cmdline/kbmod_stamps.py).

    python -m kbmod_tpu_torch.cmdline.kbmod_stamps --input=results.ecsv --workunit=wu.fits --outfile=with_stamps.ecsv \
        --coadds=mean,median --radius=10

The stamps are cut and reduced on CUDA unless ``--device cpu`` is given;
without a card the tool raises.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Append stamp coadds to a KBMOD results file.")
    parser.add_argument("--input", required=True, help="Input results file.")
    parser.add_argument("--workunit", required=True, help="The WorkUnit FITS with image data.")
    parser.add_argument("--outfile", required=True, help="Output results file.")
    parser.add_argument("--coadds", default="mean", help="Comma-separated coadd types.")
    parser.add_argument("--radius", type=int, default=10, help="Stamp radius (pixels).")
    parser.add_argument("--all_stamps", action="store_true", help="Also append the full stamp cube.")
    parser.add_argument("--nightly", action="store_true", help="Per-night coadds.")
    parser.add_argument("--device", default=None, help="Where the stamps are made: cuda (the default) or cpu.")
    args = parser.parse_args(argv)

    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps, append_coadds
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.work_unit import WorkUnit

    device = resolve_device(args.device)
    results = Results.read_table(args.input)
    work = WorkUnit.from_fits(args.workunit)
    coadd_types = [c.strip() for c in args.coadds.split(",") if c.strip()]
    append_coadds(results, work.im_stack, coadd_types, args.radius, nightly=args.nightly, device=device)
    if args.all_stamps:
        append_all_stamps(results, work.im_stack, args.radius, device=device)
    results.write_table(args.outfile, overwrite=True)
    print(f"Wrote {len(results)} results with coadds {coadd_types} to {args.outfile}")


if __name__ == "__main__":
    main()
