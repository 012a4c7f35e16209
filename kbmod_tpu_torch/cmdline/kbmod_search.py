"""Run a full KBMOD search on a WorkUnit file (kbmod-search).

    python -m kbmod_tpu_torch.cmdline.kbmod_search --workunit=input_wu.fits --outfile=results.ecsv

The search runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run a KBMOD search from a WorkUnit file.")
    parser.add_argument("--workunit", required=True, help="The input WorkUnit FITS file.")
    parser.add_argument("--outfile", default=None, help="The results output file (.ecsv/.parquet/.hdf5).")
    parser.add_argument("--config", default=None, help="Optional YAML config overriding the WorkUnit's.")
    parser.add_argument("--device", default=None, help="Where the search runs: cuda (the default) or cpu.")
    parser.add_argument("--verbose", action="store_true", help="Enable debug logging.")
    args = parser.parse_args(argv)

    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)

    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.work_unit import WorkUnit

    work = WorkUnit.from_fits(args.workunit)
    if args.config is not None:
        work.config = SearchConfiguration.from_file(args.config)
    if args.outfile is not None:
        work.config.set("result_filename", args.outfile)

    runner = SearchRunner(device=args.device)
    results = runner.run_search_from_work_unit(work)
    print(f"Search produced {len(results)} results.")


if __name__ == "__main__":
    main()
