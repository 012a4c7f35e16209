"""Print summary statistics of a results file (kbmod-stats; reference:
src/kbmod_cmdline/kbmod_stats.py).

    python -m kbmod_tpu_torch.cmdline.kbmod_stats --input=results.ecsv
"""

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Display statistics of a KBMOD results file.")
    parser.add_argument("--input", required=True, help="Input results file.")
    args = parser.parse_args(argv)

    from kbmod_tpu_torch.results import Results

    results = Results.read_table(args.input)
    print(f"Results file: {args.input}")
    print(f"  Rows: {len(results)}")
    print(f"  Columns: {results.colnames}")
    if results.mjd_mid is not None:
        print(f"  Times: {len(results.mjd_mid)} spanning [{results.mjd_mid.min()}, {results.mjd_mid.max()}]")
    if len(results) > 0:
        for col in ("likelihood", "flux", "obs_count", "vx", "vy"):
            vals = np.asarray(results[col], dtype=float)
            print(f"  {col}: min={vals.min():.4f} median={np.median(vals):.4f} max={vals.max():.4f}")
    if results.filtered_stats:
        print(f"  Filtered stats: {results.filtered_stats}")


if __name__ == "__main__":
    main()
