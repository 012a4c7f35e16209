"""Interactively rate result stamps as real/bogus (kbmod-results-rater;
reference: src/kbmod_cmdline/kbmod_results_rater.py + analysis/results_rater).

Console-mode rater: shows per-result statistics (and an ASCII rendering of
the coadd stamp) and records y/n/skip decisions into a 'rating' column.

    python -m kbmod_tpu_torch.cmdline.kbmod_results_rater --input=results.ecsv --outfile=rated.ecsv
"""

import argparse

import numpy as np


def ascii_stamp(stamp, width=21):
    """Render a stamp as ASCII intensity characters."""
    chars = " .:-=+*#%@"
    stamp = np.asarray(stamp, dtype=float)
    lo, hi = np.nanmin(stamp), np.nanmax(stamp)
    scale = (stamp - lo) / (hi - lo + 1e-12)
    out = []
    for row in scale:
        out.append("".join(chars[min(int(v * (len(chars) - 1)), len(chars) - 1)] for v in row))
    return "\n".join(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rate KBMOD results interactively.")
    parser.add_argument("--input", required=True)
    parser.add_argument("--outfile", required=True)
    parser.add_argument("--stamp_col", default="coadd_mean")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument(
        "--gui", action="store_true",
        help="Launch the matplotlib ResultsRater instead of the console flow.",
    )
    args = parser.parse_args(argv)

    from kbmod_tpu_torch.results import Results

    if args.gui:
        from kbmod_tpu_torch.analysis.results_rater import ResultsRater

        rater = ResultsRater(args.input, outfile=args.outfile)
        rater.goto_index(args.start)
        rater.show()
        return

    results = Results.read_table(args.input)
    ratings = np.array(
        results["rating"] if "rating" in results.colnames else [""] * len(results), dtype=object
    )

    for idx in range(args.start, len(results)):
        print(f"\n=== Result {idx}/{len(results)} ===")
        print(
            f"x={results['x'][idx]} y={results['y'][idx]} vx={results['vx'][idx]:.2f} "
            f"vy={results['vy'][idx]:.2f} lh={results['likelihood'][idx]:.2f} "
            f"obs={results['obs_count'][idx]}"
        )
        if args.stamp_col in results.colnames:
            print(ascii_stamp(results[args.stamp_col][idx]))
        answer = input("Real? [y/n/s(kip)/q(uit)] ").strip().lower()
        if answer == "q":
            break
        ratings[idx] = {"y": "real", "n": "bogus", "s": ""}.get(answer, "")

    results.table["rating"] = ratings
    results.write_table(args.outfile, overwrite=True)
    print(f"Wrote ratings to {args.outfile}")


if __name__ == "__main__":
    main()
