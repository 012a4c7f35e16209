"""Strip heavy columns from a results file (kbmod-strip-results;
reference: src/kbmod_cmdline/kbmod_strip_results.py).

    python -m kbmod_tpu_torch.cmdline.kbmod_strip_results --input=results.ecsv --outfile=light.ecsv --cols=all_stamps,psi_curve
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Remove columns from a KBMOD results file.")
    parser.add_argument("--input", required=True)
    parser.add_argument("--outfile", required=True)
    parser.add_argument(
        "--cols",
        default="all_stamps,psi_curve,phi_curve,obs_valid,pred_x,pred_y,img_ra,img_dec",
        help="Comma-separated columns to remove when present.",
    )
    args = parser.parse_args(argv)

    from kbmod_tpu_torch.results import Results

    results = Results.read_table(args.input)
    removed = []
    for col in args.cols.split(","):
        col = col.strip()
        if col in results.colnames and col not in Results._required_col_names:
            results.table.remove_column(col)
            removed.append(col)
    results.write_table(args.outfile, overwrite=True)
    print(f"Removed {removed}; wrote {len(results)} rows to {args.outfile}")


if __name__ == "__main__":
    main()
