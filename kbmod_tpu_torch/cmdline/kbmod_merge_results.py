"""Merge multiple KBMOD results files with near-duplicate removal
(kbmod-merge-results; reference: src/kbmod_cmdline/kbmod_merge_results.py).

    python -m kbmod_tpu_torch.cmdline.kbmod_merge_results --outfile=merged.ecsv --dup_thresh=10 shard1.ecsv shard2.ecsv
"""

import argparse

import numpy as np


def merge_results_files(filenames, dup_thresh=10, max_dt=None):
    """Load and concatenate results files, dropping near duplicates via the
    trajectory cluster grid."""
    from kbmod_tpu_torch.filters.clustering_grid import grid_keep_indices
    from kbmod_tpu_torch.results import Results

    merged = None
    for filename in filenames:
        part = Results.read_table(filename)
        merged = part if merged is None else merged.extend(part)

    if merged is None or len(merged) == 0:
        return merged

    if dup_thresh and dup_thresh > 0:
        if max_dt is None:
            mjd = merged.mjd_mid
            max_dt = float(np.max(mjd) - np.min(mjd)) if mjd is not None else 1.0
        keep = grid_keep_indices(
            np.asarray(merged["x"]),
            np.asarray(merged["y"]),
            np.asarray(merged["vx"]),
            np.asarray(merged["vy"]),
            np.asarray(merged["likelihood"]),
            dup_thresh,
            max_dt,
        )
        merged.filter_rows(keep, "merge_dedup")
    merged.sort("likelihood", descending=True)
    return merged


def main(argv=None):
    parser = argparse.ArgumentParser(description="Merge KBMOD results files.")
    parser.add_argument("files", nargs="+", help="The results files to merge.")
    parser.add_argument("--outfile", required=True, help="Output merged results file.")
    parser.add_argument("--dup_thresh", type=int, default=10, help="Near-duplicate bin width (pixels).")
    parser.add_argument("--max_dt", type=float, default=None, help="Trajectory endpoint baseline (days).")
    args = parser.parse_args(argv)

    merged = merge_results_files(args.files, args.dup_thresh, args.max_dt)
    merged.write_table(args.outfile, overwrite=True)
    print(f"Wrote {len(merged)} merged results to {args.outfile}")


if __name__ == "__main__":
    main()
