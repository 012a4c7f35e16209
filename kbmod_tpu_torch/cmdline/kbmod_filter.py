"""Post-hoc filtering of a KBMOD results file (kbmod-filter).

Applies any combination of sigma-G clipping, minimum-observation,
minimum-likelihood, and clustering filters to a saved results table
(reference: src/kbmod_cmdline/kbmod_filter.py).

The sigma-G clipping, and the psi/phi curves it rebuilds from a WorkUnit
(kernel K1, then the curve gathers), run on CUDA unless ``--device cpu``
is given; without a card they raise. The other filters are host work.

    python -m kbmod_tpu_torch.cmdline.kbmod_filter --input=results.ecsv --outfile=filtered.ecsv --sigma_g_bnds=25,75 \
        --num_obs=10 --lh_level=10.0 --cluster_type=all --cluster_eps=20
"""

import argparse
import logging

import numpy as np

logger = logging.getLogger(__name__)


def sigma_g_filter_results(results, bnds, clip_negative=False, workunit=None, device=None):
    """Apply sigma-G clipping, regenerating psi/phi curves from the
    WorkUnit when the results lack them, on ``device`` (CUDA unless
    ``"cpu"``)."""
    from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
    from kbmod_tpu_torch.search import StackSearch

    if len(bnds) != 2 or bnds[0] >= bnds[1] or bnds[0] < 0.0 or bnds[1] > 100.0:
        raise ValueError(f"Invalid sigma-g limits: {bnds}")

    if "psi_curve" not in results.colnames or "phi_curve" not in results.colnames:
        if workunit is None:
            raise ValueError("Missing psi-phi data (and no WorkUnit to regenerate from).")
        stack = workunit.im_stack
        search = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device=device)
        curves = search.get_all_psi_phi_curves(results.make_trajectory_list())
        T = stack.num_times
        results.add_psi_phi_data(curves[:, :T], curves[:, T:])

    clipper = SigmaGClipping(bnds[0], bnds[1], 2, clip_negative, device=device)
    apply_clipped_sigma_g(clipper, results)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Filter a KBMOD results file.")
    parser.add_argument("--input", required=True, help="Input results file.")
    parser.add_argument("--outfile", required=True, help="Output results file.")
    parser.add_argument("--workunit", default=None, help="Optional WorkUnit FITS for curve regeneration.")
    parser.add_argument("--sigma_g_bnds", default=None, help="Comma-separated sigma-G percentiles, e.g. 25,75.")
    parser.add_argument("--clip_negative", action="store_true")
    parser.add_argument("--num_obs", type=int, default=None, help="Minimum valid observations.")
    parser.add_argument("--lh_level", type=float, default=None, help="Minimum likelihood.")
    parser.add_argument("--cluster_type", default=None)
    parser.add_argument("--cluster_eps", type=float, default=None)
    parser.add_argument("--cluster_v_scale", type=float, default=1.0)
    parser.add_argument("--device", default=None, help="Where sigma-G runs: cuda (the default) or cpu.")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)

    from kbmod_tpu_torch.results import Results

    results = Results.read_table(args.input)
    logger.info(f"Loaded {len(results)} results from {args.input}")

    workunit = None
    if args.workunit is not None:
        from kbmod_tpu_torch.work_unit import WorkUnit

        workunit = WorkUnit.from_fits(args.workunit)

    if args.sigma_g_bnds is not None:
        bnds = [float(v) for v in args.sigma_g_bnds.split(",")]
        sigma_g_filter_results(results, bnds, args.clip_negative, workunit, device=args.device)

    if args.num_obs is not None:
        results.filter_rows(np.asarray(results["obs_count"]) >= args.num_obs, "num_obs")
    if args.lh_level is not None:
        results.filter_rows(np.asarray(results["likelihood"]) >= args.lh_level, "lh_level")

    if args.cluster_type is not None:
        if args.cluster_eps is None:
            raise ValueError("cluster_eps required with cluster_type.")
        if workunit is not None:
            times = np.asarray(workunit.get_all_obstimes())
        elif results.mjd_mid is not None:
            times = np.asarray(results.mjd_mid)
        else:
            raise ValueError("Clustering requires times (WorkUnit or results metadata).")
        from kbmod_tpu_torch.filters.clustering_filters import apply_clustering

        apply_clustering(
            results,
            {
                "cluster_type": args.cluster_type,
                "cluster_eps": args.cluster_eps,
                "cluster_v_scale": args.cluster_v_scale,
                "times": times,
            },
        )

    results.write_table(args.outfile, overwrite=True)
    print(f"Wrote {len(results)} filtered results to {args.outfile}")


if __name__ == "__main__":
    main()
