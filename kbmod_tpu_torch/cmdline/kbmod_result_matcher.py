"""Match KBMOD results files against a known-object ephemeris catalog
(kbmod-result-matcher; reference: src/kbmod_cmdline/kbmod_result_matcher.py).

Full reference flow: single file or glob batch, ephemeris loading from
.csv/.ecsv/.parquet, optional reflex correction of the catalog to an
assumed barycentric distance (cached to the output directory), per-file
matching through KnownObjsMatcher, a CSV manifest of (results_file,
parameters, uuid, matched name, matched_obs, obs_ratio) rows, and an
exceptions CSV for files that failed.

    python -m kbmod_tpu_torch.cmdline.kbmod_result_matcher --results_glob 'patches/*.results.parquet' \\
        --ephem known.ecsv --barycentric_dist 39.0 --output ./matches

The round-1 single-file interface (--input/--workunit/--outfile) is kept
for annotating one results table in place.
"""

import argparse
import csv
import glob
import os

import numpy as np


def reflex_correct_ephem_table(ephem_table, barycentric_dist, point_on_earth=None):
    """Add ra_<dist>/dec_<dist> columns: the catalog positions corrected
    to the assumed barycentric distance (identity for 0.0)."""
    if barycentric_dist != 0.0:
        from kbmod_tpu_torch.reprojection_utils import correct_parallax_geometrically_vectorized
        from kbmod_tpu_torch.work_unit import RUBIN_LOCATION_M

        site = RUBIN_LOCATION_M if point_on_earth is None else point_on_earth
        corrected, _ = correct_parallax_geometrically_vectorized(
            np.asarray(ephem_table["RA"], dtype=float),
            np.asarray(ephem_table["Dec"], dtype=float),
            np.asarray(ephem_table["mjd_mid"], dtype=float),
            barycentric_dist,
            site,
        )
        ephem_table[f"ra_{barycentric_dist}"] = corrected.ra_deg
        ephem_table[f"dec_{barycentric_dist}"] = corrected.dec_deg
    else:
        ephem_table[f"ra_{barycentric_dist}"] = np.asarray(ephem_table["RA"], dtype=float)
        ephem_table[f"dec_{barycentric_dist}"] = np.asarray(ephem_table["Dec"], dtype=float)
    return ephem_table


def get_ic_from_results_file(res_filepath):
    """The ImageCollection path for a workflow results file: strip every
    extension after '.collection' (the workflow appends step suffixes)."""
    idx = res_filepath.find(".collection")
    if idx == -1:
        raise ValueError(f"Could not find .collection in {res_filepath} path")
    ic_path = res_filepath[: idx + len(".collection")]
    if not os.path.exists(ic_path):
        raise ValueError(f"ImageCollection file not found: {ic_path} for results file {res_filepath}")
    return ic_path


def _load_ephem_table(path):
    from kbmod_tpu_torch.io import table_io
    from kbmod_tpu_torch.table import Table

    if path.endswith((".ecsv", ".parquet", ".parq")):
        return table_io.read_table(path)
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        cols = {}
        for i, name in enumerate(header):
            vals = [r[i] for r in body]
            try:
                cols[name] = np.asarray(vals, dtype=float)
            except ValueError:
                cols[name] = np.array(vals, dtype=object)
        return Table(cols)
    raise ValueError(f"Unsupported ephemeris file format: {path}. Use .csv, .ecsv or .parquet")


def process_results_file(
    results_file, ephem_table, barycentric_dist, sep_thresh, time_thresh_s,
    min_obs, verbose=False, max_results=None,
):
    """Match one results file; returns manifest rows (list of dicts)."""
    from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher
    from kbmod_tpu_torch.results import Results

    res = Results.read_table(results_file)
    if verbose:
        print(f"Processing {len(res)} results from file: {results_file}")
    if max_results is not None:
        if max_results <= 0:
            raise ValueError("max_results must be a positive integer.")
        if max_results < len(res):
            if verbose:
                print(f"Limiting processing to the first {max_results} results.")
            res.table = res.table[:max_results]

    if res.mjd_mid is None:
        raise ValueError(f"Results file {results_file} carries no mjd_mid times.")
    if "obs_valid" not in res.colnames and len(res) > 0:
        res.table["obs_valid"] = np.ones((len(res), len(res.mjd_mid)), dtype=bool)

    matcher = KnownObjsMatcher(
        ephem_table,
        np.asarray(res.mjd_mid, dtype=float),
        matcher_name="known_matcher",
        sep_thresh=sep_thresh,
        time_thresh_s=time_thresh_s,
        name_col="Name",
        ra_col=f"ra_{barycentric_dist}",
        dec_col=f"dec_{barycentric_dist}",
        mjd_col="mjd_mid",
    )

    wcs = res.wcs
    if wcs is None:
        from kbmod_tpu_torch.image_collection import ImageCollection
        from kbmod_tpu_torch.wcs_utils import deserialize_wcs

        ic = ImageCollection.read(get_ic_from_results_file(results_file))
        wcs = deserialize_wcs(ic[0]["global_wcs"])

    matcher.match(res, wcs)
    matcher.match_on_min_obs(res, min_obs)

    rows = []
    for row_idx in range(len(res)):
        matches = res.table["known_matcher"][row_idx]
        if not matches:
            continue
        uuid = res.table["uuid"][row_idx] if "uuid" in res.colnames else str(row_idx)
        for name, obs_mask in matches.items():
            num = int(np.sum(obs_mask))
            rows.append({
                "results_file": results_file,
                "barycentric_dist": barycentric_dist,
                "sep_thresh": sep_thresh,
                "time_thresh_s": time_thresh_s,
                "min_obs": min_obs,
                "uuid": uuid,
                "name": name,
                "matched_obs": num,
                "obs_ratio": num / len(obs_mask) if len(obs_mask) else 0.0,
            })
    if verbose:
        print(f"Found {len(rows)} matches in {results_file}.")
    return rows


_MANIFEST_FIELDS = [
    "results_file", "barycentric_dist", "sep_thresh", "time_thresh_s",
    "min_obs", "uuid", "name", "matched_obs", "obs_ratio",
]


def execute(args):
    if not os.path.exists(args.ephem):
        raise FileNotFoundError(f"Ephemeris file not found: {args.ephem}")
    if (args.results is None) == (args.results_glob is None):
        raise ValueError("You must provide exactly one of --results or --results_glob.")
    if args.results is not None:
        results_files = [args.results]
    else:
        results_files = sorted(glob.glob(args.results_glob))
        if not results_files:
            raise ValueError(f"No files found matching glob pattern: {args.results_glob}")
    if args.max_files is not None:
        results_files = results_files[: args.max_files]

    os.makedirs(args.output, exist_ok=True)

    ephem_table = _load_ephem_table(args.ephem)
    ra_col, dec_col = f"ra_{args.barycentric_dist}", f"dec_{args.barycentric_dist}"
    if ra_col in ephem_table.colnames and dec_col in ephem_table.colnames:
        print(f"Using existing columns '{ra_col}' and '{dec_col}' for matching.")
    else:
        ephem_table = reflex_correct_ephem_table(ephem_table, args.barycentric_dist)
        from kbmod_tpu_torch.io import table_io

        ephem_file = os.path.join(args.output, f"ephem_{args.barycentric_dist}.parquet")
        if not os.path.exists(ephem_file) or args.overwrite:
            table_io.write_table(ephem_table, ephem_file)
            if args.verbose:
                print(f"Saved reflex-corrected ephemeris table to: {ephem_file}")

    matched_file = os.path.join(args.output, "matching_results.csv")
    exceptions_file = os.path.join(args.output, "exceptions.csv")
    for path in (matched_file, exceptions_file):
        if os.path.exists(path):
            if not args.overwrite:
                raise ValueError(f"Output file already exists: {path}. Use --overwrite.")
            os.remove(path)

    exceptions = []
    n_matches = 0
    first_write = True
    for i, rf in enumerate(results_files):
        if args.verbose:
            print(f"Processing results file {i + 1}/{len(results_files)}: {rf}")
        try:
            rows = process_results_file(
                rf, ephem_table, args.barycentric_dist, args.sep_thresh,
                args.time_thresh_s, args.min_obs, verbose=args.verbose,
                max_results=args.max_results,
            )
            mode = "w" if first_write else "a"
            with open(matched_file, mode, newline="") as f:
                writer = csv.DictWriter(f, fieldnames=_MANIFEST_FIELDS)
                if first_write:
                    writer.writeheader()
                writer.writerows(rows)
            first_write = False
            n_matches += len(rows)
        except Exception as e:  # noqa: BLE001 — batch keeps going
            print(f"Exception occurred: {e}")
            exceptions.append({"result_file": rf, "error": str(e)})

    if exceptions:
        with open(exceptions_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["result_file", "error"])
            writer.writeheader()
            writer.writerows(exceptions)
        print(f"Some files could not be processed. See exceptions file: {exceptions_file}")
    print(f"Wrote {n_matches} match rows for {len(results_files)} file(s) to {matched_file}")


def _execute_single(args):
    """Round-1 single-file interface: annotate one results table."""
    from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher
    from kbmod_tpu_torch.io import table_io
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.work_unit import WorkUnit

    results = Results.read_table(args.input)
    catalog = table_io.read_table(args.catalog)
    work = WorkUnit.from_fits(args.workunit)

    if "obs_valid" not in results.colnames and len(results) > 0:
        n_times = work.im_stack.num_times
        results.table["obs_valid"] = np.ones((len(results), n_times), dtype=bool)

    matcher = KnownObjsMatcher(
        catalog,
        np.asarray(work.get_all_obstimes()),
        args.matcher_name,
        sep_thresh=args.sep_thresh,
        time_thresh_s=args.time_thresh_s,
        mjd_col=args.mjd_col,
        ra_col=args.ra_col,
        dec_col=args.dec_col,
        name_col=args.name_col,
    )
    matcher.match(results, work.get_wcs(0))
    matcher.match_on_min_obs(results, args.min_obs)
    if args.remove_matches:
        matcher.filter_matches(results, matcher.match_min_obs_col(args.min_obs))

    results.write_table(args.outfile, overwrite=True)
    print(f"Wrote {len(results)} results to {args.outfile}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="kbmod-result-matcher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Match KBMOD results files against a known-object ephemeris catalog.",
    )
    parser.add_argument("--results", default=None, help="One results file to process.")
    parser.add_argument("--results_glob", default=None, help="Glob of results files (batch mode).")
    parser.add_argument("--ephem", default=None, help="Known-object ephemeris (.csv/.ecsv/.parquet).")
    parser.add_argument("--output", default="./output", help="Directory for output files.")
    parser.add_argument("--overwrite", action="store_true", help="Overwrite existing outputs.")
    parser.add_argument(
        "--barycentric_dist", type=float, default=0.0,
        help="Assumed barycentric distance (AU) for reflex correction; 0 disables.",
    )
    parser.add_argument("--sep_thresh", type=float, default=5.0, help="Arcsec match threshold.")
    parser.add_argument("--time_thresh_s", type=float, default=30.0, help="Seconds match threshold.")
    parser.add_argument("--min_obs", type=int, default=1, help="Minimum matched observations.")
    parser.add_argument("--max_files", type=int, default=None, help="Cap on files processed.")
    parser.add_argument("--max_results", type=int, default=None, help="Cap on rows per file.")
    parser.add_argument("-v", "--verbose", action="store_true")
    # Single-file annotate mode (round-1 interface).
    parser.add_argument("--input", default=None, help="(annotate mode) input results file.")
    parser.add_argument("--catalog", default=None, help="(annotate mode) known-object catalog.")
    parser.add_argument("--workunit", default=None, help="(annotate mode) WorkUnit FITS.")
    parser.add_argument("--outfile", default=None, help="(annotate mode) output results file.")
    parser.add_argument("--matcher_name", default="known_objs")
    parser.add_argument("--mjd_col", default="mjd_mid")
    parser.add_argument("--ra_col", default="RA")
    parser.add_argument("--dec_col", default="DEC")
    parser.add_argument("--name_col", default="Name")
    parser.add_argument("--remove_matches", action="store_true")
    args = parser.parse_args(argv)

    if args.input is not None:
        for req in ("catalog", "workunit", "outfile"):
            if getattr(args, req) is None:
                raise ValueError(f"Annotate mode requires --{req}.")
        _execute_single(args)
        return
    if args.ephem is None:
        raise ValueError("You must provide the path to the ephemeris file using --ephem.")
    execute(args)


if __name__ == "__main__":
    main()
