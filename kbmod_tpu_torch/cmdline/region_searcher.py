"""Survey-scale region search: divide the sky into patches and export a
per-patch ImageCollection for every patch the base collection touches
(reference: src/kbmod_cmdline/region_searcher.py). Host code.

Full reference flow: a sweep over (patch size x guess distance) pairs,
band and WCS-error pre-filtering, a patch grid with configurable overlap,
recycling of already-exported collections, an error CSV for failed
patches, and a per-patch analysis table (overlap area, visit count,
unique MJDs, nights spanned) sorted by overlap.

    python -m kbmod_tpu_torch.cmdline.region_searcher --ic-path survey.collection \\
        --guess-distances 40.0 --patch-side-len 20 --pixel-scale 0.26 \\
        --out-dir patches/
"""

import argparse
import csv
import os
import time


def elapsed_t(start_time, sigfigs=2):
    """'[X.XX s elapsed]' since start_time."""
    return f"[{round(time.time() - start_time, sigfigs)} s elapsed]"


def dist_patch_size_str(guess_dist, patch_size):
    """'GUESSDIST_PATCHSIZExPATCHSIZE' naming component."""
    return f"{guess_dist}_{patch_size}X{patch_size}"


def patch_id_to_ic_path(patch_id, guess_distance, patch_size, ic_dir):
    """The on-disk path for one patch's exported ImageCollection."""
    return os.path.join(
        ic_dir, f"{patch_id}_{dist_patch_size_str(guess_distance, patch_size)}.collection"
    )


def generate_or_load_patch_ic(patch_ids, guess_distance, patch_size, region_search,
                              ic_dir, overwrite=False):
    """Per-patch ImageCollections: recycled from disk when present (unless
    overwriting), generated and written otherwise; failures land in an
    errors.csv. Returns {patch_id: ImageCollection}."""
    from kbmod_tpu_torch.image_collection import ImageCollection

    patch_id_to_ic = {}
    to_generate = []
    if overwrite:
        to_generate = list(patch_ids)
    else:
        for patch_id in patch_ids:
            path = patch_id_to_ic_path(patch_id, guess_distance, patch_size, ic_dir)
            if os.path.exists(path):
                patch_id_to_ic[patch_id] = ImageCollection.read(path)
            else:
                to_generate.append(patch_id)
    print(
        f"Recycled {len(patch_id_to_ic)} ImageCollections from {ic_dir}. "
        "Continuing to generation phase (if needed)..."
    )

    files_written = 0
    errors = []
    for patch_id in to_generate:
        try:
            patch_ic = region_search.get_image_collection_from_patch(
                patch_id, guess_dist=guess_distance
            )
            patch_ic = region_search.export_image_collection(
                patch_ic, guess_dist=guess_distance, patch=patch_id, in_place=True
            )
            patch_id_to_ic[patch_id] = patch_ic
            patch_ic.write(
                patch_id_to_ic_path(patch_id, guess_distance, patch_size, ic_dir),
                overwrite=True,
            )
            files_written += 1
        except ValueError as msg:
            print(f"Error for patch_id {patch_id} : {msg}")
            errors.append((patch_id, str(msg)))

    print(
        f"Wrote {files_written} new ImageCollections to {ic_dir}. "
        f"{len(to_generate) - files_written} failed to generate."
    )
    with open(os.path.join(ic_dir, "errors.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["patch_id", "error_msg"])
        writer.writerows(errors)
    return patch_id_to_ic


def generate_analysis_table(patch_id_to_ic):
    """Per-patch overlap/coverage summary, sorted by overlap area."""
    import numpy as np

    from kbmod_tpu_torch.table import Table

    rows = {"patch_id": [], "overlap_deg2": [], "visit_count": [],
            "unique_mjds": [], "obs_nights_spanned": []}
    for patch_id, ic in patch_id_to_ic.items():
        rows["patch_id"].append(patch_id)
        rows["overlap_deg2"].append(
            float(np.sum(ic.data["overlap_deg"])) if "overlap_deg" in ic.data.colnames else 0.0
        )
        rows["visit_count"].append(
            len(set(ic["visit"])) if "visit" in ic.data.colnames else len(ic)
        )
        mjds = ic["mjd_mid"] if "mjd_mid" in ic.data.colnames else []
        rows["unique_mjds"].append(len({int(m) for m in np.atleast_1d(mjds)}))
        rows["obs_nights_spanned"].append(ic.obs_nights_spanned())
    t = Table({k: np.asarray(v) for k, v in rows.items()})
    order = np.argsort(-np.asarray(rows["overlap_deg2"]))
    return t[list(order)]


def region_searcher(ic_path, guess_distance, patch_size, patch_overlap_percentage,
                    pixel_scale, bands_to_drop, max_wcs_err, out_dir, overwrite,
                    site=None):
    """One (guess distance, patch size) region-search pass over a base
    ImageCollection (reference region_searcher.py:223-333)."""
    import numpy as np

    from kbmod_tpu_torch.image_collection import ImageCollection
    from kbmod_tpu_torch.region_search import RegionSearch

    start = time.time()
    print(f"{elapsed_t(start)} Reading base ImageCollection from {ic_path}...")
    ic = ImageCollection.read(ic_path)

    if bands_to_drop:
        print(f"Dropping bands from ImageCollection: {bands_to_drop}.")
        before = len(ic)
        ic.drop_bands(bands_to_drop)
        print(f"Dropped {before - len(ic)} rows due to band filtering.")
    if max_wcs_err is not None:
        if "wcs_err" in ic.data.colnames:
            print(f"Dropping rows with wcs_err > {max_wcs_err} arcsec.")
            before = len(ic)
            ic.filter_by_wcs_error(max_wcs_err, in_arcsec=True)
            print(f"Dropped {before - len(ic)} rows due to high WCS error.")
        else:
            print("No wcs_err column in the collection; skipping WCS-error filtering.")

    tag = dist_patch_size_str(guess_distance, patch_size)
    print(f"{elapsed_t(start)} Generating {tag} patches...")
    region_search = RegionSearch(ic, guess_dists=[guess_distance], earth_loc=site)
    region_search.generate_patches(
        arcminutes=patch_size,
        overlap_percentage=patch_overlap_percentage,
        pixel_scale=pixel_scale,
    )
    print(
        f"{elapsed_t(start)} Generated {len(region_search.get_patches())} {tag} "
        "patches. Searching ImageCollection..."
    )

    found = region_search.match_ic_to_patches(guess_dist=guess_distance)
    print(f"{elapsed_t(start)} Found {len(found)} patches. Running analysis...")

    ic_dir = os.path.join(out_dir, tag)
    os.makedirs(ic_dir, exist_ok=True)
    patch_id_to_ic = generate_or_load_patch_ic(
        list(found), guess_distance, patch_size, region_search, ic_dir, overwrite=overwrite
    )

    table_csvfile = os.path.join(ic_dir, f"overlap_{tag}.csv")
    if not overwrite and os.path.exists(table_csvfile):
        print(f"Analysis table {table_csvfile} exists and overwrite is False, not writing.")
    else:
        print(f"{elapsed_t(start)} Generating analysis table...")
        t = generate_analysis_table(patch_id_to_ic)
        with open(table_csvfile, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(t.colnames)
            for i in range(len(t)):
                writer.writerow([t[c][i] for c in t.colnames])
        print(f"{elapsed_t(start)} Saving {table_csvfile} to disk.")
    print(f"{elapsed_t(start)} Finished!")


def main():
    parser = argparse.ArgumentParser(description="Commandline Region Search tool")
    parser.add_argument("--ic-path", dest="ic_path", required=True,
                        help="Base ImageCollection to region-search.")
    parser.add_argument("--guess-distances", dest="guess_distances", type=float,
                        nargs="+", default=[0.0],
                        help="Reflex-correction guess distances (AU).")
    parser.add_argument("--patch-side-len", dest="patch_side_len", type=int,
                        nargs="+", default=[10], help="Patch side lengths (arcmin).")
    parser.add_argument("--pixel-scale", dest="pixel_scale", type=float, default=0.2,
                        help="Pixel scale (arcsec/px).")
    parser.add_argument("--patch-overlap-percentage", dest="patch_overlap_percentage",
                        type=float, default=0.0, help="Patch overlap fraction (0-1).")
    parser.add_argument("--bands-to-drop", dest="bands_to_drop", type=str, nargs="+",
                        default=["u", "y"], help="Bands to drop before searching.")
    parser.add_argument("--max-wcs-err", dest="max_wcs_err", type=float, default=0.2,
                        help="Drop rows with larger WCS error (arcsec).")
    parser.add_argument("--out-dir", dest="out_dir", default=os.getcwd(),
                        help="Output directory.")
    parser.add_argument("--overwrite", action="store_true", default=False)
    # Round-1 interface kept as aliases.
    parser.add_argument("--ic", dest="ic_path_alias", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--outdir", dest="out_dir_alias", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()

    ic_path = args.ic_path_alias or args.ic_path
    out_dir = args.out_dir_alias or args.out_dir
    for patch_side_len in args.patch_side_len:
        for guess_distance in args.guess_distances:
            region_searcher(
                ic_path=ic_path,
                guess_distance=guess_distance,
                patch_size=patch_side_len,
                patch_overlap_percentage=args.patch_overlap_percentage,
                pixel_scale=args.pixel_scale,
                bands_to_drop=args.bands_to_drop,
                max_wcs_err=args.max_wcs_err,
                out_dir=out_dir,
                overwrite=args.overwrite,
            )


if __name__ == "__main__":
    main()
