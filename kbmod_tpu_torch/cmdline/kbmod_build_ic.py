"""Build an ImageCollection from FITS files or a Butler repo
(reference: src/kbmod_cmdline/kbmod_build_ic.py). Host code: the
standardizers read the files, nothing runs on a card.

    python -m kbmod_tpu_torch.cmdline.kbmod_build_ic --dir=/data/images --outfile=survey.ecsv
"""

import argparse


def main():
    parser = argparse.ArgumentParser(description="Build an ImageCollection metadata catalog.")
    parser.add_argument("--dir", default=None, help="Directory of FITS files to ingest.")
    parser.add_argument("--files", nargs="*", default=None, help="Explicit target files.")
    parser.add_argument("--outfile", required=True, help="Output .ecsv collection file.")
    parser.add_argument("--force", default=None, help="Force a specific standardizer by name.")
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--butler_repo", default=None, help="Butler repository root (requires lsst stack).")
    parser.add_argument("--collections", nargs="*", default=None, help="Butler collections to query.")
    parser.add_argument("--dataset_type", default="differenceExp", help="Butler dataset type.")
    args = parser.parse_args()

    from kbmod_tpu_torch.image_collection import ImageCollection

    if args.butler_repo is not None:
        import lsst.daf.butler as dafButler

        from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer

        butler = dafButler.Butler(args.butler_repo, collections=args.collections)
        refs = list(butler.registry.queryDatasets(args.dataset_type, collections=args.collections))
        stds = [ButlerStandardizer(ref, butler=butler) for ref in refs]
        ic = ImageCollection.fromStandardizers(stds)
    elif args.dir is not None:
        ic = ImageCollection.fromDir(args.dir, recursive=args.recursive, force=args.force)
    elif args.files:
        ic = ImageCollection.fromTargets(args.files, force=args.force)
    else:
        raise ValueError("Provide --dir, --files, or --butler_repo.")

    ic.write(args.outfile)
    print(f"Wrote collection of {len(ic)} images to {args.outfile}")


if __name__ == "__main__":
    main()
