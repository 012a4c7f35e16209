"""Migrate legacy KBMOD results files to the current on-disk layout
(kbmod-migrate-results; reference: src/kbmod_cmdline/kbmod_migrate_results.py:73-429).

Capabilities (mirroring the reference tool):
- single file or directory batch (``--glob`` pattern, default
  ``**/*.search.parquet``), optional worker pool
- reshapes flattened image columns back to 2D (``--stamp-dim``) with
  glob-style ``--image-columns`` selection
- splits image columns into auxiliary side files and stamps
  ``image_column_shapes`` metadata on the main file
- validates each migration (row/column counts + shape metadata) before
  atomically replacing the original; failures leave the original intact
- CSV audit logs (mapping + errors), ``--dry-run`` preview, chunked
  reading for very large files, legacy whitespace trajectory dumps

Host work only. The workers are forked, and a forked child of a process
that has initialised CUDA cannot use it, so nothing here touches CUDA.

    python -m kbmod_tpu_torch.cmdline.kbmod_migrate_results --input=results_dir --image-columns '*coadd*' \\
        --stamp-dim 21 --workers 4
"""

import argparse
import csv
import fnmatch
import logging
import os
import shutil
import tempfile
from collections import namedtuple
from datetime import datetime, timezone
from multiprocessing import Pool
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

MigrationResult = namedtuple(
    "MigrationResult",
    ["success", "original_path", "final_path", "aux_files", "rows", "skipped", "skip_reason", "error_msg"],
)

_TABLE_SUFFIXES = (".parquet", ".parq", ".ecsv", ".hdf5")


def find_result_files(input_path, glob_pattern="**/*.search.parquet"):
    """All result files to migrate: the single file itself, or every match
    of the glob under a directory (both .parquet and .parq spellings)."""
    input_path = Path(input_path)
    if input_path.is_file():
        if input_path.name.lower().endswith(_TABLE_SUFFIXES + (".txt", ".dat")):
            return [input_path]
        raise ValueError(f"Unsupported results file: {input_path}")
    if input_path.is_dir():
        files = list(input_path.glob(glob_pattern))
        if ".parquet" in glob_pattern:
            files.extend(input_path.glob(glob_pattern.replace(".parquet", ".parq")))
        elif ".parq" in glob_pattern:
            files.extend(input_path.glob(glob_pattern.replace(".parq", ".parquet")))
        return sorted(set(files))
    raise FileNotFoundError(f"Input path not found: {input_path}")


def match_column_patterns(colnames, patterns):
    """Column names matching any glob-style pattern (e.g. '*coadd*')."""
    matched = []
    for col in colnames:
        if any(fnmatch.fnmatch(col, p) for p in patterns):
            matched.append(col)
    return matched


def find_auxiliary_files(base_path):
    """Existing {stem}_{col}.{fits,parquet,parq,npy,ecsv} side files."""
    base_path = Path(base_path)
    out = []
    for ext in (".fits", ".parquet", ".parq", ".npy", ".ecsv"):
        for aux in base_path.parent.glob(f"{base_path.stem}_*{ext}"):
            out.append((aux.stem[len(base_path.stem) + 1 :], aux))
    return out


def has_auxiliary_files(base_path):
    return len(find_auxiliary_files(base_path)) > 0


def count_rows_and_columns(filepath):
    """(num_rows, num_cols, colnames) without loading the pixel data when
    the format allows (parquet metadata read)."""
    filepath = Path(filepath)
    if filepath.suffix in (".parquet", ".parq"):
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(filepath)
        names = [n for n in pf.schema_arrow.names if not n.startswith("__")]
        return pf.metadata.num_rows, len(names), names
    from kbmod_tpu_torch.results import Results

    res = Results.read_table(str(filepath))
    return len(res), len(res.colnames), list(res.colnames)


def reshape_image_columns_inplace(results, matched_columns, stamp_dim):
    """Flattened 1D stamp columns -> (stamp_dim, stamp_dim) in place."""
    expected = stamp_dim * stamp_dim
    for col in matched_columns:
        if col not in results.colnames:
            raise ValueError(f"Column {col} not found in results")
        data = np.asarray(results.table[col])
        if data.ndim == 3 and data.shape[1:] == (stamp_dim, stamp_dim):
            continue  # already migrated
        if data.ndim == 2 and data.shape[1] == expected:
            results.table[col] = data.reshape(len(results), stamp_dim, stamp_dim)
            continue
        reshaped = []
        for entry in results.table[col]:
            entry = np.asarray(entry)
            if entry.size != expected:
                raise ValueError(f"Column {col}: entry size {entry.size} != expected {expected}")
            reshaped.append(entry.reshape(stamp_dim, stamp_dim))
        results.table[col] = np.stack(reshaped)


def load_and_reshape_results(file_path, matched_columns, stamp_dim, chunk_size=None):
    """Load (optionally in chunks) and reshape; returns (Results, nrows)."""
    from kbmod_tpu_torch.results import Results

    file_path = str(file_path)
    if file_path.endswith((".txt", ".dat")):
        results = Results.from_trajectory_file(file_path)
        return results, len(results)
    if chunk_size is not None:
        accumulated = None
        num_rows = 0
        for chunk in Results.read_table_chunks(file_path, chunk_size=chunk_size):
            reshape_image_columns_inplace(chunk, matched_columns, stamp_dim)
            num_rows += len(chunk)
            if accumulated is None:
                accumulated = chunk
            else:
                accumulated.extend(chunk)
        if accumulated is None:
            accumulated = Results.from_trajectories([])
        return accumulated, num_rows
    results = Results.read_table(file_path)
    reshape_image_columns_inplace(results, matched_columns, stamp_dim)
    return results, len(results)


def validate_migration(original_path, new_path, expected_aux_files, expected_image_shapes):
    """Post-write validation: new file + aux files exist, row counts
    match, column count dropped by exactly the split columns, and the
    image_column_shapes metadata records the expected shapes.
    Returns (ok, error_message)."""
    try:
        new_path = Path(new_path)
        if not new_path.exists():
            return False, f"New file does not exist: {new_path}"
        for aux in expected_aux_files:
            if not Path(aux).exists():
                return False, f"Auxiliary file does not exist: {aux}"
        if len(expected_aux_files) != len(expected_image_shapes):
            return False, (
                f"Aux/shape bookkeeping mismatch: {len(expected_aux_files)} files "
                f"vs {len(expected_image_shapes)} shapes"
            )
        orig_rows, orig_cols, _ = count_rows_and_columns(original_path)
        new_rows, new_cols, _ = count_rows_and_columns(new_path)
        if orig_rows != new_rows:
            return False, f"Row count mismatch: original={orig_rows}, new={new_rows}"
        expected_cols = orig_cols - len(expected_aux_files)
        if new_cols != expected_cols:
            return False, (
                f"Column count mismatch: expected {expected_cols} "
                f"(orig={orig_cols} - aux={len(expected_aux_files)}), got {new_cols}"
            )
        if expected_image_shapes:
            from kbmod_tpu_torch.results import Results

            meta = Results.read_table(str(new_path)).table.meta
            stored = meta.get("image_column_shapes", {}) or {}
            for col, shape in expected_image_shapes.items():
                if col not in stored:
                    return False, f"Missing image_column_shapes metadata for column '{col}'"
                if tuple(stored[col]) != tuple(shape):
                    return False, (
                        f"Shape mismatch for column '{col}': expected {tuple(shape)}, "
                        f"got {tuple(stored[col])}"
                    )
        return True, ""
    except Exception as e:  # noqa: BLE001 — report, don't crash the batch
        return False, f"Validation error: {e}"


def move_files_to_original_location(temp_base, temp_aux_files, original_path):
    """Replace the original with the validated temp outputs (atomic on
    the same filesystem). Returns the final paths, base first."""
    original_path = Path(original_path)
    final_paths = [original_path]
    shutil.move(str(temp_base), str(original_path))
    for aux in temp_aux_files:
        dest = original_path.parent / Path(aux).name
        shutil.move(str(aux), str(dest))
        final_paths.append(dest)
    return final_paths


def process_single_file(args_tuple):
    """Migrate one file (Pool-friendly); returns a MigrationResult."""
    (file_path, image_patterns, stamp_dim, output_dir, dry_run,
     skip_with_aux, keep_originals, chunk_size) = args_tuple
    file_path = Path(file_path)
    try:
        if skip_with_aux and has_auxiliary_files(file_path):
            return MigrationResult(True, file_path, file_path, [], 0, True, "has_auxiliary_files", "")

        _, _, colnames = count_rows_and_columns(file_path)
        matched = match_column_patterns(colnames, image_patterns)
        if not matched:
            return MigrationResult(True, file_path, file_path, [], 0, True, "no_matching_columns", "")

        logger.info(f"Processing {file_path} with image columns: {matched}")
        results, num_rows = load_and_reshape_results(file_path, matched, stamp_dim, chunk_size)

        if dry_run:
            return MigrationResult(True, file_path, file_path, matched, num_rows, False, "", "")

        from kbmod_tpu_torch.results import write_results_to_files_destructive

        temp_dir = Path(output_dir)
        suffix = file_path.suffix if file_path.suffix in _TABLE_SUFFIXES else ".parquet"
        temp_base = temp_dir / (file_path.stem + suffix)
        # write_results_to_files_destructive matches regexes; escape the
        # exact column names.
        import re

        write_results_to_files_destructive(
            temp_base, results,
            separate_col_files=[re.escape(c) for c in matched],
            overwrite=True,
        )
        temp_aux = [
            temp_dir / f"{temp_base.stem}_{col}{suffix}"
            for col in matched
            if (temp_dir / f"{temp_base.stem}_{col}{suffix}").exists()
        ]
        expected_shapes = {col: (stamp_dim, stamp_dim) for col in matched}
        ok, err = validate_migration(file_path, temp_base, temp_aux, expected_shapes)
        if not ok:
            for p in [temp_base, *temp_aux]:
                if Path(p).exists():
                    os.remove(p)
            return MigrationResult(False, file_path, None, [], num_rows, False, "", f"Validation failed: {err}")

        if keep_originals:
            final_path, final_aux = temp_base, [p.name for p in temp_aux]
        else:
            final_paths = move_files_to_original_location(temp_base, temp_aux, file_path)
            final_path, final_aux = final_paths[0], [p.name for p in final_paths[1:]]
        return MigrationResult(True, file_path, final_path, final_aux, num_rows, False, "", "")
    except Exception as e:  # noqa: BLE001
        logger.exception(f"Error processing {file_path}")
        return MigrationResult(False, file_path, None, [], 0, False, "", str(e))


def _write_csv_header(filepath, headers):
    with open(filepath, "w", newline="") as f:
        csv.writer(f).writerow(headers)


def _append_csv_row(filepath, row):
    with open(filepath, "a", newline="") as f:
        csv.writer(f).writerow(row)


def _record_result(result, mapping_file, error_file):
    ts = datetime.now(timezone.utc).isoformat()
    if result.success:
        status = f"skipped_{result.skip_reason}" if result.skipped else "migrated"
        _append_csv_row(
            mapping_file,
            [ts, str(result.original_path), str(result.final_path or ""),
             ";".join(map(str, result.aux_files)), result.rows, status],
        )
    else:
        _append_csv_row(error_file, [ts, str(result.original_path), "migration_error", result.error_msg])


def _print_summary(results, mapping_file, error_file, dry_run):
    migrated = [r for r in results if r.success and not r.skipped]
    skipped = [r for r in results if r.skipped]
    failed = [r for r in results if not r.success]
    verb = "Would migrate" if dry_run else "Migrated"
    print(f"\n{verb} {len(migrated)} file(s); skipped {len(skipped)}; failed {len(failed)}.")
    for r in failed:
        print(f"  FAILED {r.original_path}: {r.error_msg}")
    print(f"Audit logs: {mapping_file} / {error_file}")


def execute(args):
    if args.verbose:
        print("KBMOD Results Migration:")
        for key, val in vars(args).items():
            print(f"  {key}: {val}")
        logging.basicConfig(level=logging.DEBUG)
    else:
        logging.basicConfig(level=logging.INFO)

    input_files = find_result_files(args.input, args.glob)
    if not input_files:
        print("No result files found matching criteria.")
        return

    output_dir = Path(args.output_dir) if args.output_dir else Path(tempfile.mkdtemp(prefix="kbmod_migrate_"))
    output_dir.mkdir(parents=True, exist_ok=True)

    mapping_file = Path(args.mapping_file) if args.mapping_file else output_dir / "migration_mapping.csv"
    error_file = Path(args.error_file) if args.error_file else output_dir / "migration_errors.csv"
    _write_csv_header(mapping_file, ["timestamp", "original_path", "final_path", "aux_files", "rows", "status"])
    _write_csv_header(error_file, ["timestamp", "original_path", "error_type", "error_message"])

    process_args = [
        (f, args.image_columns, args.stamp_dim, str(output_dir), args.dry_run,
         not args.no_skip_with_aux, args.keep_originals, args.chunk_size)
        for f in input_files
    ]

    results = []
    if args.workers > 1:
        with Pool(args.workers) as pool:
            for result in pool.imap_unordered(process_single_file, process_args):
                results.append(result)
                _record_result(result, mapping_file, error_file)
    else:
        for pa in process_args:
            result = process_single_file(pa)
            results.append(result)
            _record_result(result, mapping_file, error_file)

    _print_summary(results, mapping_file, error_file, args.dry_run)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Migrate legacy KBMOD results files (reshape image columns, "
        "split auxiliary files, validate, and atomically replace)."
    )
    parser.add_argument("--input", required=True, help="Results file or directory to migrate.")
    parser.add_argument(
        "--image-columns", nargs="+", default=["*coadd*", "stamps", "all_stamps"],
        help="Glob patterns of image columns to reshape/split.",
    )
    parser.add_argument("--stamp-dim", type=int, default=21, help="Stamp side length in pixels.")
    parser.add_argument("--glob", default="**/*.search.parquet", help="Directory search pattern.")
    parser.add_argument("--output-dir", default=None, help="Staging directory (default: temp dir).")
    parser.add_argument("--mapping-file", default=None, help="Audit CSV of migrations.")
    parser.add_argument("--error-file", default=None, help="Audit CSV of failures.")
    parser.add_argument("--workers", type=int, default=1, help="Parallel worker processes.")
    parser.add_argument("--chunk-size", type=int, default=None, help="Rows per read chunk.")
    parser.add_argument("--dry-run", action="store_true", help="Preview without writing.")
    parser.add_argument("--keep-originals", action="store_true", help="Leave originals in place.")
    parser.add_argument(
        "--no-skip-with-aux", action="store_true",
        help="Process files even when auxiliary side files already exist.",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    # Back-compat with the round-1 converter interface.
    parser.add_argument("--outfile", default=None, help="(legacy) convert --input to this file.")
    args = parser.parse_args(argv)

    if args.outfile:
        from kbmod_tpu_torch.results import Results

        if args.input.endswith((".txt", ".dat")):
            results = Results.from_trajectory_file(args.input)
        else:
            results = Results.read_table(args.input)
        results.write_table(args.outfile, overwrite=True)
        print(f"Migrated {len(results)} results {args.input} -> {args.outfile}")
        return

    execute(args)


if __name__ == "__main__":
    main()
