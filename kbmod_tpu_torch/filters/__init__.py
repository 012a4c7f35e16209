"""Post-search filtering of the port: sigma-G clipping, clustering and
deduplication, coadd stamps and the SNS stamp filters. CNN vetting,
brightness and known-object filters are not ported yet."""
