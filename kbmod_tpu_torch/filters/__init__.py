"""Post-search filtering of the port: sigma-G clipping, clustering and
deduplication, coadd stamps, the SNS stamp filters, CNN vetting, and the
brightness and known-object filters."""
