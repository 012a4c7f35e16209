"""IO of the port: table serialization (ecsv, and parquet/hdf5 where their
libraries are installed). The FITS reader and writer are not ported yet."""
