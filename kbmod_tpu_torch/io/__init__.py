"""IO of the port: table serialization (ecsv, and parquet/hdf5 where their
libraries are installed) and the self-contained FITS reader and writer
(``fits_io``, with BINTABLE and tiled-image compression), copies of the JAX
package's modules that write byte-equal files."""
