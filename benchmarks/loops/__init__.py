"""Window loops, one module a kind of work; a traffic file names its loop,
whose module defines ``Cell``."""
