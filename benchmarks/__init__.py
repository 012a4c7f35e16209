"""The benchmark of kbmod_tpu_torch: whole-stack search throughput on the
card, cells and metrics found by name (see README.md)."""
