"""Command-line scripts of the port, run as ``python -m kbmod_tpu_torch.scripts.<name>``."""
