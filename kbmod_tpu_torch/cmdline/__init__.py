"""Command-line tools of the port, run as ``python -m
kbmod_tpu_torch.cmdline.<tool>`` (reference: src/kbmod_cmdline/)."""
