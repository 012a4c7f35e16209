"""upload_s: the build's host staging per stack, from the program's spans:
``build.stage`` (the host's stack of the sci/var images and their float32
cast) plus ``build.upload`` (their copy to the card), summed over the
build's passes (two in the uint8 build), mean over the window's stacks."""

from benchmarks.program_spans import mean_per_stack, seconds


def read(ctx):
    return mean_per_stack(ctx, lambda rs: seconds(rs, "build.stage", "build.upload"))
