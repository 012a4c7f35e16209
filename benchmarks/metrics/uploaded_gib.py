"""uploaded_gib: the bytes the build copies from the host to the card per
stack, in GiB, from the program's counter ``bytes.h2d`` (the sci and var
images of every pass: two in the uint8 build). Mean over the window's
stacks."""

from benchmarks.program_spans import counted, mean_per_stack


def read(ctx):
    return mean_per_stack(ctx, lambda rs: counted(rs, "bytes.h2d") / 2**30)
