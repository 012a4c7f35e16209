"""device_peak_gib: the device allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset after set-up), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
