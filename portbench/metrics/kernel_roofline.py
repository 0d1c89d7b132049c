"""kernel_roofline (``kernel_roofline.train``, ``kernel_roofline.serve``):
over every launch of the program's own kernels in the traced sub-window,
the sum of their least times (the larger of bytes at 3.35 TB/s and
operations at 67 TFLOP/s, from the kernel families' work counters on each
call's own arguments) over the sum of their device times, in %. Nothing
where no family ran or a family's calls and launches do not pair up."""

from portbench.trace import family_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    sums = family_seconds(ctx.trace, ctx.families)
    return None if sums is None else 100.0 * sums[0] / sums[1]
