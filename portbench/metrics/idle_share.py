"""idle_share (``idle_share.train``, ``idle_share.serve``): 100 x (1 -
busy / wall) over the traced sub-window: busy is the union of the device
events' intervals (profiler trace), averaged over the ranks; wall the host
seconds of the traced calls. Under data parallelism an NCCL kernel that
waits for a slower rank counts as busy: it holds the card."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.window_s)
