"""mfu (``mfu.train``, ``mfu.serve``): the model FLOPs of the window's
clouds (the forward's, counted from the configuration's widths by
``portbench/flops.py``; three forwards a cloud in a train loop's window)
over the window's seconds and the cards' fp32 peak, in %."""

from portbench.flops import model_flop_share


def read(ctx):
    return model_flop_share(ctx, train=ctx.train)
