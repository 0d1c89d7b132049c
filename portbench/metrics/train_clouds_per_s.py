"""train_clouds_per_s: every cloud of the global batch that finished a
train step in the window, over the window's seconds (host clock; the
window ends in a synchronise)."""


def read(ctx):
    return ctx.clouds / ctx.window_s
