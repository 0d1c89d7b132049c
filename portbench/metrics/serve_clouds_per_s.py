"""serve_clouds_per_s: every cloud labelled in the window, over the
window's seconds (host clock; each request ends with its labels on the
host)."""


def read(ctx):
    return ctx.clouds / ctx.window_s
