"""setup_s: seconds from the process's start to the first timed step or
request (kernel build or load, weights, data, the checked first steps,
warm-up)."""


def read(ctx):
    return ctx.setup_s
