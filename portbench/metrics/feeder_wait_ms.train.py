"""feeder_wait_ms.train: the mean host time a step of the window waited
for the next batch from the Feeder's iterator (the benchmark's own span
around ``next()``)."""


def read(ctx):
    waits = ctx.feeder_wait_s
    return sum(waits) / len(waits) * 1e3 if waits else None
