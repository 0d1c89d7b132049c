"""collective_ms.train: device milliseconds of the collectives a train
step, from every rank's trace of the traced sub-window. An NCCL kernel
lasts from its launch until every rank has joined: on all but the last
rank to arrive it spins, waiting. The last rank's kernel is the transfer
alone, so each collective counts its shortest kernel over the ranks (the
ranks launch the same collectives in the same order). Nothing in one
process, or where the ranks' traces hold different numbers of them."""


def read(ctx):
    ranks = [[us for name, us in events if "nccl" in name.lower()]
             for events in ctx.rank_device]
    if len(ranks) < 2 or not ranks[0] or len({len(r) for r in ranks}) != 1:
        return None
    return sum(min(kernel) for kernel in zip(*ranks)) * 1e-3 / ctx.trace.reps
