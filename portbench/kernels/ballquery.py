"""Kernel family: the index-order ball query (``ops/ballquery.py``'s scan
route on the card). See ``fps.py`` for the fields."""

from portbench.work import ballquery_work

KERNELS = ("ballquery_kernel",)
CALLS = (("pointnet12_tpu_torch.kernels.library", "ballquery"),)


def work(args, kwargs, out):
    radius, nsample, xyz, centers = args[:4]
    return ballquery_work(float(radius), int(nsample), xyz, centers)
