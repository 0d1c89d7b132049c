"""Kernel family: farthest-point sampling (``ops/fps.py`` on the card).

``KERNELS``: the device kernels that implement it, as their names read in
a profiler trace. ``CALLS``: the ``(module, attribute)`` the benchmark
records the family's calls at. ``work``: one recorded call's ``(bytes,
ops)`` from its arguments.
"""

from portbench.work import fps_work

KERNELS = ("fps_kernel",)
CALLS = (("pointnet12_tpu_torch.kernels.library", "fps"),)


def work(args, kwargs, out):
    xyz, npoint = args[0], args[1]
    b, n = xyz.shape[:2]
    return fps_work(b, n, int(npoint))
