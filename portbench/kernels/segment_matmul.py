"""Kernel family: the backward's segment sum (``ops/segsum.py`` on the
card: d coarse features of the FP layers, d points of the lifted first
Dense). See ``fps.py`` for the fields."""

from portbench.work import segsum_work

KERNELS = ("segment_matmul_kernel",)
CALLS = (("pointnet12_tpu_torch.kernels.segsum_cuda", "segment_matmul_cuda"),)


def work(args, kwargs, out):
    idx, weights, values, num_segments = args[:4]
    b, j, r = idx.shape
    return segsum_work(b, j, r, values.shape[2], int(num_segments), weights is not None)
