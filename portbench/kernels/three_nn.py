"""Kernel family: 3-NN of the feature-propagation layers
(``ops/interpolate.py::three_nn`` on the card). See ``fps.py`` for the
fields."""

from portbench.work import three_nn_work

KERNELS = ("three_nn_kernel",)
CALLS = (("pointnet12_tpu_torch.kernels.library", "three_nn"),)


def work(args, kwargs, out):
    query, ref = args[:2]
    return three_nn_work(query.shape[0], query.shape[1], ref.shape[1])
