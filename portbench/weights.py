"""The benchmark's weights, made from the seed on the device in two calls
(one normal draw, one uniform draw), under the lineage's ``state_dict``
keys. Both sides get them: the program loads them, the reference reads
them. The configuration's ``assumed.weights`` states the distributions:
each Linear's weight N(0, 2 / fan_in) (He's scale, so activations keep
their size through the layers and the served log-probabilities are far
from ties), its bias U(-0.1, 0.1); each BN's scale U(0.9, 1.1), shift
U(-0.1, 0.1), running mean U(-0.1, 0.1) and running variance U(0.5,
1.5)."""

import math

import torch

from portbench import reference

# (key suffix, low, high) of the uniform draws of a BN layer
_BN_UNIFORM = (("weight", 0.9, 1.1), ("bias", -0.1, 0.1), ("running_mean", -0.1, 0.1),
               ("running_var", 0.5, 1.5))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{key: tensor}`` of configuration ``cfg``'s model, float32 on
    ``device`` (``num_batches_tracked`` int64 zeros), drawn from ``seed``."""
    model = reference.model(cfg["reference"])
    linears = model.linear_shapes(cfg)
    bns = model.bn_keys(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(o * i for _, o, i in linears)
    n_uniform = sum(o for _, o, _ in linears) + 4 * sum(c for _, c in bns)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, a, u = {}, 0, 0
    for key, o, i in linears:
        out[f"{key}.weight"] = normal[a:a + o * i].view(o, i) * math.sqrt(2.0 / i)
        out[f"{key}.bias"] = uniform[u:u + o] * 0.2 - 0.1
        a, u = a + o * i, u + o
    for key, c in bns:
        for suffix, lo, hi in _BN_UNIFORM:
            out[f"{key}.{suffix}"] = uniform[u:u + c] * (hi - lo) + lo
            u += c
        out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out
