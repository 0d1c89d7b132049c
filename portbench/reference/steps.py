"""The reference's train steps and eval pass.

``train_steps`` runs the configuration's optimizer (Adam with L2 weight
decay added to the gradient, as ``torch.optim.Adam(weight_decay=)``) by
hand over the reference forward, from the benchmark's weights, on the
batches the benchmark worked out, with the draws of a generator seeded as
the program's was. It returns what the harness compares: each step's
loss, each leaf's first gradient as the optimizer gets it (decay
included), each leaf's raw first gradient (for the rule that leaves out
leaves whose gradient is nought to rounding) and each leaf's change over
the steps.
"""

import torch

from portbench.reference import layers as L

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def trainable(weights: dict) -> list:
    """The keys of the leaves an optimizer moves: Linear and BN weights and
    biases, not the running statistics."""
    return [k for k in weights if not k.endswith(("running_mean", "running_var",
                                                    "num_batches_tracked"))]


def train_steps(model, cfg: dict, weights: dict, batches, generator, *, lr: float,
                weight_decay: float):
    """``batches``: ``[(points, labels)]`` tensors on the device. Returns
    ``{"loss": [float], "grad": {key: norm}, "raw": {key: norm}, "change":
    {key: norm}}``."""
    keys = trainable(weights)
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in keys}
    start = {k: weights[k].detach().clone() for k in keys}
    m = {k: torch.zeros_like(params[k]) for k in keys}
    v = {k: torch.zeros_like(params[k]) for k in keys}
    draws = L.Draws(generator)
    losses, grad, raw = [], {}, {}
    for t, (points, labels) in enumerate(batches, 1):
        w = dict(weights, **params)
        loss = L.nll(model.forward(w, points, cfg, True, draws), labels)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
            for k, g in zip(keys, grads):
                p = params[k]
                if t == 1:
                    raw[k] = float(g.norm())
                g = g + weight_decay * p
                if t == 1:
                    grad[k] = float(g.norm())
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    change = {k: float((params[k].detach() - start[k]).norm()) for k in keys}
    return {"loss": losses, "grad": grad, "raw": raw, "change": change}


@torch.no_grad()
def eval_log_probs(model, cfg: dict, weights: dict, points: torch.Tensor) -> torch.Tensor:
    """The eval forward (BN on the running statistics, every FPS from index
    0) of ``points``."""
    return model.forward(weights, points, cfg, False)
