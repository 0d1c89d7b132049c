"""How a run's ``correct`` is decided: what the program produced on the
timed path, held to the plain reference (``reference/``) by the numbers
below, each against the cell's limit (``limits/<cell>.json``).

Training (``train``): set-up takes the first ``TRAIN_STEPS`` steps of the
very state and step the window then drives, through the window's own call
and feed; :class:`TrainWatch` reads, on the way, each step's loss, each
leaf's first gradient as the optimizer got it (Adam's first moment after
step 1 over ``1 - beta1``) and each leaf's change over the steps. The
reference works the same steps out again from the benchmark's weights, the
pool, the ``Feeder``'s shuffle and augmentation replayed
(``data.feeder_batches``) and a generator seeded as the program's was.
Compared, each the worst case:
- ``loss<i>``: the relative gap of step i's loss;
- ``grad``: the gap between the two sides' norms of a leaf's first
  gradient, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``update``: the same of a leaf's change over the steps, over the leaves
  whose raw first gradient in the reference is at least a thousandth of
  the median leaf's (a bias before a train-mode BN has a gradient that is
  rounding alone, and Adam moves it by its sign).

Serving (``serve``): a seeded sample of the requests served in the
window; the reference's eval forward of each request's clouds, and
``logprob_gap``, the widest gap between a log-probability the program's
``Predictor`` returned (of which the served labels are the argmax) and the
reference's, over every point and class. The served labels alone cannot
tell the TF32 control from float32: its labels differ from the
reference's on about one request in 24.

The controls (``train_control``, ``serve_control``) put the reference in
the program's place, computed with TF32 matmuls: the configurations state
float32 with TF32 off, and TF32 is the nearest precision below.
"""

import contextlib
import statistics

import torch

from portbench import reference
from portbench.data import feeder_batches
from portbench.reference import steps as ref_steps
from portbench.weights import make_weights

TRAIN_STEPS = 3
RAW_GRAD_FLOOR = 1e-3  # of the median leaf's raw gradient norm


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matmuls on or off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class TrainWatch:
    """Reads the program's numbers off its own state during set-up's first
    steps; holds floats only once :meth:`done`."""

    def __init__(self, state):
        self.state = state
        self.named = list(state.model.named_parameters())
        self.start = {n: p.detach().clone() for n, p in self.named}
        self.losses, self.grad, self.change = [], {}, {}

    def after_step(self, metrics):
        self.losses.append(metrics["loss"].detach().float().reshape(()))
        if len(self.losses) == 1:
            opt = self.state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            for n, p in self.named:
                m = opt.state.get(p, {}).get("exp_avg")
                self.grad[n] = (torch.zeros((), device=p.device) if m is None
                                else (m / (1 - beta1)).norm())

    def done(self):
        self.change = {n: float((p.detach() - self.start[n]).norm()) for n, p in self.named}
        self.grad = {n: float(v) for n, v in self.grad.items()}
        self.losses = [float(v) for v in self.losses]
        self.state = self.named = self.start = None


def _worst(prog: dict, ref: dict, keys) -> tuple:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)`` and its key."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    key = max(gaps, key=gaps.get)
    return gaps[key], key


def compare_train(losses, grad, change, ref) -> dict:
    """The numbers of a training check, and where each was worst."""
    out = {}
    for i, r in enumerate(ref["loss"], 1):
        p = losses[i - 1] if i <= len(losses) else float("inf")
        out[f"loss{i}"] = abs(p - r) / abs(r)
    out["grad"], g_key = _worst(grad, ref["grad"], ref["grad"])
    floor = RAW_GRAD_FLOOR * statistics.median(ref["raw"].values())
    kept = [k for k, v in ref["raw"].items() if v >= floor]
    out["update"], u_key = _worst(change, ref["change"], kept)
    out["_where"] = {"grad": g_key,
                     "update": f"{u_key} ({len(ref['change']) - len(kept)} leaves left out)"}
    return out


def reference_train(cfg, s, pool, batch, device, tf32=False) -> dict:
    """The reference's first steps of a training run of seeds ``s``."""
    model = reference.model(cfg["reference"])
    weights = make_weights(cfg, s["weights"], device)
    batches = [(torch.as_tensor(p, device=device), torch.as_tensor(lbl, device=device))
               for p, lbl in feeder_batches(pool, batch, s["feeder"], cfg["data"]["augment"],
                                            TRAIN_STEPS)]
    gen = torch.Generator(device).manual_seed(s["steps"])
    opt = cfg["optimizer"]
    with matmul_precision(tf32):
        return ref_steps.train_steps(model, cfg, weights, batches, gen,
                                     lr=opt["learning_rate"], weight_decay=opt["weight_decay"])


def train(cfg, s, pool, batch, watch: TrainWatch, device) -> dict:
    ref = reference_train(cfg, s, pool, batch, device)
    return compare_train(watch.losses, watch.grad, watch.change, ref)


def train_control(cfg, s, pool, batch, device) -> dict:
    """The control of a training cell: the reference with TF32 matmuls in
    the program's place."""
    low = reference_train(cfg, s, pool, batch, device, tf32=True)
    ref = reference_train(cfg, s, pool, batch, device)
    return compare_train(low["loss"], low["grad"], low["change"], ref)


def _gap(cfg, weights, points, log_probs, device) -> float:
    model = reference.model(cfg["reference"])
    with matmul_precision(False):
        lp = ref_steps.eval_log_probs(model, cfg, weights, torch.as_tensor(points, device=device))
    return float((torch.as_tensor(log_probs, device=device).float() - lp).abs().max())


def serve(cfg, s, sample, device) -> dict:
    """``sample``: ``[(points, served log-probabilities)]``."""
    weights = make_weights(cfg, s["weights"], device)
    return {"logprob_gap": max(_gap(cfg, weights, p, lp, device) for p, lp in sample)}


def serve_control(cfg, s, requests, device) -> dict:
    """The control of a serving cell: the reference's log-probabilities with
    TF32 matmuls in the program's place."""
    weights = make_weights(cfg, s["weights"], device)
    model = reference.model(cfg["reference"])
    sample = []
    for points in requests:
        with matmul_precision(True):
            lp = ref_steps.eval_log_probs(model, cfg, weights,
                                          torch.as_tensor(points, device=device))
        sample.append((points, lp))
    return {"logprob_gap": max(_gap(cfg, weights, p, lp, device) for p, lp in sample)}
