"""Faults planted under the timed path, to show that the check catches
them: each replaces one entry point of the program (``harness.run_cell``'s
``program``) or patches one method, and leaves the rest of a run as it is.

- ``unchanged``: a train step that returns the state unchanged (the step
  runs, then the model and optimizer are put back as they were);
- ``half_batch``: a train step on the first half of its rows only, the
  mean taken over them;
- ``no_exchange``: the data-parallel step without the gradients' exchange
  between cards (``Mesh.all_reduce_grads_`` sums the metrics alone);
- ``altered_answer``: a ``Predictor`` whose log-probabilities have one
  point's answer changed in each request, where it produces them.
"""

import contextlib
import copy

import torch


class _Steps:
    """A stand-in for ``train.loop`` whose ``make_train_step`` wraps the
    real step with ``wrap(real) -> step``."""

    def __init__(self, wrap):
        self.wrap = wrap

    def make_train_step(self, task, mesh=None):
        from pointnet12_tpu_torch.train import loop

        return self.wrap(loop.make_train_step(task, mesh=mesh))


def _unchanged(real):
    def step(state, batch, generator=None):
        model = copy.deepcopy(state.model.state_dict())
        opt = copy.deepcopy(state.optimizer.state_dict())
        metrics = real(state, batch, generator)
        state.model.load_state_dict(model)
        state.optimizer.load_state_dict(opt)
        return metrics
    return step


def _half_batch(real):
    def step(state, batch, generator=None):
        return real(state, {k: v[:len(v) // 2] for k, v in batch.items()}, generator)
    return step


def altered_predictor():
    from pointnet12_tpu_torch.infer import Predictor

    class Altered(Predictor):
        def __call__(self, points):
            log_probs = super().__call__(points).clone()
            log_probs.view(-1, log_probs.shape[-1])[0] += 1.0  # one point's answer
            return log_probs

    return Altered


@contextlib.contextmanager
def no_exchange():
    """Within: ``Mesh.all_reduce_grads_`` sums the extras alone."""
    import torch.distributed as dist

    from pointnet12_tpu_torch.parallel.mesh import Mesh

    real = Mesh.all_reduce_grads_

    def extras_only(self, params, extras=()):
        flat = torch.stack([e.detach().reshape(()).float() for e in extras])
        dist.all_reduce(flat, group=self.group)
        return flat

    Mesh.all_reduce_grads_ = extras_only
    try:
        yield
    finally:
        Mesh.all_reduce_grads_ = real


PROGRAMS = {
    "unchanged": lambda: _Steps(_unchanged),
    "half_batch": lambda: _Steps(_half_batch),
    "altered_answer": altered_predictor,
}
