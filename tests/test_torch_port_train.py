"""The PyTorch port's train step of pointnet2_semseg against the JAX package,
on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs ``impl="jnp"`` (its CPU route; the Pallas segment sum runs in
interpret mode where it is named) and the port its plain PyTorch versions.
The random streams of the two frameworks cannot match, so every
comparison of a model runs with FPS starting at index 0 and no dropout;
the generator paths are tested for seeding and range only. Clouds whose
coordinates lie on a 1/64 grid keep both distance forms exact, so both
packages pick the same neighbours. The CUDA segment-sum kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against the plain
version.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as jax_nn
from flax import traverse_util
from flax.linen import normalization

from pointnet12_tpu.kernels.segsum_pallas import segment_matmul_pallas
from pointnet12_tpu.models import get_model as jax_get_model
from pointnet12_tpu.nn.feature_propagation import (
    FeaturePropagation as JaxFeaturePropagation,
)
from pointnet12_tpu.nn.mlp import _lifted_group_dense
from pointnet12_tpu.nn.set_abstraction import SetAbstraction as JaxSetAbstraction
from pointnet12_tpu.ops import interpolate as jax_interpolate
from pointnet12_tpu.ops.segsum import _segment_matmul_jnp
from pointnet12_tpu.train import losses as jax_losses
from pointnet12_tpu.train import metrics as jax_metrics
from pointnet12_tpu.train.loop import TrainState as JaxTrainState
from pointnet12_tpu.train.loop import make_eval_step as jax_make_eval_step
from pointnet12_tpu.train.optim import make_optimizer as jax_make_optimizer
from pointnet12_tpu.utils import torch_import

from pointnet12_tpu_torch import infer
from pointnet12_tpu_torch.kernels.segsum_cuda import segment_matmul_cuda
from pointnet12_tpu_torch.models import get_model
from pointnet12_tpu_torch.models.pointnet2_semseg import dropout
from pointnet12_tpu_torch.nn import mlp as port_mlp
from pointnet12_tpu_torch.nn.feature_propagation import FeaturePropagation
from pointnet12_tpu_torch.nn.set_abstraction import SetAbstraction
from pointnet12_tpu_torch.ops import interpolate as port_interpolate
from pointnet12_tpu_torch.ops.fps import farthest_point_sample
from pointnet12_tpu_torch.ops.gather import index_points
from pointnet12_tpu_torch.ops.segsum import segment_matmul, segment_matmul_torch
from pointnet12_tpu_torch.train import loop, losses, metrics
from pointnet12_tpu_torch.train.optim import make_optimizer
from pointnet12_tpu_torch.utils import jax_import
from pointnet12_tpu_torch.utils.jax_import import convert_shared_mlp
from tests.test_torch_port_ops import perturb_variables

CLASSES = 6
KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def grid_clouds(seed, b, n, c=9):
    """(b, n, c) clouds whose xyz lie on a 1/64 grid (both distance forms
    exact there), other channels uniform."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(size=(b, n, c)).astype(np.float32)
    pts[..., :3] = rng.randint(0, 64, size=(b, n, 3)) / 64.0
    return pts


def worst_bar_ratio(jgrads, tgrads, rtol=2e-4, atol=5e-5):
    """``(ratio, path)`` of the parameter whose largest error of ``tgrads``
    against ``jgrads`` takes the largest share of its bar, the
    per-parameter bars of tests/test_train_parity.py:136-152."""
    want = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = traverse_util.flatten_dict(tgrads)
    assert set(got) == set(want)
    return max(
        (np.max(np.abs(got[path] - a)) / (atol + rtol * np.max(np.abs(a))), path)
        for path, a in want.items()
    )


def assert_grad_parity(jgrads, tgrads):
    ratio, path = worst_bar_ratio(jgrads, tgrads)
    assert ratio < 1, f"grad mismatch at {path}: {ratio:.2f} of its bar"


def flax_variables(model):
    """A copy of the port's parameters and BN running statistics as the
    flax ``{"params", "batch_stats"}`` tree."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
          if "num_batches_tracked" not in k}
    return torch_import.convert_pointnet2_semseg(sd)


def flax_grads(model):
    """The port's ``.grad`` tensors routed through the weight converter,
    landing in the flax ``params`` layout (they transform as weights do)."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
          if "num_batches_tracked" not in k}
    for k, p in model.named_parameters():
        sd[k] = p.grad.detach().numpy()
    return torch_import.convert_pointnet2_semseg(sd)["params"]


def flat(tree) -> np.ndarray:
    """A pytree's leaves, in sorted path order, as one vector."""
    leaves = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([np.ravel(v) for _, v in sorted(leaves.items())])


def assert_global_parity(got, want):
    """The global bars of tests/test_train_parity.py:155-169."""
    got, want = flat(got), flat(want)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.999, cos
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.05


def assert_tree_close(got, want, rtol, atol):
    want = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    got = traverse_util.flatten_dict(got)
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=rtol, atol=atol, err_msg=str(path))


# ---------------------------------------------------------------- segment sum


def _ball_query_style_index(rng, B, J, R, M, k=8):
    """(B, J, R) int32 as a ball query's rows make them, in groups of ``k``:
    a few distinct indices ascending, the rest of the group repeating the
    first (``ops/ballquery.py``'s padding), so one segment takes several
    contributions from one group."""
    idx = np.empty((B, J, R), np.int32)
    for b in range(B):
        for j in range(J):
            for g0 in range(0, R, k):
                width = min(k, R - g0)
                found = rng.randint(1, width + 1)
                row = np.sort(rng.choice(M, size=found, replace=False))
                idx[b, j, g0:g0 + width] = np.concatenate([row, np.full(width - found, row[0])])
    return idx


@pytest.mark.parametrize(
    "B,J,R,C,M",
    [(2, 1, 256, 64, 128), (2, 3, 96, 32, 64), (1, 1, 512, 16, 256), (2, 3, 40, 8, 16),
     (2, 3, 96, 3, 64), (2, 1, 128, 130, 32)],
)
def test_segment_matmul_matches_jax(B, J, R, C, M):
    """The shapes of tests/test_kernels.py:258-261, and C=3 and C=130 (no
    multiple of 4: the scalar form of the CUDA kernel), weighted and not,
    on uniform indices and on a ball query's padded rows, against the
    scatter form and the Pallas kernel (interpreted)."""
    rng = np.random.RandomState(11)
    idx = rng.randint(0, M, size=(B, J, R)).astype(np.int32)
    w = rng.uniform(-1, 1, size=(B, J, R)).astype(np.float32)
    vals = rng.uniform(-1, 1, size=(B, R, C)).astype(np.float32)
    for idx in (idx, _ball_query_style_index(rng, B, J, R, M)):
        for weights in (w, None):
            jw = None if weights is None else jnp.asarray(weights)
            got = segment_matmul(_t(idx), None if weights is None else _t(weights), _t(vals), M)
            assert got.dtype == torch.float32 and got.shape == (B, M, C)
            for want in (
                _segment_matmul_jnp(jnp.asarray(idx), jw, jnp.asarray(vals), M),
                segment_matmul_pallas(jnp.asarray(idx), jw, jnp.asarray(vals), M,
                                      interpret=True),
            ):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_segment_matmul_drops_out_of_range_rows_as_the_pallas_kernel():
    rng = np.random.RandomState(12)
    idx = rng.randint(-3, 20, size=(2, 3, 40)).astype(np.int32)  # M = 16
    w = rng.uniform(-1, 1, size=(2, 3, 40)).astype(np.float32)
    vals = rng.uniform(-1, 1, size=(2, 40, 8)).astype(np.float32)
    got = segment_matmul_torch(_t(idx), _t(w), _t(vals), 16).numpy()
    want = segment_matmul_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(vals), 16, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_segment_matmul_cuda_refuses_cpu_tensors():
    idx = torch.zeros(1, 1, 8, dtype=torch.int32)
    vals = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        segment_matmul(idx, None, vals, 4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        segment_matmul_cuda(idx, None, vals, 4)
    assert segment_matmul_cuda.launches == 0


# ---------------------------------------------------------------- custom backwards


def test_three_interpolate_backward_matches_jax_and_autograd(monkeypatch):
    rng = np.random.RandomState(13)
    fine = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    coarse = rng.uniform(size=(2, 16, 3)).astype(np.float32)
    feats = rng.uniform(size=(2, 16, 8)).astype(np.float32)
    g = rng.randn(2, 64, 8).astype(np.float32)
    dists, idx = jax_interpolate.three_nn(jnp.asarray(fine), jnp.asarray(coarse), impl="jnp")
    _, vjp = jax.vjp(
        lambda f, d: jax_interpolate.three_interpolate(f, idx, d), jnp.asarray(feats), dists
    )
    want_f, want_d = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    f, d, i = _t(feats).requires_grad_(), _t(dists).requires_grad_(), _t(idx)
    got_f, got_d = torch.autograd.grad(port_interpolate.three_interpolate(f, i, d), (f, d), _t(g))
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=2e-5, atol=2e-6)
    # d dists runs through 1/(d + 1e-8)^2: reassociation noise is larger
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=2e-4, atol=1e-3)

    def plain(f, d):
        w = 1.0 / (d + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        return (index_points(f, i) * w[..., None]).sum(2)

    plain_f, plain_d = torch.autograd.grad(plain(f, d), (f, d), _t(g))
    np.testing.assert_allclose(got_f.numpy(), plain_f.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_d.numpy(), plain_d.numpy(), rtol=2e-4, atol=1e-3)

    # d dists is computed only when asked for: its gather is the only
    # index_points call of the backward
    gathers = []
    monkeypatch.setattr(port_interpolate, "index_points",
                        lambda *a: gathers.append(1) or index_points(*a))
    out = port_interpolate.three_interpolate(f, i, d.detach())
    n_forward = len(gathers)
    torch.autograd.grad(out, f, _t(g))
    assert len(gathers) == n_forward


@pytest.mark.parametrize("pts_grad", [True, False])
def test_lifted_group_dense_matches_jax_vjp(pts_grad, monkeypatch):
    rng = np.random.RandomState(14)
    B, N, S, K, C0, C1 = 2, 64, 16, 8, 7, 12
    pts = rng.uniform(size=(B, N, C0)).astype(np.float32)
    q = rng.uniform(size=(B, S, 3)).astype(np.float32)
    idx = rng.randint(0, N, size=(B, S, K)).astype(np.int32)
    kernel = rng.randn(C0, C1).astype(np.float32)
    bias = rng.randn(C1).astype(np.float32)
    g = rng.randn(B, S, K, C1).astype(np.float32)
    out, vjp = jax.vjp(
        lambda p, qq, k, b: _lifted_group_dense(N, p, qq, jnp.asarray(idx), k, b),
        *(jnp.asarray(x) for x in (pts, q, kernel, bias)),
    )
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    calls = []
    monkeypatch.setattr(port_mlp, "segment_matmul",
                        lambda *a, **k: calls.append(1) or segment_matmul(*a, **k))
    p = _t(pts).requires_grad_(pts_grad)
    qq = _t(q).requires_grad_()
    weight = _t(kernel.T.copy()).requires_grad_()
    b = _t(bias).requires_grad_()
    got_out = port_mlp._LiftedGroupDense.apply(p, qq, _t(idx), weight, b, "auto")
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    inputs = [p, qq, weight, b] if pts_grad else [qq, weight, b]
    got = torch.autograd.grad(got_out, inputs, _t(g))
    got = [x.numpy() for x in got]
    got[-2] = got[-2].T  # d weight (C1, C0) -> d kernel (C0, C1)
    for a, w_ in zip(got, want if pts_grad else want[1:]):
        np.testing.assert_allclose(a, w_, rtol=1e-4, atol=1e-4)
    assert len(calls) == (1 if pts_grad else 0)


def test_batch_norm_train_matches_flax():
    rng = np.random.RandomState(15)
    x = (2.0 + rng.randn(4, 8, 16, 12)).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(12)).astype(np.float32)
    shift = (0.1 * rng.randn(12)).astype(np.float32)
    mean0 = (0.1 * rng.randn(12)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=12).astype(np.float32)
    bn = jax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": shift},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(x, params):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        x, mutable=["batch_stats"])

    want, stats = f(jnp.asarray(x), variables["params"])
    _, vjp = jax.vjp(lambda x, p: f(x, p)[0], jnp.asarray(x), variables["params"])
    want_dx, want_dp = vjp(jnp.asarray(g))

    port = torch.nn.BatchNorm1d(12, eps=1e-5)
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(shift))
        port.running_mean.copy_(_t(mean0))
        port.running_var.copy_(_t(var0))
    xt = _t(x).requires_grad_()
    y = port_mlp.batch_norm_train(xt, port)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), stats["batch_stats"]["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), stats["batch_stats"]["var"],
                               rtol=1e-5, atol=1e-6)
    dx, dscale, dshift = torch.autograd.grad(y, (xt, port.weight, port.bias), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want_dp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dshift.numpy(), np.asarray(want_dp["bias"]), rtol=1e-4, atol=1e-4)


def test_batch_norm_variance_forms_against_float64():
    """Why the model tests run flax's two-pass variance: where a channel's
    mean is 3 standard deviations, flax's default ``E[x^2] - E[x]^2``
    normalises several times further from float64 than its two-pass form
    and the port's ``var_mean`` do."""
    rng = np.random.RandomState(16)
    x = (3.0 + rng.randn(2, 1024, 32, 32)).astype(np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean((0, 1, 2))) / np.sqrt(x64.var((0, 1, 2)) + 1e-5)
    flax_err = {}
    for fast in (True, False):
        bn = jax_nn.BatchNorm(use_running_average=False, epsilon=1e-5, use_fast_variance=fast)
        y, _ = bn.apply(bn.init(KEY, x), jnp.asarray(x), mutable=["batch_stats"])
        flax_err[fast] = np.abs(np.asarray(y) - want).max()
    y = port_mlp.batch_norm_train(_t(x), torch.nn.BatchNorm1d(32, eps=1e-5))
    port_err = np.abs(y.detach().numpy() - want).max()
    assert port_err < 2e-6 and flax_err[False] < 4e-6, (port_err, flax_err)
    assert flax_err[True] > 5 * max(port_err, flax_err[False]), (port_err, flax_err)


# ---------------------------------------------------------------- modules in train mode


def mlp_grads(port):
    """A port SharedMLP's parameter gradients in the flax layout."""
    out = {}
    for i, (conv, bn) in enumerate(zip(port.mlp_convs, port.mlp_bns)):
        out[f"dense_{i}"] = {"kernel": conv.weight.grad.numpy().T, "bias": conv.bias.grad.numpy()}
        out[f"bn_{i}"] = {"scale": bn.weight.grad.numpy(), "bias": bn.bias.grad.numpy()}
    return out


def load_mlp(port, variables):
    port.load_state_dict({
        k: _t(v) for k, v in convert_shared_mlp(
            variables["params"]["mlp"], variables["batch_stats"]["mlp"]
        ).items()
    })
    return port.train()


def jax_train_vjp(jmod, variables, args, g, pick):
    """The JAX module in train mode: its output ``pick(out)``, updated
    ``batch_stats`` and the gradients of ``sum(pick(out) * g)`` with respect
    to the parameters and the last argument (the features)."""
    def f(params, feats):
        out, mutated = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *args[:-1], feats, train=True, mutable=["batch_stats"],
        )
        return jnp.sum(pick(out) * g), (out, mutated["batch_stats"]["mlp"])

    (_, (out, stats)), (dparams, dfeats) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True
    )(variables["params"], args[-1])
    return out, stats, dparams["mlp"], np.asarray(dfeats)


def assert_train_module_matches(port, targs, want, stats, dparams, dfeats, g):
    """Output, running statistics, and per-element gradient bars for the
    parameters and the features (the last argument)."""
    feats = targs[-1].requires_grad_()
    got = port(*targs)
    got = got[1] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for i, bn in enumerate(port.mlp_bns):
        for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(buf.numpy(), stats[f"bn_{i}"][name], rtol=1e-4, atol=1e-6)
    (got * _t(g)).sum().backward()
    assert_grad_parity(dparams, mlp_grads(port))
    assert_grad_parity({"feats": dfeats}, {"feats": feats.grad.numpy()})


def test_set_abstraction_train_matches_jax():
    xyz = grid_clouds(20, 2, 256, 3)
    feats = np.random.RandomState(21).randn(2, 256, 5).astype(np.float32)
    # at a mean loss's scale: the exact zero gradient of a bias before BN
    # leaves noise in proportion, which the bars' atol covers
    g = (np.random.RandomState(23).randn(2, 64, 32) / 128).astype(np.float32)
    jmod = JaxSetAbstraction(64, 0.3, 16, [16, 16, 32], impl="jnp")
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    variables = perturb_variables(jmod.init(KEY, *args), 22)
    (want_xyz, want), stats, dparams, dfeats = jax_train_vjp(
        jmod, variables, args, g, lambda out: out[1]
    )
    port = load_mlp(SetAbstraction(64, 0.3, 16, 3 + 5, [16, 16, 32]), variables)
    got_xyz, _ = port(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    port = load_mlp(port, variables)  # back to the initial running statistics
    assert_train_module_matches(port, (_t(xyz), _t(feats)), want, stats, dparams, dfeats, g)


def test_feature_propagation_train_matches_jax():
    fine, coarse = grid_clouds(30, 2, 256, 3), grid_clouds(31, 2, 64, 3)
    rng = np.random.RandomState(32)
    f_fine = rng.randn(2, 256, 8).astype(np.float32)
    f_coarse = rng.randn(2, 64, 16).astype(np.float32)
    g = (rng.randn(2, 256, 16) / 512).astype(np.float32)
    jmod = JaxFeaturePropagation([32, 16])
    # the coarse features last: their gradient runs through the segment sum
    args = tuple(jnp.asarray(a) for a in (fine, coarse, f_fine, f_coarse))
    variables = perturb_variables(jmod.init(KEY, *args), 33)
    want, stats, dparams, dfeats = jax_train_vjp(jmod, variables, args, g, lambda out: out)
    port = load_mlp(FeaturePropagation(8 + 16, [32, 16]), variables)
    assert_train_module_matches(
        port, tuple(_t(a) for a in (fine, coarse, f_fine, f_coarse)), want, stats,
        dparams, dfeats, g,
    )


def test_train_mode_drops_the_folded_weights():
    port = FeaturePropagation(16, [8])
    port.eval().fold_bn_()
    assert port.folded is not None
    port.eval()
    assert port.folded is not None
    port.train()
    assert port.folded is None


def test_dropout_is_seeded_and_keep_scaled():
    x = torch.ones(64, 128)
    a = dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((a == 0).float().mean()) < 0.55
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, None)


def test_fps_generator_start_is_seeded_and_in_range():
    xyz = _t(np.random.RandomState(40).uniform(size=(6, 128, 3)).astype(np.float32))
    a = farthest_point_sample(xyz, 16, generator=torch.Generator().manual_seed(3))
    b = farthest_point_sample(xyz, 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    want = torch.randint(0, 128, (6,), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    assert torch.equal(a[:, 0], want)
    assert ((a >= 0) & (a < 128)).all() and len(set(a[:, 0].tolist())) > 1
    c = farthest_point_sample(xyz, 16, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(a[:, 0], c[:, 0])


# ---------------------------------------------------------------- losses, metrics, optimizers


def test_losses_and_metrics_match_jax():
    rng = np.random.RandomState(50)
    logits = rng.randn(3, 200, CLASSES).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.randint(0, CLASSES, size=(3, 200))
    weight = rng.uniform(0.5, 2.0, size=CLASSES).astype(np.float32)
    mask = (rng.uniform(size=(3, 200)) > 0.3).astype(np.float32)
    jl, jlab, jw, jm = (jnp.asarray(a) for a in (logp, labels, weight, mask))
    tl, tlab, tw, tm = (_t(a) for a in (logp, labels, weight, mask))
    for w_, m_, jw_, jm_ in ((None, None, None, None), (tw, tm, jw, jm), (tw, None, jw, None)):
        np.testing.assert_allclose(
            float(losses.nll_loss(tl, tlab, weight=w_, mask=m_)),
            float(jax_losses.nll_loss(jl, jlab, weight=jw_, mask=jm_)), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.segmentation_loss(tl, tlab, class_weight=tw, mask=tm)),
        float(jax_losses.segmentation_loss(jl, jlab, class_weight=jw, mask=jm)), rtol=1e-6)
    for m_, jm_ in ((None, None), (tm, jm)):
        np.testing.assert_allclose(float(metrics.accuracy(tl, tlab, m_)),
                                   float(jax_metrics.accuracy(jl, jlab, jm_)), rtol=1e-6)
    pred = logp.argmax(-1)
    for ignore in (None, 0):
        cm = metrics.confusion_matrix(_t(pred), tlab, CLASSES, tm)
        jcm = jax_metrics.confusion_matrix(jnp.asarray(pred), jlab, CLASSES, jm)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
        cm[2] = 0  # a class absent from the targets
        for got, want in zip(metrics.iou_from_confusion(cm, ignore),
                             jax_metrics.iou_from_confusion(jnp.asarray(cm.numpy()), ignore)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_and_step_lr_match_optax(name):
    """Identical gradients into both: 6 steps with a StepLR halving every
    2 epochs of 1 step, so the schedule's count is checked too."""
    rng = np.random.RandomState(51)
    # weights at the model's scale: 1e-6 is then some 100 ulps of them
    params = {"a": 0.1 * rng.randn(5, 3).astype(np.float32),
              "b": 0.1 * rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    kw = dict(learning_rate=0.01, weight_decay=1e-2, steps_per_epoch=1,
              lr_step_epochs=2, lr_gamma=0.5)
    tx = jax_make_optimizer(name, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, sched = make_optimizer(tparams.values(), name, **kw)
    lrs = []
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6)
    np.testing.assert_allclose(lrs, [0.01, 0.01, 0.005, 0.005, 0.0025, 0.0025])


def test_factories_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = {k: v.numpy() for k, v in
          get_model("pointnet2_semseg", num_classes=5).state_dict().items()}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        infer.Predictor.from_state_dict("pointnet2_semseg", sd, 5)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        infer.Predictor.from_jax_variables(
            "pointnet2_semseg", torch_import.convert_pointnet2_semseg(sd), 5
        )
    with pytest.raises(RuntimeError, match="no CUDA card"):
        loop.create_train_state("pointnet2_semseg", 5)
    state = loop.create_train_state("pointnet2_semseg", 5, device="cpu")
    assert state.device == torch.device("cpu") and state.model.training


# ---------------------------------------------------------------- the train step


@pytest.fixture(scope="module")
def semseg():
    """The JAX model (FPS from index 0, no dropout), its perturbed init and
    one jitted loss-and-gradient function shared by the model tests.

    flax's BatchNorm takes the batch variance as ``E[x^2] - E[x]^2`` by
    default. In fp32 that loses digits where a channel's mean is large
    against its spread: on an activation with mean/std 3 it lands more
    than 5x further from float64 than its two-pass form and the port's
    ``var_mean`` (test_batch_norm_variance_forms_against_float64).
    The loss barely moves, but the head BN's gradient and the running
    statistics then miss the per-element bars below. So these tests run
    flax's own two-pass variance (``use_fast_variance=False``), the same
    statistic, which the port computes.
    """
    compute_stats = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    model = jax_get_model("pointnet2_semseg", num_classes=CLASSES, dropout_rate=0.0,
                          impl="jnp")
    sample = jnp.zeros((1, 1024, 9), jnp.float32)
    variables = perturb_variables(model.init({"params": KEY}, sample, train=False), 52)

    @jax.jit
    def loss_and_grads(params, batch_stats, pts, lbl):
        def loss_fn(p):
            (logp, _), mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, pts, train=True,
                fps_key=None, mutable=["batch_stats"], rngs={"dropout": KEY},
            )
            return jax_losses.segmentation_loss(logp, lbl), mutated["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, new_bs, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(normalization, "_compute_stats", two_pass)
        yield model, variables, loss_and_grads


def _port_state(variables, optimizer=None):
    return loop.create_train_state(
        "pointnet2_semseg", CLASSES, device="cpu", dropout_rate=0.0,
        state_dict=jax_import.convert_pointnet2_semseg(variables), optimizer=optimizer,
    )


def _batch(seed):
    pts = grid_clouds(seed, 2, 1024)
    lbl = np.random.RandomState(seed + 1).randint(0, CLASSES, size=(2, 1024))
    return pts, lbl


def test_model_gradients_match_jax(semseg):
    """The whole-model gradient at init. Per element it holds only where no
    train-mode BN lies between the parameter and the loss (the head's last
    Dense and BN): the fp32 gradient of this model is chaotic at the scale
    of those bars, and a one-ulp nudge of the input moves the port's own
    gradient past them (test_model_gradient_spread_under_a_one_ulp_nudge).
    So the whole vector is held to the global bars that
    tests/test_train_parity.py:240-271 sets for this model, and the layers
    one at a time to the per-element bars in the module tests above."""
    _, variables, loss_and_grads = semseg
    pts, lbl = _batch(53)
    loss, _, jgrads = loss_and_grads(variables["params"], variables["batch_stats"],
                                     jnp.asarray(pts), jnp.asarray(lbl))
    model = _port_state(variables).model
    got = losses.segmentation_loss(model(_t(pts)), _t(lbl))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    tgrads = flax_grads(model)
    assert_grad_parity({k: jgrads[k] for k in ("conv2", "bn1")},
                       {k: tgrads[k] for k in ("conv2", "bn1")})
    assert_global_parity(tgrads, jgrads)


def test_model_gradient_spread_under_a_one_ulp_nudge(semseg):
    """What sets the bars of the whole-model tests: nudging the input
    features by one ulp moves the port's own fp32 gradient past the
    per-element bars of tests/test_train_parity.py:136-152, by more than
    5x at the worst parameter, while the global bars hold."""
    _, variables, _ = semseg
    pts, lbl = _batch(53)
    nudged = pts.copy()
    nudged[..., 3:] = np.nextafter(nudged[..., 3:], np.float32(2))
    grads = []
    for p in (pts, nudged):
        model = _port_state(variables).model
        losses.segmentation_loss(model(_t(p)), _t(lbl)).backward()
        grads.append(flax_grads(model))
    ratio, path = worst_bar_ratio(grads[0], grads[1])
    assert ratio > 5, (ratio, path)
    assert_global_parity(grads[1], grads[0])


def test_two_sgd_steps_match_jax(semseg):
    """Two steps of ``make_train_step`` with SGD (momentum 0.9, weight
    decay 1e-4), each held against JAX's step from the same parameters and
    BN statistics: the loss, the updated BN statistics, and the parameter
    update, which is the learning rate times the gradient (the global
    bars, see test_model_gradients_match_jax). JAX starts each step from
    the port's parameters: a free run would compound the gradient's fp32
    chaos (test_model_gradient_spread_under_a_one_ulp_nudge) into the
    second step's parameters."""
    _, variables, loss_and_grads = semseg
    tx = jax_make_optimizer("sgd", learning_rate=0.01)
    opt_state = tx.init(variables["params"])
    batch_stats = variables["batch_stats"]
    state = _port_state(variables, optimizer=dict(name="sgd", learning_rate=0.01))
    step = loop.make_train_step()
    for seed in (54, 56):
        pts, lbl = _batch(seed)
        params = flax_variables(state.model)["params"]
        loss, batch_stats, grads = loss_and_grads(
            params, batch_stats, jnp.asarray(pts), jnp.asarray(lbl)
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        got = step(state, {"points": pts, "label": lbl})
        assert abs(float(got["loss"]) - float(loss)) < 1e-4
        after = flax_variables(state.model)
        assert_tree_close(after["batch_stats"], batch_stats, rtol=1e-4, atol=1e-6)
        assert_global_parity(
            jax.tree_util.tree_map(np.subtract, after["params"], params), updates
        )
    assert state.step == 2


def test_train_step_weighs_classes_and_ignores_a_label():
    """The step's loss and accuracy are those of its forward under the class
    weights and the ``ignore_class`` mask, before the update."""
    state = loop.create_train_state("pointnet2_semseg", CLASSES, device="cpu",
                                    dropout_rate=0.0)
    pts, lbl = _batch(60)
    weight = np.linspace(0.5, 2.0, CLASSES).astype(np.float32)
    twin = copy.deepcopy(state.model)
    with torch.no_grad():
        logp = twin(_t(pts))
    mask = (_t(lbl) != 0).float()
    got = loop.make_train_step(class_weight=weight, ignore_class=0)(
        state, {"points": pts, "label": lbl})
    want = losses.segmentation_loss(logp, _t(lbl), class_weight=_t(weight), mask=mask)
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got["accuracy"]),
                               float(metrics.accuracy(logp, _t(lbl), mask)), rtol=1e-6)
    assert state.step == 1 and state.scheduler.last_epoch == 1


def test_eval_step_matches_jax(semseg):
    model, variables, _ = semseg
    pts, lbl = _batch(58)
    cloud_mask = np.array([1.0, 0.0], np.float32)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None, tx=None, apply_fn=model.apply,
    )
    want = jax_make_eval_step(model, task="seg", num_classes=CLASSES, ignore_class=0)(
        jstate, {"points": jnp.asarray(pts), "label": jnp.asarray(lbl),
                 "mask": jnp.asarray(cloud_mask)})
    state = _port_state(variables)
    got = loop.make_eval_step(CLASSES, ignore_class=0)(
        state, {"points": pts, "label": lbl, "mask": cloud_mask})
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    assert float(got["count"]) == float(want["count"]) == float((lbl[0] != 0).sum())
    for key in ("loss", "accuracy"):
        assert abs(float(got[key]) - float(want[key])) < 1e-5, key
    assert not state.model.training and state.model.head_folded is not None
