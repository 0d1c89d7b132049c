"""The PyTorch port's bf16 and stochastic-rounding train path of
pointnet2_semseg, and the fused Dense + BN statistics, against the JAX
package on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX side
runs its CPU routes: ``impl="jnp"`` and the Pallas kernel in interpret
mode. Its fused-statistics knob is read when a function is traced, so the
tests set ``set_fused_bn_stats`` inside ``try``/``finally`` and trace
after setting it. JAX draws its stochastic-rounding seeds from its
dropout stream, which PyTorch cannot reproduce, so ``_sr_to_bf16`` is held
bit for bit with the same explicit seed given to both, the modules and the
model are held to JAX with ``sr=False``, and stochastic rounding at model
level by its own properties. The CUDA kernel of ``csrc/bn_stats.cu`` runs
only on the card, where ``chip_smoke.py`` holds it against the plain
version.

bf16 bars: bf16 keeps 8 bits of mantissa, so one rounding is up to 2^-9
relative and a one-ulp step 2^-8 (0.4%). The two frameworks sum the fp32
products of a matmul in different orders, so a product that lands near a
bf16 rounding boundary rounds one ulp apart; that flip then feeds the next
layer. The bars below count ulps or are stated in those terms.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from flax.linen import normalization

from pointnet12_tpu.cli.common import model_precision_kwargs as jax_precision_kwargs
from pointnet12_tpu.kernels.bn_stats_fused import dense_bn_stats as jax_dense_bn_stats
from pointnet12_tpu.models import get_model as jax_get_model
from pointnet12_tpu.nn import mlp as jax_mlp
from pointnet12_tpu.nn.feature_propagation import (
    FeaturePropagation as JaxFeaturePropagation,
)
from pointnet12_tpu.nn.set_abstraction import SetAbstraction as JaxSetAbstraction
from pointnet12_tpu.train import losses as jax_losses
from pointnet12_tpu.train.loop import TrainState as JaxTrainState
from pointnet12_tpu.train.precise_bn import recompute_batch_stats as jax_precise_bn

from pointnet12_tpu_torch import infer
from pointnet12_tpu_torch.kernels.bn_stats_cuda import (
    MMA_ROWS, column_tiles, dense_bn_stats_cuda, stats_in_kernel_order,
)
from pointnet12_tpu_torch.models import model_precision_kwargs
from pointnet12_tpu_torch.nn import mlp as port_mlp
from pointnet12_tpu_torch.nn.feature_propagation import FeaturePropagation
from pointnet12_tpu_torch.nn.set_abstraction import SetAbstraction
from pointnet12_tpu_torch.ops.bn_stats import dense_bn_stats, dense_bn_stats_torch
from pointnet12_tpu_torch.train import loop, losses
from pointnet12_tpu_torch.train.precise_bn import recompute_batch_stats
from pointnet12_tpu_torch.utils import jax_import
from tests.test_torch_port_fused_sa import split_tf32, tf32_rna
from tests.test_torch_port_ops import perturb_variables
from tests.test_torch_port_train import (
    flax_grads,
    flax_variables,
    grid_clouds,
    load_mlp,
    mlp_grads,
)

CLASSES = 6
KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x) -> np.ndarray:
    """A JAX array or tensor of any float dtype as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def bf16_ulps(a, b) -> np.ndarray:
    """Elementwise distance in bf16 ulps of two bf16-valued arrays (the
    bf16 bit patterns mapped onto a signed line, so -0 == +0)."""
    def line(x):
        bits = (_f32(x).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    return np.abs(line(a) - line(b))


def bf16_bits(x) -> np.ndarray:
    return _f32(x).view(np.uint32) >> 16


def jit_rounded(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off. The port rounds
    the result of every bf16 op to bf16, as JAX does op by op; under
    ``jit`` XLA's CPU compiler otherwise keeps fp32 between the bf16 ops it
    fuses (measured on the bf16 set-abstraction case: 138 ulps apart from
    the op-by-op result, the same result with the option off)."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@contextlib.contextmanager
def jax_fused_bn_stats(enabled: bool):
    """JAX's fused-statistics knob, for functions traced inside the block."""
    before = jax_mlp.fused_bn_stats_enabled()
    jax_mlp.set_fused_bn_stats(enabled)
    try:
        yield
    finally:
        jax_mlp.set_fused_bn_stats(before)


@pytest.fixture
def flax_two_pass_variance(monkeypatch):
    """flax's unfused BatchNorm with its two-pass variance, the form the
    port's ``batch_norm_train`` takes (see tests/test_torch_port_train.py's
    ``semseg`` fixture). The fused path takes the one-pass form in both."""
    compute_stats = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    monkeypatch.setattr(normalization, "_compute_stats", two_pass)


# ---------------------------------------------------------------- the SR cast


def sr_inputs(seed, shape):
    """Values of every kind the cast meets: normal activations, negatives,
    magnitudes near fp32's limits, subnormals, exact zeros and values bf16
    already holds."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    flat_x = x.reshape(-1)
    n = flat_x.size
    flat_x[: n // 6] *= 1e30
    flat_x[n // 6: n // 3] = rng.uniform(-1, 1, n // 3 - n // 6) * np.float32(1e-39)
    flat_x[n // 3: n // 2] = np.asarray(flat_x[n // 3: n // 2], jnp.bfloat16).astype(np.float32)
    flat_x[n // 2: n // 2 + 3] = 0.0
    return x


@pytest.mark.parametrize("shape", [(37,), (3, 5, 11), (2, 4, 8, 16)])
@pytest.mark.parametrize("seed", [0, 1, 2654435761, 2**31 + 7, 2**32 - 1])
def test_sr_to_bf16_matches_jax_bit_for_bit(shape, seed):
    x = sr_inputs(7 + len(shape), shape)
    want = jax_mlp._sr_to_bf16(jnp.asarray(x), jnp.uint32(seed))
    for s in (seed, torch.tensor(seed - (seed >= 2**31) * 2**32, dtype=torch.int32)):
        got = port_mlp.sr_to_bf16(_t(x), s)
        assert got.dtype == torch.bfloat16 and got.shape == shape
        np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))
    held = np.asarray(x, jnp.bfloat16).astype(np.float32)
    exact = held == x  # values bf16 already holds pass unchanged
    assert exact.sum() >= x.size // 6
    np.testing.assert_array_equal(_f32(port_mlp.sr_to_bf16(_t(x), seed))[exact], x[exact])


def test_sr_to_bf16_gradient_is_straight_through():
    x = sr_inputs(3, (4, 33))
    g = np.asarray(np.random.RandomState(4).randn(4, 33), jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: jax_mlp._sr_to_bf16(v, jnp.uint32(5)), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(port_mlp.sr_to_bf16(xt, 5), xt, _t(g.astype(np.float32)).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sr_to_bf16_is_unbiased():
    """Over 64 seeds and 4096 copies of each value the mean of the rounded
    values lands within 4 standard errors of the value, where rounding to
    nearest sits a fixed fraction of an ulp away."""
    values = np.float32([1.0 + 2**-9, 1.0 + 3 * 2**-10, -3.3, 0.1234567, 1e-3 + 1e-7])
    x = torch.from_numpy(np.repeat(values[:, None], 4096, 1))
    rounded = torch.stack([port_mlp.sr_to_bf16(x, s).float() for s in range(64)])
    mean = rounded.mean((0, 2)).double().numpy()
    # each draw is one of the two neighbours, an ulp u apart: sd <= u / 2
    ulp = np.abs(np.float64(np.asarray(values, jnp.bfloat16).astype(np.float32))) * 2.0**-7
    err = np.abs(mean - values)
    assert np.all(err < 4 * (ulp / 2) / np.sqrt(64 * 4096)), (err, ulp)
    nearest = np.abs(np.asarray(values, jnp.bfloat16).astype(np.float64) - values)
    assert np.all(err[:2] < nearest[:2] / 10)


def test_activation_cast_draws_a_fresh_seed_per_train_cast():
    x = torch.from_numpy(sr_inputs(9, (8, 64)))
    gen = torch.Generator().manual_seed(3)
    a = port_mlp.activation_cast(x, torch.bfloat16, True, True, gen)
    b = port_mlp.activation_cast(x, torch.bfloat16, True, True, gen)
    assert not torch.equal(a, b)
    again = torch.Generator().manual_seed(3)
    assert torch.equal(a, port_mlp.activation_cast(x, torch.bfloat16, True, True, again))
    for sr, training in ((True, False), (False, True)):  # eval, or no sr: nearest
        assert torch.equal(port_mlp.activation_cast(x, torch.bfloat16, sr, training, gen),
                           x.to(torch.bfloat16))
    assert port_mlp.activation_cast(x, torch.float32, True, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        port_mlp.activation_cast(x, torch.bfloat16, True, True, None)


# ---------------------------------------------------------------- dense_bn_stats

BN_SHAPES = [((256, 32), 64), ((2, 128, 48), 96), ((2, 16, 32, 24), 40)]


def bn_stats_inputs(seed, xshape, co, offset=0.0):
    """x, kernel (Ci, Co) as JAX holds it, bias; ``offset`` moves each
    output column's mean to ``offset`` times its spread."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*xshape).astype(np.float32)
    k = (rng.randn(xshape[-1], co) * 0.2).astype(np.float32)
    b = (rng.randn(co) * 0.1 + offset * np.linalg.norm(k, axis=0)).astype(np.float32)
    return x, k, b


def assert_stats_close(got, want, y):
    """mean and var of the same one-pass form, summed in other orders:
    within 1e-5 of the largest mean |y| and of the largest E[y^2]
    (fp32 sums over at most 1024 rows here)."""
    yf = _f32(y).reshape(-1, _f32(y).shape[-1]).astype(np.float64)
    m_bar = 1e-5 * np.abs(yf).mean(0).max()
    v_bar = 1e-5 * (yf * yf).mean(0).max()
    assert np.abs(_f32(got[0]) - _f32(want[0])).max() <= m_bar
    assert np.abs(_f32(got[1]) - _f32(want[1])).max() <= v_bar


@pytest.mark.parametrize("xshape,co", BN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_dense_bn_stats_plain_matches_jax(xshape, co, dtype, offset):
    """The plain version against JAX's jnp reference and its Pallas kernel
    (interpreted). fp32 y within 1e-5 of the largest |y|; bf16 y no element
    more than one ulp apart (the products sum in other orders); the
    statistics of the one-pass form against the same form (with the column
    mean 3 spreads off zero, ``offset=3``, the form itself loses digits to
    cancellation, in both packages alike)."""
    x, k, b = bn_stats_inputs(30 + len(xshape), xshape, co, offset)
    tdt = getattr(torch, dtype)
    y, mean, var = dense_bn_stats(_t(x), _t(k.T.copy()), _t(b), tdt, impl="torch")
    assert y.dtype == tdt and y.shape == xshape[:-1] + (co,)
    plain = dense_bn_stats_torch(_t(x).to(tdt), _t(k.T.copy()).to(tdt), _t(b))
    for got, want in zip(plain, (y, mean, var)):
        assert torch.equal(got, want)
    for impl in ("jnp", "pallas"):
        jy, jm, jv = jax_dense_bn_stats(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                        out_dtype=getattr(jnp, dtype), impl=impl)
        if dtype == "float32":
            assert np.abs(_f32(y) - _f32(jy)).max() <= 1e-5 * np.abs(_f32(jy)).max()
        else:
            assert bf16_ulps(y, jy).max() <= 1, impl
        assert_stats_close((mean, var), (jm, jv), jy)


@pytest.mark.parametrize("xshape,co", BN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_bn_stats_backward_matches_jax_vjp(xshape, co, dtype):
    """``(gx, gW, gb)`` from the same cotangents on ``y``, mean and var.
    fp32: within 1e-5 of each gradient's largest element. bf16: gx leaves
    in bf16 (one ulp); gW and gb are fp32 sums of products of bf16 values
    and land within 1e-5 of their largest element unless a y rounded one
    ulp apart, which moves g by a part in 2^8 of that element's share:
    within 2e-3 of the largest."""
    x, k, b = bn_stats_inputs(40 + len(xshape), xshape, co)
    rng = np.random.RandomState(41)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gy = np.asarray(rng.randn(*xshape[:-1], co), jdt)
    gmean, gvar = rng.randn(co).astype(np.float32), rng.randn(co).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x_, k_, b_: jax_dense_bn_stats(x_, k_, b_, out_dtype=jdt, impl="jnp"),
        *(jnp.asarray(a) for a in (x, k, b)),
    )
    want = [np.asarray(a) for a in vjp((jnp.asarray(gy), jnp.asarray(gmean), jnp.asarray(gvar)))]
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, k.T.copy(), b))
    out = dense_bn_stats(xt, wt, bt, tdt, impl="torch")
    got = torch.autograd.grad(out, (xt, wt, bt),
                              (_t(gy.astype(np.float32)).to(tdt), _t(gmean), _t(gvar)))
    assert [g.dtype for g in got] == [torch.float32] * 3
    gx, gw, gb = (g.numpy() for g in got)
    gw = gw.T
    if dtype == "float32":
        for g, w in ((gx, want[0]), (gw, want[1]), (gb, want[2])):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    else:
        assert bf16_ulps(gx, want[0]).max() <= 1
        for g, w in ((gw, want[1]), (gb, want[2])):
            assert np.abs(g - w).max() <= 2e-3 * np.abs(w).max()


def test_dense_bn_stats_kernel_refuses_cpu_tensors():
    x, w, b = torch.zeros(8, 4), torch.zeros(3, 4), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        dense_bn_stats(x, w, b, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dense_bn_stats_cuda(x, w, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dense_bn_stats_cuda(x.half(), w.half(), b)
    assert dense_bn_stats_cuda.launches == 0


# ---------------------------------------------------------------- the kernel's fixed-order statistics
# csrc/bn_stats.cu takes the statistics of its bf16 y in a fixed order,
# modelled by kernels/bn_stats_cuda.py::stats_in_kernel_order (which the card
# matches bit for bit in chip_smoke.py); that order against float64 here.

BN_STATS_TOL = 1e-5  # of the largest mean |y| and E[y^2]: chip_smoke.py's bar


def _bn_inputs(rng, r, ci, co, mean3, dtype=torch.bfloat16):
    """Operands in ``dtype`` (the bias fp32) at activation scale, or with
    every column of y at mean 3 standard deviations off zero (the one-pass
    variance's hard case), as ``chip_smoke.py::bn_stats_inputs`` makes them
    on the card."""
    x = rng.randn(r, ci).astype(np.float32)
    if not mean3:
        x = np.maximum(x, 0.0)
    w = (rng.randn(co, ci) * np.sqrt(2.0 / ci)).astype(np.float32)
    b = (3.0 * np.linalg.norm(w, axis=1) if mean3 else 0.1 * rng.randn(co)).astype(np.float32)
    return _t(x).to(dtype), _t(w).to(dtype), _t(b)


@pytest.mark.parametrize("r,ci,co,mean3", [
    (20037, 32, 64, True), (20037, 32, 64, False), (131072 + 5, 64, 32, True), (1000, 256, 48, True),
])
def test_fixed_order_statistics_against_float64(r, ci, co, mean3):
    """The bf16 kernel's statistics, summed in its order (fragment rows,
    the butterfly, the row-tile partials, the finalize lanes; R spans one
    to more than 8 rounds of the 128 finalize lanes and ragged row tiles),
    against float64 statistics of the same y and against the plain
    one-pass form, within ``BN_STATS_TOL`` of the largest mean |y| (mean)
    and E[y^2] (var)."""
    x, w, b = _bn_inputs(np.random.RandomState(r + co), r, ci, co, mean3)
    y, plain_mean, plain_var = dense_bn_stats_torch(x, w, b)
    mean, var = stats_in_kernel_order(y)
    yd = y.double()
    m_bar = BN_STATS_TOL * float(yd.abs().mean(0).max())
    v_bar = BN_STATS_TOL * float((yd * yd).mean(0).max())
    m64, v64 = yd.mean(0), yd.var(0, unbiased=False)
    gaps = {
        "float64": (float((mean.double() - m64).abs().max()),
                    float((var.double() - v64).abs().max())),
        "plain one-pass": (float((mean - plain_mean).abs().max()),
                           float((var - plain_var).abs().max())),
    }
    print(f"R={r} Co={co} mean3={mean3}: " + "; ".join(
        f"{k} mean {m:.3e} ({m / m_bar:.3f} of the bar), var {v:.3e} ({v / v_bar:.3f})"
        for k, (m, v) in gaps.items()))
    for m, v in gaps.values():
        assert m <= m_bar and v <= v_bar


def test_fixed_order_statistics_ignore_rows_past_r():
    """Rows past R add nothing: R rows and the same R rows followed by a
    ragged tile's worth of other values give the statistics of the first
    R only; and the partials are per row tile of ``MMA_ROWS`` rows."""
    rng = np.random.RandomState(3)
    y = _t(rng.randn(3 * MMA_ROWS + 17, 24).astype(np.float32)).bfloat16()
    mean, var = stats_in_kernel_order(y)
    ref_m, ref_v = stats_in_kernel_order(y[: 3 * MMA_ROWS + 17])
    assert torch.equal(mean, ref_m) and torch.equal(var, ref_v)
    yd = y.double()
    assert float((mean.double() - yd.mean(0)).abs().max()) < 1e-6
    assert float((var.double() - yd.var(0, unbiased=False)).abs().max()) < 1e-5


# the 12 distinct (Ci, Co) of the 17 dense_bn_stats calls of a fused train
# step (chip_smoke.py::bn_calls): SA1-SA4's two grouped layers, FP4-FP1
BN_WIDTHS = [(32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
             (256, 512), (768, 256), (384, 256), (320, 256), (256, 128)]


def three_tf32_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` from three TF32 products, as the fp32 route of
    ``csrc/bn_stats.cu`` forms it: ``x_hi w_hi + (x_hi w_lo + x_lo w_hi)``
    (the kernel adds the small products first within each k-step; plain
    ops sum each product whole)."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    return xh @ wh.T + (xh @ wl.T + xl @ wh.T)


@pytest.mark.parametrize("mean3", [False, True])
@pytest.mark.parametrize("ci,co", BN_WIDTHS)
def test_three_tf32_products_meet_the_fp32_bars(ci, co, mean3):
    """The fp32 route's arithmetic in plain ops, at every width of the 17
    calls with R = 1000 rows (a ragged row tile): y from three TF32
    products plus the bias, its statistics in the kernel's order
    (``stats_in_kernel_order``), against JAX's ``dense_bn_stats`` (its
    jnp reference route) on the same numpy inputs: y within 1e-5 of the
    largest |y| and the statistics within ``BN_STATS_TOL`` of their scale,
    chip_smoke.py phase 8's fp32 bars, at activation scale and with every
    column at mean/std 3. One-pass TF32 (``x_hi w_hi`` alone), which the
    kernel does not do, misses the y bar: 16-41x past it on these inputs."""
    x, w, b = _bn_inputs(np.random.RandomState(ci * co), 1000, ci, co, mean3, torch.float32)
    jy, jm, jv = (np.asarray(a) for a in jax_dense_bn_stats(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T), jnp.asarray(b.numpy()),
        out_dtype=jnp.float32, impl="jnp"))
    y = three_tf32_dense(x, w) + b
    mean, var = stats_in_kernel_order(y)
    largest = float(np.abs(jy).max())
    y_err = float(np.abs(y.numpy() - jy).max())
    one_err = float(np.abs((tf32_rna(x) @ tf32_rna(w).T + b).numpy() - jy).max())
    yd = y.double()
    m_bar = BN_STATS_TOL * float(yd.abs().mean(0).max())
    v_bar = BN_STATS_TOL * float((yd * yd).mean(0).max())
    own_m, own_v = yd.mean(0), yd.var(0, unbiased=False)
    print(f"Ci={ci} Co={co} mean3={mean3}: y {y_err / largest:.2e} of the largest |y| "
          f"(bar 1e-5), one TF32 product {one_err / largest:.2e}; mean "
          f"{float((mean.double() - own_m).abs().max()) / m_bar:.3f}, var "
          f"{float((var.double() - own_v).abs().max()) / v_bar:.3f} of their bars")
    assert y_err <= 1e-5 * largest < one_err
    assert float((mean.double() - own_m).abs().max()) <= m_bar
    assert float((var.double() - own_v).abs().max()) <= v_bar
    assert_stats_close((mean.numpy(), var.numpy()), (jm, jv), jy)


@pytest.mark.parametrize("co,bf16,rows,cols", [
    (32, True, 128, 1), (64, True, 128, 1), (128, True, 128, 1), (256, True, 128, 2),
    (512, True, 128, 4), (48, True, 128, 1), (64, False, 128, 1), (48, False, 128, 1),
])
def test_bn_stats_grid_plan(co, bf16, rows, cols):
    """The wrapper's workspace plan matches ``csrc/bn_stats.cu``: one
    tensor-core kernel for both dtypes, 128-row tiles and 32/64/128-column
    tiles (the least that covers Co), so bf16 and fp32 share the plan."""
    assert MMA_ROWS == rows
    assert column_tiles(co) == cols


# ---------------------------------------------------------------- modules in bf16


def jax_train_vjp(jmod, variables, args, g, pick):
    """The JAX module in train mode (:func:`jit_rounded`): its output, updated
    ``batch_stats`` and the gradients of ``sum(pick(out) * g)`` with respect
    to the parameters and the last argument (the features), as
    tests/test_torch_port_train.py's helper of that name computes them."""
    def f(params, feats):
        out, mutated = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *args[:-1], feats, train=True, mutable=["batch_stats"],
        )
        return jnp.sum(pick(out) * g), (out, mutated["batch_stats"]["mlp"])

    (_, (out, stats)), (dparams, dfeats) = jit_rounded(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True), variables["params"], args[-1]
    )
    return out, stats, dparams["mlp"], np.asarray(dfeats)


def sa_case():
    xyz = grid_clouds(20, 2, 256, 3)
    feats = np.random.RandomState(21).randn(2, 256, 5).astype(np.float32)
    g = (np.random.RandomState(23).randn(2, 64, 32) / 128).astype(np.float32)
    jmod = JaxSetAbstraction(64, 0.3, 16, [16, 16, 32], impl="jnp", dtype=jnp.bfloat16)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    variables = perturb_variables(jmod.init(KEY, *args), 22)

    def port(**kw):
        return load_mlp(SetAbstraction(64, 0.3, 16, 3 + 5, [16, 16, 32],
                                       dtype=torch.bfloat16, **kw), variables)

    return jmod, variables, args, g, port, lambda out: out[1]


def fp_case():
    fine, coarse = grid_clouds(30, 2, 256, 3), grid_clouds(31, 2, 64, 3)
    rng = np.random.RandomState(32)
    f_fine = rng.randn(2, 256, 8).astype(np.float32)
    f_coarse = rng.randn(2, 64, 16).astype(np.float32)
    g = (rng.randn(2, 256, 16) / 512).astype(np.float32)
    jmod = JaxFeaturePropagation([32, 16], dtype=jnp.bfloat16)
    args = tuple(jnp.asarray(a) for a in (fine, coarse, f_fine, f_coarse))
    variables = perturb_variables(jmod.init(KEY, *args), 33)

    def port(**kw):
        return load_mlp(FeaturePropagation(8 + 16, [32, 16], dtype=torch.bfloat16, **kw),
                        variables)

    return jmod, variables, args, g, port, lambda out: out


def cosine_and_rel(got: np.ndarray, want: np.ndarray):
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    return cos, np.linalg.norm(got - want) / np.linalg.norm(want)


def pre_bn_bias(path) -> bool:
    """A Dense bias that feeds a train-mode BN: BN takes the batch mean
    out, so its gradient is zero but for rounding."""
    return path[-1] == "bias" and (path[-2].startswith("dense_") or path[-2] == "conv1")


def assert_pre_bn_biases_vanish(grads, bar=5e-2):
    """Each pre-BN bias gradient under ``bar`` of its Dense kernel's
    largest element (measured: up to 1.5e-2, SA1's lifted layer, whose
    bias sums 65536 rows of cotangent)."""
    for path, g in grads.items():
        if pre_bn_bias(path):
            kernel = grads[path[:-1] + ("kernel",)]
            assert np.abs(g).max() <= bar * np.abs(kernel).max(), path


@pytest.mark.parametrize("case", [sa_case, fp_case], ids=["set_abstraction", "feature_propagation"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_module_train_matches_jax(case, fused, flax_two_pass_variance):
    """bf16, ``sr=False``, train mode, the fused statistics on or off in
    both packages. Outputs: 99% of the elements within one ulp and none
    more than 8 apart (flips compound over the stack; measured: at most
    one). Running statistics are fp32 moments of bf16 activations: within
    1e-2 of their scale (measured: 4e-7). Gradients: per parameter,
    cosine above 0.999 and relative L2 error under 3e-2, eight bf16
    ulps: JAX's unfused bf16 backward lands up to 1.5e-2 from the port's,
    the fused one 4e-4. A Dense bias that feeds a BN has a zero gradient
    up to rounding, which JAX's bf16 reduction leaves as large as the BN
    gradients: the port's must stay under 5e-2 of its kernel's."""
    jmod, variables, args, g, make_port, pick = case()
    with jax_fused_bn_stats(fused):
        out, stats, dparams, dfeats = jax_train_vjp(jmod, variables, args, g, pick)
    want = pick(out)
    port = make_port(fused_bn_stats=fused)
    targs = tuple(_t(np.asarray(a)) for a in args)
    feats = targs[-1].requires_grad_()
    got = port(*targs)
    got = got[1] if isinstance(got, tuple) else got
    assert got.dtype == torch.bfloat16
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 8 and np.mean(ulps <= 1) >= 0.99, (ulps.max(), np.mean(ulps <= 1))
    for i, bn in enumerate(port.mlp_bns):
        for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            w = np.asarray(stats[f"bn_{i}"][name])
            assert np.abs(buf.numpy() - w).max() <= 1e-2 * max(1.0, np.abs(w).max()), (i, name)
    (got.float() * _t(g)).sum().backward()
    want_g = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, dparams))
    got_g = traverse_util.flatten_dict(mlp_grads(port))
    want_g[("feats",)], got_g[("feats",)] = dfeats, feats.grad.numpy()
    assert set(got_g) == set(want_g)
    assert_pre_bn_biases_vanish(got_g)
    for path, w in want_g.items():
        if not pre_bn_bias(path):
            cos, rel = cosine_and_rel(got_g[path].ravel(), w.ravel())
            assert cos > 0.999 and rel < 3e-2, (path, cos, rel)


@pytest.mark.parametrize("case", [sa_case, fp_case], ids=["set_abstraction", "feature_propagation"])
def test_bf16_module_eval_matches_jax(case):
    """Eval in bf16: BN folded into bf16 weights in both packages. 99% of
    the outputs within one ulp, none more than 8 apart."""
    jmod, variables, args, _, make_port, pick = case()
    want = pick(jmod.apply(variables, *args, train=False))
    port = make_port().eval().fold_bn_()
    with torch.no_grad():
        got = pick(port(*(_t(np.asarray(a)) for a in args)))
    assert got.dtype == torch.bfloat16
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 8 and np.mean(ulps <= 1) >= 0.99, (ulps.max(), np.mean(ulps <= 1))


# ---------------------------------------------------------------- the model in bf16


@pytest.fixture(scope="module")
def bf16_semseg():
    """The JAX model in bf16 without SR (FPS from index 0, no dropout), its
    perturbed init, and its loss, updated statistics and gradients with the
    fused statistics on, traced with flax's two-pass variance for the
    unfused BNs (the grouped stacks' layer 0 and the head)."""
    compute_stats = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    model = jax_get_model("pointnet2_semseg", num_classes=CLASSES, dropout_rate=0.0,
                          impl="jnp", dtype=jnp.bfloat16)
    variables = perturb_variables(
        model.init({"params": KEY}, jnp.zeros((1, 1024, 9), jnp.float32), train=False), 70
    )
    pts = grid_clouds(71, 2, 1024)
    lbl = np.random.RandomState(72).randint(0, CLASSES, size=(2, 1024))

    def loss_fn(p):
        (logp, _), mutated = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(pts),
            train=True, mutable=["batch_stats"], rngs={"dropout": KEY},
        )
        return jax_losses.segmentation_loss(logp, jnp.asarray(lbl)), mutated["batch_stats"]

    with pytest.MonkeyPatch.context() as mp, jax_fused_bn_stats(True):
        mp.setattr(normalization, "_compute_stats", two_pass)
        (loss, stats), grads = jit_rounded(
            jax.value_and_grad(loss_fn, has_aux=True), variables["params"]
        )
    return model, variables, pts, lbl, float(loss), stats, grads


def _bf16_state(variables, **kw):
    return loop.create_train_state(
        "pointnet2_semseg", CLASSES, device="cpu", dropout_rate=0.0,
        state_dict=jax_import.convert_pointnet2_semseg(variables), dtype=torch.bfloat16,
        **kw,
    )


def flat_grads(model):
    """The port's gradients in the flax layout, as ``{path: array}``."""
    return traverse_util.flatten_dict(flax_grads(model))


def whole_vector_bars(got, want):
    """``(loss-free)`` comparison of two gradient trees: the global cosine
    and relative L2 error over every parameter but the pre-BN biases, and
    the head's last Dense alone (after every BN, so least chaotic)."""
    keep = sorted(p for p in want if not pre_bn_bias(p))
    a = np.concatenate([got[p].ravel() for p in keep])
    b = np.concatenate([want[p].ravel() for p in keep])
    head = cosine_and_rel(got[("conv2", "kernel")].ravel(), want[("conv2", "kernel")].ravel())
    return cosine_and_rel(a, b), head


def test_bf16_model_gradient_spread_under_a_one_ulp_nudge(bf16_semseg):
    """What sets the bars of the bf16 model test: nudging the input
    features by one fp32 ulp moves the port's own bf16 gradient to a
    global cosine under 0.95 (measured 0.75, relative error 0.71): at
    B=2, N=1024 the deep BNs see 128 to 1024 rows, and every bf16 flip
    that moves a batch statistic moves every row behind it. The loss moves
    under 1e-2 (measured 1.5e-3) and the head's last Dense keeps a cosine
    above 0.99 (measured 0.9997)."""
    _, variables, pts, lbl, _, _, _ = bf16_semseg
    nudged = pts.copy()
    nudged[..., 3:] = np.nextafter(nudged[..., 3:], np.float32(2))
    runs = []
    for p in (pts, nudged):
        model = _bf16_state(variables, fused_bn_stats=True).model
        loss = losses.segmentation_loss(model(_t(p)), _t(lbl))
        loss.backward()
        runs.append((float(loss.detach()), flat_grads(model)))
    (cos, _), (head_cos, _) = whole_vector_bars(runs[1][1], runs[0][1])
    assert cos < 0.95 and head_cos > 0.99, (cos, head_cos)
    assert abs(runs[1][0] - runs[0][0]) <= 1e-2 * runs[0][0]


def test_bf16_model_loss_and_gradients_match_jax(bf16_semseg):
    """bf16 with the fused statistics, ``sr=False``, against JAX. The bf16
    gradient of this model at this size moves under a one-ulp nudge of
    its input (test_bf16_model_gradient_spread_under_a_one_ulp_nudge),
    so the bars are those of that spread: the loss within 1e-2 relative
    (measured 2.7e-3); the running statistics within 2e-2 of their scale;
    the head's last Dense at cosine above 0.99 (measured 0.998); every
    parameter's gradient norm within a factor 2 of JAX's; the whole
    vector at cosine above 0.3 (measured 0.46: a sign or scale fault
    lands at 0 or below); the pre-BN biases' under 5e-2 of their
    kernels'."""
    _, variables, pts, lbl, loss, stats, grads = bf16_semseg
    model = _bf16_state(variables, fused_bn_stats=True).model
    got = losses.segmentation_loss(model(_t(pts)), _t(lbl))
    got.backward()
    assert abs(float(got.detach()) - loss) <= 1e-2 * abs(loss)
    after = flax_variables(model)["batch_stats"]
    want_s = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, stats))
    for path, w in traverse_util.flatten_dict(after).items():
        assert np.abs(w - want_s[path]).max() <= 2e-2 * max(1.0, np.abs(want_s[path]).max()), path
    tgrads = flat_grads(model)
    jgrads = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert_pre_bn_biases_vanish(tgrads)
    for path, w in jgrads.items():
        if not pre_bn_bias(path):
            ratio = np.linalg.norm(tgrads[path]) / np.linalg.norm(w)
            assert 0.5 < ratio < 2.0, (path, ratio)
    (cos, _), (head_cos, _) = whole_vector_bars(tgrads, jgrads)
    assert cos > 0.3 and head_cos > 0.99, (cos, head_cos)


def test_bf16_predictor_matches_jax_eval(bf16_semseg):
    """``Predictor`` in bf16 (BN folded into bf16 weights) against the JAX
    model's bf16 eval: the log-probs' 99th-percentile error under 1e-2
    and median under 5e-3 (measured 2.8e-3 and 1.4e-3; bf16 against fp32
    is 2.5e-3 in the port), labels agreeing on 97% of the points (random
    weights leave the classes' log-probs close: JAX's own bf16 and fp32
    agree on 98.6%, the port and JAX on 98.8%)."""
    model, variables, pts, _, _, _, _ = bf16_semseg
    want, _ = jit_rounded(lambda v, p: model.apply(v, p, train=False), variables,
                          jnp.asarray(pts))
    pred = infer.Predictor.from_jax_variables("pointnet2_semseg", variables, CLASSES,
                                              device="cpu", dtype=torch.bfloat16)
    got = pred(pts).numpy()
    err = np.abs(got - np.asarray(want)).max(-1)
    assert np.quantile(err, 0.99) < 1e-2 and np.median(err) < 5e-3, err
    assert np.mean(got.argmax(-1) == np.asarray(want).argmax(-1)) >= 0.97


def test_sr_train_step_draws_its_seeds_from_the_generator(bf16_semseg):
    """bf16 + SR + fused statistics through ``make_train_step``: a finite
    loss; the same generator seed gives the same step, another seed
    another; and without a generator the step raises."""
    _, variables, pts, lbl, _, _, _ = bf16_semseg
    kw = dict(fused_bn_stats=True, sr=True, grouped_sr=True)
    step = loop.make_train_step()
    batch = {"points": pts, "label": lbl}
    runs = []
    for seed in (5, 5, 6):
        state = _bf16_state(variables, **kw)
        m = step(state, batch, torch.Generator().manual_seed(seed))
        runs.append((float(m["loss"]), state.model.fp1.mlp_bns[0].running_mean.clone()))
    assert all(np.isfinite(loss) for loss, _ in runs)
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], runs[2][1])
    with pytest.raises(ValueError, match="generator"):
        step(_bf16_state(variables, **kw), batch)
    state = recompute_batch_stats(_bf16_state(variables, **kw), [batch], num_batches=1)
    assert all(torch.isfinite(b).all() for b in state.model.buffers())


def test_precise_bn_matches_jax(bf16_semseg, flax_two_pass_variance):
    """Pooled statistics over two batches, FPS from index 0, against JAX's
    on the same weights and batches, in fp32 with flax's two-pass
    variance: the pooling is the same in every dtype, and in bf16 the
    batch statistics themselves move with any rounding flip (above). The
    batch statistic is recovered from the running average, which scales
    its rounding by 10: within 1e-3 relative and 1e-5 absolute. The
    parameters do not move, and a third batch is not read."""
    _, variables, pts, _, _, _, _ = bf16_semseg
    model = jax_get_model("pointnet2_semseg", num_classes=CLASSES, dropout_rate=0.0,
                          impl="jnp")
    batches = [{"points": pts}, {"points": grid_clouds(73, 2, 1024)}]
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None, tx=None, apply_fn=model.apply,
    )
    want = jax_precise_bn(jstate, batches, num_batches=2).batch_stats
    state = loop.create_train_state(
        "pointnet2_semseg", CLASSES, device="cpu", dropout_rate=0.0,
        state_dict=jax_import.convert_pointnet2_semseg(variables),
    )
    params = [p.detach().clone() for p in state.model.parameters()]
    third = {"points": grid_clouds(74, 2, 1024)}
    assert recompute_batch_stats(state, batches + [third], num_batches=2) is state
    assert all(torch.equal(a, b) for a, b in zip(params, state.model.parameters()))
    got = flax_variables(state.model)["batch_stats"]
    want = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    for path, g in traverse_util.flatten_dict(got).items():
        np.testing.assert_allclose(g, want[path], rtol=1e-3, atol=1e-5, err_msg=str(path))


# ---------------------------------------------------------------- precision flags


@pytest.mark.parametrize(
    "model_name",
    ["pointnet2_semseg", "pointnet2_cls_ssg", "pointnet2_cls_msg", "pointnet_cls", "pointnet_seg"],
)
def test_model_precision_kwargs_match_jax(model_name):
    def named(kw):
        """dtypes by name: ``torch.bfloat16`` and ``jnp.bfloat16`` alike."""
        return {k: v if isinstance(v, bool) else
                str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else np.dtype(v).name
                for k, v in kw.items()}

    for bf16 in (False, True):
        for grouped in (False, True):
            for sr in (False, True):
                args = types.SimpleNamespace(bf16=bf16, bf16_grouped=grouped, bf16_sr=sr)
                try:
                    want = jax_precision_kwargs(model_name, args)
                except SystemExit:
                    with pytest.raises(ValueError, match="bf16_grouped"):
                        model_precision_kwargs(model_name, bf16=bf16, bf16_grouped=grouped,
                                               bf16_sr=sr)
                    continue
                got = model_precision_kwargs(model_name, bf16=bf16, bf16_grouped=grouped,
                                             bf16_sr=sr)
                assert named(got) == named(want), (bf16, grouped, sr)
