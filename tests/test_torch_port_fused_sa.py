"""The PyTorch port's voxel grid, grid ball-query route and fused eval set
abstraction (``impl="fused"``) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its Pallas kernels with ``interpret=True``, as
``tests/test_kernels.py`` does; the port runs its plain PyTorch versions
(what ``impl="auto"`` resolves to for a CPU tensor). The CUDA kernels run
only on the card, where ``chip_smoke.py`` holds each of them against the
same plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointnet12_tpu.kernels import ballquery_grid as jax_grid
from pointnet12_tpu.kernels import fused_sa_eval as jax_fused
from pointnet12_tpu.models import get_model as jax_get_model
from pointnet12_tpu.nn import set_abstraction as jax_sa
from pointnet12_tpu.ops import ballquery as jax_ballquery
from pointnet12_tpu.ops.gather import index_points as jax_index_points
from pointnet12_tpu.utils import torch_import

from pointnet12_tpu_torch.infer import Predictor
from pointnet12_tpu_torch.kernels import selfcheck
from pointnet12_tpu_torch.kernels.fused_sa_cuda import (
    fused_sa_eval_dense_cuda, fused_sa_eval_grid_cuda,
)
from pointnet12_tpu_torch.kernels import grid_cuda
from pointnet12_tpu_torch.kernels.grid_cuda import ballquery_grid_cuda, grid_prep_cuda
from pointnet12_tpu_torch.models import get_model
from pointnet12_tpu_torch.nn import set_abstraction
from pointnet12_tpu_torch.ops import ballquery, fused_sa, grid
from pointnet12_tpu_torch.ops.gather import index_points
from pointnet12_tpu_torch.train.losses import segmentation_loss
from pointnet12_tpu_torch.utils.jax_import import convert_shared_mlp
from tests.test_torch_port_ops import _t, assert_quantiles, perturb_variables

H = grid.G**3


def _clouds(seed, b, n, clustered):
    """(b, n, 3) uniform clouds; with ``clustered`` the last cloud has 3/4
    of its points in one corner and 1/8 of them on a single spot (one
    overloaded cell, key ties for the stable sort)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    if clustered:
        xyz[-1, : 3 * n // 4] = 0.05 * rng.uniform(size=(3 * n // 4, 3))
        xyz[-1, : n // 8] = 0.31
    return xyz


def _prep_clouds(seed, b, n, kind):
    """The clouds the grid prep is held on: ``False`` uniform, ``True``
    clustered (:func:`_clouds`); ``"lattice"`` on the 1/64 grid with both
    corners of the unit cube, so the cells are exactly 1/8 wide and every
    coordinate that is a multiple of 1/8 sits on a cell face;
    ``"degenerate"`` every point equal (extent 0: the cell size is the
    radius); ``"one_cell"`` inside a box narrower than the radius."""
    if kind in (False, True):
        return _clouds(seed, b, n, kind)
    rng = np.random.RandomState(seed)
    if kind == "lattice":
        xyz = rng.randint(0, 65, size=(b, n, 3)) / 64.0
        xyz[:, 0], xyz[:, 1] = 0.0, 1.0
    elif kind == "degenerate":
        xyz = np.full((b, n, 3), 0.3)
    else:
        xyz = 0.2 + 0.05 * rng.uniform(size=(b, n, 3))
    return xyz.astype(np.float32)


def _centers(xyz, s, seed):
    """s distinct points of each cloud, as FPS centers are."""
    rng = np.random.RandomState(seed)
    sel = np.stack([rng.choice(xyz.shape[1], s, replace=False) for _ in xyz])
    return np.take_along_axis(xyz, sel[..., None], axis=1)


def _jax_grid_prep(radius, xyz, centers):
    """JAX's grid_prep (cell offsets interpreted), with the sorted keys and
    the offsets it makes captured on their way into and out of
    ``_cell_offsets``."""
    seen = {}
    original = jax_grid._cell_offsets

    def capture(skey, **kw):
        seen["skey"] = np.asarray(skey)
        seen["offsets"] = np.asarray(original(skey, **kw))
        return seen["offsets"]

    jax_grid._cell_offsets = capture
    try:
        out = jax_grid.grid_prep(radius, jnp.asarray(xyz), jnp.asarray(centers),
                                 interpret=True)
    finally:
        jax_grid._cell_offsets = original
    return out, seen


# ---------------------------------------------------------------- grid prep


@pytest.mark.parametrize("n,s,radius,clustered", [
    (1024, 256, 0.1, False), (1024, 256, 0.1, True), (2048, 128, 0.3, True),
    (1024, 256, 0.1, "lattice"), (1024, 256, 0.1, "degenerate"), (1024, 256, 0.1, "one_cell"),
])
def test_grid_prep_equals_jax(n, s, radius, clustered):
    """The plain grid prep against JAX's, on the clouds of
    :func:`_prep_clouds` (``clustered`` names the kind)."""
    xyz = _prep_clouds(40, 2, n, clustered)
    centers = _centers(xyz, s, 41)
    want, seen = _jax_grid_prep(radius, xyz, centers)
    got = grid.grid_prep(radius, _t(xyz), _t(centers))
    np.testing.assert_array_equal(got["perm"].numpy(), np.asarray(want["perm"]))
    np.testing.assert_array_equal(got["qperm"].numpy(), np.asarray(want["qperm"]))
    np.testing.assert_array_equal(got["skey"].numpy(), seen["skey"])
    np.testing.assert_array_equal(got["offsets"].numpy(), seen["offsets"][:, : H + 1])
    assert got["offsets"].dtype == torch.int32 and got["offsets"].shape == (2, H + 1)
    # the sorted centers are JAX's, so their keys sort them
    sq = np.stack(want["sq_xyz"], axis=-1)
    np.testing.assert_array_equal(index_points(_t(centers), got["qperm"]).numpy(), sq)
    assert (np.diff(got["sqkey"].numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("clustered", [False, True])
def test_cell_offsets_plain_version_equals_jax_kernel(clustered):
    xyz = _clouds(42, 2, 1024, clustered)
    skey = grid.grid_prep(0.1, _t(xyz), _t(xyz[:, :128]))["skey"]
    want = np.asarray(jax_grid._cell_offsets(jnp.asarray(skey.numpy()), interpret=True))
    got = grid.cell_offsets_torch(skey, H)
    np.testing.assert_array_equal(got.numpy(), want[:, : H + 1])
    assert got[:, 0].eq(0).all() and got[:, -1].eq(1024).all()


@pytest.mark.parametrize("clustered", [False, True])
def test_grid_prep_carries_the_grid_kernels_search(clustered):
    """The search of ``csrc/neighbours.cuh::first_k_grid``, written out over
    the prep's outputs: the 27 cells around each sorted center's cell,
    read as ranges of sorted positions through the offsets and mapped to
    original indices through ``perm``, then the K smallest in radius. It
    must give the plain ball query's rows: the prep holds all the kernel
    needs, clustered clouds included."""
    n, s, k, radius = 1024, 128, 16, 0.15
    xyz = _clouds(43, 2, n, clustered)
    centers = _centers(xyz, s, 44)
    g = grid.grid_prep(radius, _t(xyz), _t(centers))
    want = ballquery.ballquery_torch(radius, k, _t(xyz), _t(centers)).numpy()
    r2 = np.float32(radius * radius)
    G = grid.G
    got = np.empty_like(want)
    for b in range(2):
        for j in range(s):
            center, cell = g["qperm"][b, j].item(), g["sqkey"][b, j].item()
            qx, qy, qz = cell // (G * G), (cell // G) % G, cell % G
            found = []
            for x in range(max(qx - 1, 0), min(qx + 1, G - 1) + 1):
                for y in range(max(qy - 1, 0), min(qy + 1, G - 1) + 1):
                    base = (x * G + y) * G
                    lo = g["offsets"][b, base + max(qz - 1, 0)].item()
                    hi = g["offsets"][b, base + min(qz + 1, G - 1) + 1].item()
                    idx = g["perm"][b, lo:hi].numpy()
                    d2 = ((xyz[b, idx] - centers[b, center]) ** 2).sum(-1)
                    found.extend(idx[d2 <= r2].tolist())
            row = sorted(found)[:k] or [n]
            got[b, center] = row + [row[0]] * (k - len(row))
    ok = selfcheck.boundary_ok_mask(radius, _t(xyz), _t(centers)).numpy()
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(got[ok], want[ok])


# ---------------------------------------------------------------- the grid ball query's search
# csrc/ballquery_grid.cu at a plan (kernels/grid_cuda.py::grid_plan), written
# out in plain ops by first_k_grid_in_plan_order; the card holds the kernel to
# the contract bit for bit (chip_smoke.py).

# (run, capacity, threshold, tile) and radius: the default plan; lists that
# overflow at r=0.3 (~116 hits a center) and a union streamed 64 points at a
# time; a threshold of one point in a center's own cell
GRID_PLANS = {"default": (None, 0.1), "overflow": ((32, 64, grid_cuda.NO_THRESHOLD, 64), 0.3),
              "threshold": ((16, 48, 1, 256), 0.1)}


def _lattice_clouds(seed, b, n, clustered):
    """Clouds on the 1/64 grid, where the direct and the expansion form of
    d2 are both exact, so JAX's kernel and the direct form agree on every
    row; with ``clustered`` the last cloud has 3/4 of its points in the
    corner box [0, 3/64]^3 and 1/8 of them on one lattice point."""
    rng = np.random.RandomState(seed)
    xyz = rng.randint(0, 65, size=(b, n, 3)) / 64.0
    if clustered:
        xyz[-1, : 3 * n // 4] = rng.randint(0, 4, size=(3 * n // 4, 3)) / 64.0
        xyz[-1, : n // 8] = 20 / 64
    return xyz.astype(np.float32)


def _grid_search(xyz, centers, radius, k, given):
    """The search in plan order at the plan ``given`` (None: the default),
    its paths, and the paths of ``center_paths`` (what chip_smoke.py logs on
    the card) on the same grid."""
    b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
    plan = grid_cuda.grid_plan(b, n, s, k, *(given or ()))
    g = grid.grid_prep(radius, _t(xyz), _t(centers))
    r2 = float(np.float32(radius * radius))
    idx, path = grid_cuda.first_k_grid_in_plan_order(_t(xyz), _t(centers), r2, k, g, plan)
    d = centers[:, :, None, :] - xyz[:, None, :, :]
    hits = _t(((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
               <= np.float32(r2)).sum(-1))
    assert torch.equal(grid_cuda.center_paths(g, hits, plan), path)
    return idx, path


@pytest.mark.parametrize("plan_name", list(GRID_PLANS))
@pytest.mark.parametrize("clustered", [False, True])
def test_grid_search_in_plan_order_equals_jax_kernel(clustered, plan_name):
    """The new search at each plan against JAX's ``ballquery_grid``
    (interpreted), every row equal, on 1/64-grid clouds (B=2, N=1024,
    S=128, K=16); the plans send centers down each path (the list, the
    list compacted over its capacity, the scan over the threshold)."""
    xyz = _lattice_clouds(50, 2, 1024, clustered)
    centers = _centers(xyz, 128, 51)
    given, radius = GRID_PLANS[plan_name]
    want = np.asarray(jax_grid.ballquery_grid(radius, 16, jnp.asarray(xyz),
                                              jnp.asarray(centers), interpret=True))
    idx, path = _grid_search(xyz, centers, radius, 16, given)
    np.testing.assert_array_equal(idx.numpy(), want)
    counts = torch.bincount(path.flatten().long(), minlength=3).tolist()
    print(f"clustered={clustered} {plan_name}: centers by path (list, over the threshold, "
          f"over the capacity) {counts}")
    assert counts[grid_cuda.LIST] > 0
    if plan_name == "overflow":
        assert counts[grid_cuda.OVER_CAPACITY] > 0
    if plan_name == "threshold" or clustered and plan_name == "default":
        assert counts[grid_cuda.OVER_THRESHOLD] > 0


@pytest.mark.parametrize("plan_name", list(GRID_PLANS))
@pytest.mark.parametrize("clustered", [False, True])
def test_grid_search_in_plan_order_equals_plain_ball_query(clustered, plan_name):
    """On continuous clouds (:func:`_clouds`: uniform, and a corner of 3/4
    of the points with 1/8 on one spot) the search at each plan gives the
    plain ball query's rows off the radius boundary, in the style of
    :func:`test_grid_prep_carries_the_grid_kernels_search`."""
    xyz = _clouds(52, 2, 1024, clustered)
    centers = _centers(xyz, 128, 53)
    given, radius = GRID_PLANS[plan_name]
    radius += 0.05
    idx, _ = _grid_search(xyz, centers, radius, 16, given)
    want = ballquery.ballquery_torch(radius, 16, _t(xyz), _t(centers)).numpy()
    ok = selfcheck.boundary_ok_mask(radius, _t(xyz), _t(centers)).numpy()
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(idx.numpy()[ok], want[ok])


@pytest.mark.parametrize("b,n,s,k,given,want", [
    # Path G's SA1: 16 x 64 runs of 16 centers
    (16, 8192, 1024, 32, {}, (16, 64, 128, 2048)),
    # few centers: runs halved down to a warp's worth
    (1, 32768, 8192, 32, {}, (16, 64, 512, 2048)),
    (2, 1024, 128, 16, {}, (8, 64, 16, 2048)),
    # K = 128: lists of twice K
    (16, 8192, 1024, 128, {}, (16, 256, 128, 2048)),
    (16, 8192, 1024, 32, {"run": 64, "capacity": 64, "threshold": 0, "tile": 32},
     (64, 64, 0, 32)),
])
def test_grid_plan(b, n, s, k, given, want):
    """``grid_plan``'s defaults and overrides, and its shared memory as
    ``csrc/ballquery_grid.cu`` computes it; a plan past 227 KB, with a
    capacity under K or not a multiple of 4, or with an empty run or tile
    is refused."""
    plan = grid_cuda.grid_plan(b, n, s, k, **given)
    assert plan[:4] == want
    run, capacity, _, tile = want
    assert plan.shared_bytes == 16 * (tile + run) + 4 * (
        run * (capacity + 34) + 8 * capacity + 4 * grid.G**2 + 1 + grid.G**3 + 1)
    with pytest.raises(ValueError, match="shared memory"):
        grid_cuda.grid_plan(b, n, s, k, tile=16384)
    for key, bad in (("run", 0), ("capacity", k - 4), ("capacity", k + 2), ("tile", 0)):
        with pytest.raises(ValueError, match=key):
            grid_cuda.grid_plan(b, n, s, k, **{key: bad})


# ---------------------------------------------------------------- routes


def test_routes_equal_jax():
    shapes = [(n, s) for n in (64, 256, 1024, 1536, 2048, 4096, 8064, 8192, 8200, 8320,
                                16384)
              for s in (1, 8, 16, 64, 128, 256, 1000, 1024)]
    for n, s in shapes:
        assert (ballquery._route(n, s) == "grid") == (jax_ballquery._route(n, s) == "grid"), (n, s)
        for impl in ("fused", "auto", "torch"):
            for mlp in ((32,), (32, 64), (32, 32, 64)):
                for train in (False, True):
                    args = (impl, n, s, mlp, train)
                    assert set_abstraction._fused_eval_ok(*args) == jax_sa._fused_eval_ok(*args), args
    assert ballquery._route(8192, 1024) == "grid"
    assert ballquery._route(8192, 1000) == ballquery._route(4096, 1024) == "scan"
    assert ballquery._route(1024, 256) == "scan"
    # the fused layer's kernel choice, nn/mlp.py:572
    assert fused_sa.use_grid(4096, 1024) and fused_sa.use_grid(2048, 128)
    assert not fused_sa.use_grid(1024, 256) and not fused_sa.use_grid(4096, 1000)


# ---------------------------------------------------------------- fused layer


def _layer_inputs(rng, b, n, s, c1, mlp, xyz):
    """tests/test_kernels.py:337-352's operands: centers drawn from the
    cloud, lifted rows w and t, the folded (kernel (Ci, Co), bias) chain."""
    sel = rng.choice(n, size=(b, s), replace=False)
    new_xyz = np.asarray(jax_index_points(jnp.asarray(xyz), jnp.asarray(sel, jnp.int32)))
    w = rng.randn(b, n, c1).astype(np.float32) * 0.3
    t = rng.randn(b, s, c1).astype(np.float32) * 0.1
    layers, ci = [], c1
    for co in mlp:
        layers.append((rng.randn(ci, co).astype(np.float32) * 0.2,
                       rng.randn(co).astype(np.float32) * 0.1))
        ci = co
    return new_xyz, w, t, layers


def _fused_pair(jax_fn, radius, k, xyz, new_xyz, w, t, layers):
    want = np.asarray(jax_fn(
        radius, k, jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(w),
        jnp.asarray(t), tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in layers),
        interpret=True,
    ))
    got = fused_sa.fused_sa_eval_torch(
        radius, k, _t(xyz), _t(new_xyz), _t(w), _t(t), [(_t(a), _t(b)) for a, b in layers]
    ).numpy()
    ok = selfcheck.boundary_ok_mask(radius, _t(xyz), _t(new_xyz)).numpy()
    assert got.shape == want.shape and ok.mean() > 0.5
    return np.abs(got - want)[ok].max()


@pytest.mark.parametrize("n,s,k,c1,mlp", [
    (256, 64, 16, 32, (32, 64)), (1024, 256, 32, 64, (64, 128)), (64, 16, 32, 256, (256, 512)),
])
def test_fused_layer_matches_jax_dense_kernel(n, s, k, c1, mlp):
    """The plain version against ``fused_sa_eval_dense`` (interpreted) at
    the shapes of tests/test_kernels.py:321-327, off the radius boundary:
    at most 2.1e-7 measured here (0 at the two larger shapes), against the
    5e-4 bar of those tests."""
    rng = np.random.RandomState(11)
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32)
    args = _layer_inputs(rng, 2, n, s, c1, mlp, xyz)
    err = _fused_pair(jax_fused.fused_sa_eval_dense, 0.3, k, xyz, *args)
    assert err < 5e-4, err


def test_fused_layer_matches_jax_grid_kernel():
    """Against ``fused_sa_eval_grid`` (interpreted) on the inputs of
    tests/test_kernels.py:403-418, whose second cloud piles 3/4 of its
    points into one corner: at most 1.2e-7 measured here (bar 5e-4)."""
    rng = np.random.RandomState(5)
    b, n, s, k, c1 = 2, 512, 128, 8, 16
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    xyz[1, : 3 * n // 4] = 0.05 * rng.uniform(size=(3 * n // 4, 3))
    new_xyz, w, t, _ = _layer_inputs(rng, b, n, s, c1, (), xyz)
    layers = [(rng.randn(c1, 16).astype(np.float32) * 0.2, rng.randn(16).astype(np.float32) * 0.1),
              (rng.randn(16, 32).astype(np.float32) * 0.2, rng.randn(32).astype(np.float32) * 0.1)]
    err = _fused_pair(jax_fused.fused_sa_eval_grid, 0.25, k, xyz, new_xyz, w, t, layers)
    assert err < 5e-4, err


def test_fused_layer_empty_center_gathers_the_clamped_sentinel():
    """A center with no point in radius: the ball query pads with N, which
    gathers w[N - 1] (index_points clamps), as ``fused_sa_eval_ref`` does;
    the port's CUDA kernels do the same (chip_smoke.py holds them to this
    plain version on such centers). JAX's own fused kernels gather a zero
    row there instead (ROADMAP Queue 3)."""
    rng = np.random.RandomState(12)
    n, c1 = 64, 8
    xyz = rng.uniform(size=(1, n, 3)).astype(np.float32)
    centers = np.concatenate([xyz[:, :7], np.full((1, 1, 3), 10.0, np.float32)], axis=1)
    w = rng.randn(1, n, c1).astype(np.float32)
    t = rng.randn(1, 8, c1).astype(np.float32)
    layers = [(rng.randn(c1, 16).astype(np.float32), rng.randn(16).astype(np.float32)),
              (rng.randn(16, 4).astype(np.float32), rng.randn(4).astype(np.float32))]
    tl = [(_t(a), _t(b)) for a, b in layers]
    got = fused_sa.fused_sa_eval_torch(0.2, 4, _t(xyz), _t(centers), _t(w), _t(t), tl)
    h = torch.relu(_t(w)[0, n - 1] - _t(t)[0, 7])
    want = torch.relu(torch.relu(h @ tl[0][0] + tl[0][1]) @ tl[1][0] + tl[1][1])
    np.testing.assert_allclose(got[0, 7].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    ref = np.asarray(jax_fused.fused_sa_eval_ref(
        0.2, 4, jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(w), jnp.asarray(t),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in layers),
    ))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("n,npoint,radius,d,mlp,grouped_dtype", [
    (1024, 256, 0.2, 6, [16, 16, 32], None),  # dense kernel
    # the grid kernel at the shapes of SA1 in the model test below (B=2,
    # N=2048), which then reuses the JAX kernel's trace
    (2048, 1024, 0.1, 9, [32, 32, 64], None),
    (2048, 1024, 0.1, 9, [32, 32, 64], "bf16"),
])
def test_fused_set_abstraction_matches_jax(n, npoint, radius, d, mlp, grouped_dtype):
    """``SetAbstraction(impl="fused")`` in eval against JAX's, the same
    weights with non-trivial BN statistics through the port's converter;
    with a bf16 grouped stack the fp32 fused output is cast to bf16 (then
    back to the layer's fp32), as nn/mlp.py:585 does."""
    rng = np.random.RandomState(50)
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32)
    feats = rng.randn(2, n, d).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if grouped_dtype else (None, None)
    jmod = jax_sa.SetAbstraction(npoint, radius, 32, mlp, impl="fused", grouped_dtype=jdt)
    assert jax_sa._fused_eval_ok("fused", n, npoint, mlp, False)
    port = set_abstraction.SetAbstraction(npoint, radius, 32, 3 + d, mlp, impl="fused",
                                          grouped_dtype=tdt)
    # JAX's variables from the port's initial weights (sparing JAX's init),
    # with non-trivial BN statistics; the port then reads them back
    torch.manual_seed(52)
    sd = {f"sa.{k}": v.numpy() for k, v in port.state_dict().items()}
    params, stats = torch_import._sa(sd, "sa", len(mlp))
    variables = perturb_variables({"params": {"mlp": params}, "batch_stats": {"mlp": stats}}, 51)
    want_xyz, want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats))

    port.load_state_dict({
        k: _t(v) for k, v in convert_shared_mlp(
            variables["params"]["mlp"], variables["batch_stats"]["mlp"]
        ).items()
    })
    port.eval().fold_bn_()
    with torch.no_grad():
        got_xyz, got = port(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, npoint, mlp[-1]) and got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    assert_quantiles(got.numpy(), want)
    if grouped_dtype:
        # bf16 values: equal but where fp32 sums straddle a rounding point
        ulp = np.abs(want) * 2.0**-7 + 1e-30
        assert (np.abs(got.numpy() - want) <= ulp).all()


def test_fused_and_unfused_set_abstraction_share_parameters():
    """One state_dict serves both routes; in eval they agree (the plain
    versions on the CPU); in train mode impl="fused" runs the unfused
    train path and gives the same output."""
    torch.manual_seed(0)
    unfused = set_abstraction.SetAbstraction(128, 0.2, 16, 9, [16, 16, 32])
    fused = set_abstraction.SetAbstraction(128, 0.2, 16, 9, [16, 16, 32], impl="fused")
    assert set(fused.state_dict()) == set(unfused.state_dict())
    fused.load_state_dict(unfused.state_dict())
    assert fused.impl == "auto" and fused.fused
    xyz, feats = torch.rand(2, 1024, 3), torch.randn(2, 1024, 6)
    out_u, out_f = unfused(xyz, feats), fused(xyz, feats)
    torch.testing.assert_close(out_f, out_u, rtol=0, atol=0)
    unfused.eval().fold_bn_()
    fused.eval().fold_bn_()
    with torch.no_grad():
        torch.testing.assert_close(fused(xyz, feats)[1], unfused(xyz, feats)[1],
                                   rtol=1e-5, atol=1e-5)
    # only the fused layer folds the fused op's fp32 layers
    assert unfused.fused_layers is None and len(fused.fused_layers) == 2
    # back in train mode the fused layer drops its folds and runs the
    # unfused train path again
    fused.train()
    unfused.train()
    with pytest.raises(RuntimeError, match="fold_bn_"):
        fused._fused_eval(xyz, feats, xyz[:, :8])
    torch.testing.assert_close(fused(xyz, feats), unfused(xyz, feats), rtol=0, atol=0)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def fused_semseg():
    """JAX's ``impl="fused"`` model and variables made from the port's
    initial weights (sparing JAX's init) with non-trivial BN statistics."""
    torch.manual_seed(7)
    sd = {k: v.numpy() for k, v in get_model("pointnet2_semseg").state_dict().items()}
    variables = perturb_variables(torch_import.convert_pointnet2_semseg(sd), 8)
    return jax_get_model("pointnet2_semseg", num_classes=13, impl="fused"), variables


def _grid_points(seed, b, n):
    """Clouds whose coordinates sit on a 1/64 grid, where the direct and
    expansion distance forms are both exact."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(size=(b, n, 9)).astype(np.float32)
    pts[..., :3] = rng.randint(0, 64, size=(b, n, 3)) / 64.0
    return pts


def test_fused_model_matches_jax_fused_model(fused_semseg):
    """``PointNet2SemSeg(impl="fused")`` against JAX's ``impl="fused"``
    model at B=2, N=2048 (SA1 on the grid kernel, SA2-SA4 dense), within
    the bars of tests/test_parity.py:128-132; and the fused Predictor
    against the ``impl="auto"`` one on the same weights."""
    model, variables = fused_semseg
    pts = _grid_points(9, 2, 2048)
    # eager, so SA1 reuses the grid kernel traced by the module test above
    want = np.asarray(model.apply(variables, jnp.asarray(pts), train=False)[0])
    port = Predictor.from_jax_variables("pointnet2_semseg", variables, num_classes=13,
                                        device="cpu", impl="fused")
    assert port.model.sa1.fused and port.model.fp1.impl == "auto"
    got = port(pts)
    assert got.shape == (2, 2048, 13) and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max(axis=-1)
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.median(err) < 1e-4, np.median(err)
    auto = Predictor.from_jax_variables("pointnet2_semseg", variables, num_classes=13,
                                        device="cpu")
    err = (got - auto(pts)).abs().amax(-1).numpy()
    assert np.quantile(err, 0.99) < 1e-3 and np.median(err) < 1e-4


def test_fused_model_in_train_mode_runs_the_unfused_train_path():
    torch.manual_seed(1)
    auto = get_model("pointnet2_semseg", num_classes=13, dropout_rate=0.0)
    fused = get_model("pointnet2_semseg", num_classes=13, dropout_rate=0.0, impl="fused")
    fused.load_state_dict(auto.state_dict())
    pts = torch.from_numpy(_grid_points(10, 2, 1024))
    labels = torch.randint(0, 13, (2, 1024), generator=torch.Generator().manual_seed(2))
    losses = [float(segmentation_loss(m(pts), labels).detach()) for m in (auto, fused)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


# ---------------------------------------------------------------- wrappers


@pytest.mark.parametrize("wrapper", ["grid_prep", "ballquery_grid", "dense", "grid"])
def test_new_kernel_wrappers_refuse_cpu_tensors(wrapper):
    xyz = torch.rand(1, 256, 3)
    centers = xyz[:, :128].contiguous()
    w, t = torch.rand(1, 256, 8), torch.rand(1, 128, 8)
    layers = [(torch.rand(8, 8), torch.rand(8)), (torch.rand(8, 4), torch.rand(4))]
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "grid_prep":
            grid_prep_cuda(0.2, xyz, centers)
        elif wrapper == "ballquery_grid":
            ballquery_grid_cuda(0.2, 8, xyz, centers)
        else:
            fn = fused_sa_eval_dense_cuda if wrapper == "dense" else fused_sa_eval_grid_cuda
            fn(0.2, 8, xyz, centers, w, t, layers)
    assert (grid_prep_cuda.launches == ballquery_grid_cuda.launches
            == fused_sa_eval_dense_cuda.launches == fused_sa_eval_grid_cuda.launches == 0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sa.fused_sa_eval(0.2, 8, xyz, centers, w, t, layers, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        grid.grid_prep(0.2, xyz, centers, impl="cuda")


# ---------------------------------------------------------------- the kernel's three TF32 products
# csrc/fused_sa.cu does each product of the chain as three TF32 products,
# a_hi b_hi + (a_hi b_lo + a_lo b_hi) with hi = cvt.rna.tf32(v) and
# lo = cvt.rna.tf32(v - hi). The CUDA kernel runs only on the card; its
# arithmetic is modelled here in plain PyTorch and held to JAX.

FUSED_ATOL = 5e-4  # the fused layers' bar, tests/test_kernels.py:321-426 and chip_smoke.py


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite fp32 values: the 13 low bits rounded
    off to nearest, ties away from zero, as ``csrc/fused_sa.cu::tf32_rna``
    computes it (the sign-magnitude bits plus half an ulp, then masked)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """``(hi, lo)`` of the kernel: ``hi = rna(v)``, ``lo = rna(v - hi)``."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def three_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel sums it: the large product, then the two
    small ones summed apart and added at the end (``a_lo b_lo`` dropped)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return ah @ bh + (ah @ bl + al @ bh)


def fused_layer_model(radius, nsample, xyz, new_xyz, w, t, layers, matmul):
    """``ops/fused_sa.py::fused_sa_eval_torch`` with its products by
    ``matmul``."""
    idx = ballquery.ballquery_torch(radius, nsample, xyz, new_xyz)
    acts = torch.relu(index_points(w, idx) - t[:, :, None, :])
    for i, (kernel, bias) in enumerate(layers):
        acts = matmul(acts, kernel) + bias
        if i < len(layers) - 1:
            acts = torch.relu(acts)
    return torch.relu(acts.amax(dim=2))


def test_tf32_rounding_is_to_nearest_ties_away():
    """The bit arithmetic picks the nearer of the two TF32 neighbours of v,
    the one away from zero on a tie (float64 decides), and leaves an
    ``hi`` whose 13 low bits are zero and a ``v - hi`` exact in fp32."""
    rng = np.random.RandomState(0)
    v = (rng.randn(20000) * np.exp2(rng.randint(-20, 20, 20000))).astype(np.float32)
    bits = v.view(np.int32)
    ties = (bits[:2000] & ~0x1FFF) | 0x1000  # exactly half-way
    v = np.concatenate([v, ties.view(np.float32), -ties.view(np.float32)])
    bits = v.view(np.int32)
    lower = (bits & ~0x1FFF).view(np.float32).astype(np.float64)  # toward zero
    upper = ((bits & ~0x1FFF) + 0x2000).view(np.float32).astype(np.float64)
    d_lo = np.abs(v.astype(np.float64) - lower)
    d_up = np.abs(upper - v.astype(np.float64))
    want = np.where(d_up <= d_lo, upper, lower)
    hi, lo = split_tf32(torch.from_numpy(v))
    assert np.array_equal(hi.numpy().astype(np.float64), want)
    assert not (hi.numpy().view(np.int32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.int32) & 0x1FFF).any()
    diff = torch.from_numpy(v) - hi
    assert np.array_equal(diff.numpy().astype(np.float64),
                          v.astype(np.float64) - hi.numpy().astype(np.float64))
    assert (d_up == d_lo).sum() >= 4000  # the ties are there, both signs


def _chain_inputs(rng, b, n, s, c1, mlp):
    """A unit-cube cloud, centers drawn from it, lifted rows w and t, and
    the folded (kernel (Ci, Co), bias) chain, He-scaled as a trained
    layer's activations would be."""
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    sel = np.stack([rng.choice(n, s, replace=False) for _ in range(b)])
    new_xyz = np.take_along_axis(xyz, sel[..., None], axis=1)
    w = rng.randn(b, n, c1).astype(np.float32)
    t = rng.randn(b, s, c1).astype(np.float32) * 0.3
    layers, ci = [], c1
    for co in mlp:
        layers.append(((rng.randn(ci, co) * np.sqrt(2.0 / ci)).astype(np.float32),
                       (rng.randn(co) * 0.1).astype(np.float32)))
        ci = co
    return xyz, new_xyz, w, t, layers


@pytest.mark.parametrize("level,n,s,radius,c1,mlp", [
    (1, 512, 128, 0.2, 32, (32, 64)),
    (2, 256, 64, 0.3, 64, (64, 128)),
    (3, 128, 32, 0.4, 128, (128, 256)),
    (4, 64, 16, 0.8, 256, (256, 512)),
])
def test_three_tf32_chain_matches_jax_reference(level, n, s, radius, c1, mlp):
    """A fused layer at the chain widths of SA``level`` (K=32, B=2), its
    products as three TF32 products, against JAX's ``fused_sa_eval_ref``
    on the same numpy inputs, off the radius boundary: within
    ``FUSED_ATOL``, and as close as the port's exact fp32 plain version
    comes. One-pass TF32 (``a_hi b_hi`` alone), which the kernel does not
    do, is logged beside for the margin it would lose."""
    rng = np.random.RandomState(level)
    xyz, new_xyz, w, t, layers = _chain_inputs(rng, 2, n, s, c1, mlp)
    want = np.asarray(jax_fused.fused_sa_eval_ref(
        radius, 32, jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(w), jnp.asarray(t),
        tuple((jnp.asarray(k), jnp.asarray(b)) for k, b in layers)))
    args = (radius, 32, _t(xyz), _t(new_xyz), _t(w), _t(t), [(_t(k), _t(b)) for k, b in layers])
    ok = selfcheck.boundary_ok_mask(radius, _t(xyz), _t(new_xyz)).numpy()
    assert ok.mean() > 0.9

    def err(out):
        return float(np.abs(out.numpy() - want)[ok].max())

    three = err(fused_layer_model(*args, matmul=three_tf32_matmul))
    exact = err(fused_sa.fused_sa_eval_torch(*args))
    one = err(fused_layer_model(*args, matmul=lambda a, b: tf32_rna(a) @ tf32_rna(b)))
    scale = float(np.abs(want).max())
    print(f"SA{level}: three TF32 products {three:.3e} from JAX ({three / FUSED_ATOL:.4f} of "
          f"the {FUSED_ATOL} bar; output up to {scale:.2f}), exact fp32 {exact:.3e}, "
          f"one TF32 product {one:.3e}")
    assert three < FUSED_ATOL
    # fp32-faithful: within a few fp32 roundings of the output's scale
    assert three <= max(4 * exact, 2e-6 * scale)
