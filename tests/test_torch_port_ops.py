"""The PyTorch port's point ops, kernel masks, dispatch and modules against
the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs ``impl="jnp"`` (what ``"auto"`` resolves to on the CPU) and the
port its plain PyTorch versions (what ``"auto"`` resolves to for a CPU
tensor). The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each of them against the same plain versions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from pointnet12_tpu.kernels import selfcheck as jax_selfcheck
from pointnet12_tpu.nn.feature_propagation import (
    FeaturePropagation as JaxFeaturePropagation,
)
from pointnet12_tpu.nn.set_abstraction import SetAbstraction as JaxSetAbstraction
from pointnet12_tpu.ops import ballquery as jax_ballquery
from pointnet12_tpu.ops import distance as jax_distance
from pointnet12_tpu.ops import fps as jax_fps
from pointnet12_tpu.ops import gather as jax_gather
from pointnet12_tpu.ops import interpolate as jax_interpolate

from pointnet12_tpu_torch.kernels import dispatch, selfcheck
from pointnet12_tpu_torch.kernels import ranges as range_layout
from pointnet12_tpu_torch.kernels.ballquery_cuda import (
    ballquery_cuda, ballquery_plan, first_k_in_plan_order,
)
from pointnet12_tpu_torch.kernels.fps_cuda import (
    SHARED_SLOTS, THREADS, fps_cuda, fps_plan, register_slots,
)
from pointnet12_tpu_torch.kernels.threenn_cuda import (
    three_nn_cuda, three_nn_in_plan_order, three_nn_plan,
)
from pointnet12_tpu_torch.nn.feature_propagation import FeaturePropagation
from pointnet12_tpu_torch.nn.set_abstraction import SetAbstraction
from pointnet12_tpu_torch.ops.ballquery import query_ball_point
from pointnet12_tpu_torch.ops.distance import square_distance
from pointnet12_tpu_torch.ops.fps import farthest_point_sample, fps_torch
from pointnet12_tpu_torch.ops.gather import index_points
from pointnet12_tpu_torch.ops.interpolate import three_interpolate, three_nn
from pointnet12_tpu_torch.utils.jax_import import convert_shared_mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(seed, *shape):
    return np.random.RandomState(seed).uniform(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def perturb_variables(variables, seed):
    """Non-trivial BN affine and running statistics (init leaves them at
    1/0/0/1, which would hide a wrong fold), as numpy."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, dict(variables)))
    out = {}
    for path, v in flat.items():
        v = np.array(v, np.float32)
        leaf = path[-1]
        if leaf == "scale":
            v = 1.0 + 0.2 * rng.randn(*v.shape)
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.randn(*v.shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, size=v.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def assert_quantiles(got, want, p99=1e-3, median=1e-4):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.quantile(err, 0.99) < p99, np.quantile(err, 0.99)
    assert np.median(err) < median, np.median(err)


# ---------------------------------------------------------------- L1 ops


def test_square_distance_matches_jax():
    a, b = _cloud(0, 2, 256, 3), _cloud(1, 2, 64, 3)
    got = square_distance(_t(a), _t(b)).numpy()
    want = np.asarray(jax_distance.square_distance(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_square_distance_of_a_point_to_itself_is_exactly_zero():
    # the kernels' direct form gives 0 there; 1/(d2 + 1e-8) in
    # three_interpolate would amplify any rounding left by the expansion
    a = _t(_cloud(18, 2, 300, 3))
    d = square_distance(a, a)
    assert (torch.diagonal(d, dim1=1, dim2=2) == 0).all()


def test_index_points_clamps_like_jax():
    pts = _cloud(2, 2, 16, 5)
    idx = np.random.RandomState(3).randint(-4, 20, size=(2, 6, 4)).astype(np.int32)
    got = index_points(_t(pts), _t(idx)).numpy()
    want = np.asarray(jax_gather.index_points(jnp.asarray(pts), jnp.asarray(idx)))
    assert got.shape == (2, 6, 4, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,npoint", [(1024, 256), (256, 64), (64, 16)])
def test_fps_matches_jnp_exactly(n, npoint):
    xyz = _cloud(4, 2, n, 3)
    got = farthest_point_sample(_t(xyz), npoint)
    want = np.asarray(jax_fps.farthest_point_sample(jnp.asarray(xyz), npoint, impl="jnp"))
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_ties_go_to_the_first_index():
    # every point twice: each farthest point has a twin at the same distance
    xyz = np.tile(_cloud(19, 2, 128, 3), (1, 2, 1))
    got = farthest_point_sample(_t(xyz), 64).numpy()
    want = np.asarray(jax_fps.farthest_point_sample(jnp.asarray(xyz), 64, impl="jnp"))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1:] < 128).all()


def test_fps_starts_every_cloud_at_index_0():
    got = farthest_point_sample(_t(_cloud(5, 3, 128, 3)), 8).numpy()
    assert (got[:, 0] == 0).all()
    assert all(len(set(row)) == 8 for row in got.tolist())


def _fps_case(kind, n, seed):
    """(1, n, 3) float32 clouds of the FPS checks: uniform, every point
    equal (each argmax after the first a tie that index 0 wins), or on a
    1/64 grid (many exact ties, both distance forms exact)."""
    rng = np.random.RandomState(seed)
    if kind == "degenerate":
        return np.full((1, n, 3), 0.3, np.float32)
    if kind == "grid":
        return (rng.randint(0, 64, size=(1, n, 3)) / 64.0).astype(np.float32)
    return rng.uniform(size=(1, n, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,n,start", [
    ("uniform", 16384, 0), ("uniform", 12289, 0), ("uniform", 12289, 12288),
    ("degenerate", 4096, 0), ("degenerate", 4096, 1234), ("grid", 4096, 0), ("grid", 4096, 77),
])
def test_fps_plain_matches_jnp_at_any_n_and_on_ties(kind, n, start):
    # the plain version the kernel is held to on the card, against JAX's
    # _fps_jnp from the same start: past the kernel's old 8192-point cap,
    # and where every argmax is a tie
    xyz = _fps_case(kind, n, seed=n)
    st = np.array([start], np.int32)
    got = fps_torch(_t(xyz), 64, _t(st))
    want = np.asarray(jax_fps._fps_jnp(jnp.asarray(xyz), 64, jnp.asarray(st)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "degenerate":
        assert (got.numpy()[0, 1:] == 0).all()


@pytest.mark.parametrize("n", [1, 64, 255, 1024, 4096, 8192, 8193, 12289, 16384, 32768, 100000])
def test_fps_plan_holds_every_n(n):
    for threads in (None, *THREADS):
        try:
            plan = fps_plan(n, threads)
        except ValueError:
            assert threads is not None  # the default always has an instance
            continue
        assert plan.threads in THREADS
        if plan.shared:
            assert plan.slots == SHARED_SLOTS[plan.threads]
            assert plan.streamed == max(0, -(-n // plan.threads) - plan.slots)
            # the shared form's planes fit the block's 232448 bytes
            assert 12 * plan.slots * plan.threads <= 232448 - 1280
        else:
            assert plan.streamed == 0 and plan.slots in register_slots(plan.threads)
            assert plan.slots * plan.threads >= n
            # the fewest points a thread that hold n
            assert plan.slots == 1 or plan.slots // 2 * plan.threads < n
            # 4 registers a point within the thread's share of 65536
            assert 4 * plan.slots <= 65536 // plan.threads - 16


def test_fps_plan_refuses_threads_without_an_instance():
    with pytest.raises(ValueError, match="threads"):
        fps_plan(4096, 32)  # 128 points a thread: neither form at 32 threads
    with pytest.raises(ValueError, match="one of"):
        fps_plan(64, 100)


@pytest.mark.parametrize("n,npoint", [(4096, 1024), (8192, 1024), (12289, 3072), (32768, 8192)])
def test_fps_cuda_launches_once_at_any_n(n, npoint, monkeypatch):
    # the wrapper no longer refuses N > 8192: with the device check and the
    # launch stubbed, a call reaches build.launch once, N unchanged, with a
    # scratch buffer exactly when the plan streams
    from pointnet12_tpu_torch.kernels import build
    from pointnet12_tpu_torch.kernels import fps_cuda as fps_cuda_module

    launched, made = [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        made.append(tuple(out.shape))
        return out

    def check_tensor(kernel, name, t, dtype, shape, device=None):
        assert t.dtype == dtype and t.is_contiguous()
        return tuple(t.shape)

    monkeypatch.setattr(build, "check_tensor", check_tensor)
    monkeypatch.setattr(build, "launch", lambda name, device, *args: launched.append(args))
    monkeypatch.setattr(fps_cuda_module.torch, "empty", empty)
    monkeypatch.setattr(fps_cuda, "launches", 0)  # the count goes back afterwards
    b = 2
    out = fps_cuda(torch.zeros(b, n, 3), npoint, torch.zeros(b, dtype=torch.int32))
    plan = fps_plan(n)
    assert out.shape == (b, npoint) and fps_cuda.launches == 1
    assert len(launched) == 1
    *_, scratch_ptr, b_, n_, npoint_, threads, slots, shared = launched[0]
    assert (b_, n_, npoint_, threads, slots, shared) == (
        b, n, npoint, plan.threads, plan.slots, int(plan.shared))
    if plan.streamed:
        assert made == [(b, npoint), (b, plan.streamed, plan.threads, 4)]
        assert scratch_ptr is not None
    else:
        assert made == [(b, npoint)] and scratch_ptr is None
    assert (n == 32768) == bool(plan.streamed)


def _kernel_model(xyz, npoint, start, plan):
    """The reduction order of ``csrc/fps.cu`` in numpy: thread t owns the
    points [t*k, (t+1)*k), pads copy point 0; each thread's largest running
    minimum and its lowest slot at it, each warp's largest as unsigned bits
    and its lowest lane at it, the lowest warp at the block's largest."""
    n = xyz.shape[0]
    k = -(-n // plan.threads) if plan.shared else plan.slots
    pts = xyz[np.where(np.arange(plan.threads * k) < n, np.arange(plan.threads * k), 0)]
    dist = np.full(plan.threads * k, 1e10, np.float32)
    out, far = [start], start
    for _ in range(1, npoint):
        d = pts - xyz[far]
        dist = np.minimum(dist, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        per_thread = dist.reshape(plan.threads, k)
        best, slot = per_thread.max(1), per_thread.argmax(1)
        bits = best.view(np.uint32).reshape(-1, 32)
        lane = (bits == bits.max(1, keepdims=True)).argmax(1)
        wbits = bits[np.arange(len(bits)), lane]
        warp = int((wbits == wbits.max()).argmax())
        t = warp * 32 + lane[warp]
        far = int(t * k + slot[t])
        out.append(far)
    return np.array(out, np.int32)


@pytest.mark.parametrize("kind", ["uniform", "degenerate", "grid", "twins"])
@pytest.mark.parametrize("n,threads", [(300, 64), (300, 32), (1000, 256), (1000, 1024)])
def test_fps_kernel_reduction_order_gives_the_plain_indices(kind, n, threads):
    # the tie and pad argument of csrc/fps.cu: index order is (warp, lane,
    # slot) order and a pad never wins, so the kernel's reductions pick the
    # plain version's argmax at every plan
    xyz = (np.tile(_fps_case("uniform", n // 2, seed=3), (1, 2, 1)) if kind == "twins"
           else _fps_case(kind, n, seed=5))[0]
    want = fps_torch(_t(xyz[None]), 48, torch.tensor([7], dtype=torch.int32)).numpy()[0]
    got = _kernel_model(xyz, 48, 7, fps_plan(xyz.shape[0], threads))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("npoint", [0, 129])
def test_fps_rejects_npoint_out_of_range(npoint):
    with pytest.raises(ValueError, match="npoint"):
        farthest_point_sample(_t(_cloud(5, 1, 128, 3)), npoint)


@pytest.mark.parametrize(
    "n,s,radius", [(1024, 256, 0.2), (256, 64, 0.4), (64, 16, 0.8)]
)
def test_ballquery_matches_jnp_off_boundary(n, s, radius):
    xyz = _cloud(6, 2, n, 3)
    centers = xyz[:, :s] + 0.01 * np.random.RandomState(7).randn(2, s, 3).astype(np.float32)
    got = query_ball_point(radius, 32, _t(xyz), _t(centers)).numpy()
    want = np.asarray(jax_ballquery.query_ball_point(
        radius, 32, jnp.asarray(xyz), jnp.asarray(centers), impl="jnp"
    ))
    ok = selfcheck.boundary_ok_mask(radius, _t(xyz), _t(centers)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, s, 32)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(got[ok], want[ok])


def test_ballquery_empty_ball_pads_with_n():
    xyz = _cloud(8, 1, 64, 3)
    far = np.full((1, 2, 3), 10.0, np.float32)
    got = query_ball_point(0.1, 8, _t(xyz), _t(far)).numpy()
    want = np.asarray(jax_ballquery.query_ball_point(
        0.1, 8, jnp.asarray(xyz), jnp.asarray(far), impl="jnp"
    ))
    np.testing.assert_array_equal(got, want)
    assert (got == 64).all()


@pytest.mark.parametrize("n,m", [(1024, 256), (256, 64), (64, 16)])
def test_three_nn_matches_jnp_off_ties(n, m):
    q, r = _cloud(9, 2, n, 3), _cloud(10, 2, m, 3)
    d, i = three_nn(_t(q), _t(r))
    wd, wi = jax_interpolate.three_nn(jnp.asarray(q), jnp.asarray(r), impl="jnp")
    ok = selfcheck.tie_ok_mask(_t(q), _t(r)).numpy()
    assert i.dtype == torch.int32 and i.shape == (2, n, 3)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[ok], np.asarray(wi)[ok])
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-5)


def test_three_nn_ties_go_to_the_lower_index():
    # every reference at the same place: all distances tie
    q = np.zeros((1, 4, 3), np.float32)
    r = np.ones((1, 8, 3), np.float32)
    _, i = three_nn(_t(q), _t(r))
    np.testing.assert_array_equal(i.numpy(), np.tile([0, 1, 2], (1, 4, 1)))


def test_three_interpolate_matches_jax():
    q, r = _cloud(11, 2, 512, 3), _cloud(12, 2, 128, 3)
    feats = np.random.RandomState(13).randn(2, 128, 16).astype(np.float32)
    wd, wi = jax_interpolate.three_nn(jnp.asarray(q), jnp.asarray(r), impl="jnp")
    want = np.asarray(jax_interpolate.three_interpolate(jnp.asarray(feats), wi, wd))
    got = three_interpolate(_t(feats), _t(wi), _t(wd)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("which", ["boundary", "tie"])
def test_masks_match_jax(which):
    xyz, q = _cloud(14, 2, 256, 3), _cloud(15, 2, 64, 3)
    if which == "boundary":
        got = selfcheck.boundary_ok_mask(0.2, _t(xyz), _t(q)).numpy()
        want = np.asarray(jax_selfcheck.boundary_ok_mask(0.2, jnp.asarray(xyz), jnp.asarray(q)))
    else:
        got = selfcheck.tie_ok_mask(_t(q), _t(xyz)).numpy()
        want = np.asarray(jax_selfcheck.tie_ok_mask(jnp.asarray(q), jnp.asarray(xyz)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- dispatch


def test_dispatch_follows_the_tensor():
    cpu = torch.zeros(1)
    assert dispatch.resolve("auto", cpu) == "torch"
    assert dispatch.resolve("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        dispatch.resolve("cuda", cpu)
    with pytest.raises(ValueError):
        dispatch.resolve("pallas", cpu)


@pytest.mark.parametrize("op", ["fps", "ballquery", "three_nn"])
def test_cuda_impl_on_cpu_tensor_raises(op):
    xyz = _t(_cloud(16, 1, 64, 3))
    with pytest.raises(ValueError, match="CUDA"):
        if op == "fps":
            farthest_point_sample(xyz, 8, impl="cuda")
        elif op == "ballquery":
            query_ball_point(0.2, 8, xyz, xyz[:, :8], impl="cuda")
        else:
            three_nn(xyz, xyz[:, :8], impl="cuda")


@pytest.mark.parametrize("wrapper", ["fps", "ballquery", "three_nn"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    xyz = _t(_cloud(17, 1, 64, 3))
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "fps":
            fps_cuda(xyz, 8, torch.zeros(1, dtype=torch.int32))
        elif wrapper == "ballquery":
            ballquery_cuda(0.2, 8, xyz, xyz[:, :8].contiguous())
        else:
            three_nn_cuda(xyz, xyz[:, :8].contiguous())
    assert fps_cuda.launches == ballquery_cuda.launches == three_nn_cuda.launches == 0


def test_kernel_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    from pointnet12_tpu_torch.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc fatal: bad option' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(build.KernelBuildError, match="nvcc fatal: bad option"):
        build.build()
    assert list((tmp_path / "kernels").iterdir()) == []  # no half-built library


def test_kernel_build_dir_stays_in_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    from pointnet12_tpu_torch.kernels import build

    assert build.BUILD_DIR == build.Path(REPO) / "build" / "kernels"
    site = tmp_path / "site-packages"  # an installed package: no pyproject.toml
    site.mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(site) == tmp_path / "cache" / "pointnet12_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir(site) == tmp_path / "home" / ".cache" / "pointnet12_tpu_torch" / "kernels"


def test_import_pulls_in_no_jax_flax_or_triton():
    code = (
        "import sys\n"
        "import pointnet12_tpu_torch, pointnet12_tpu_torch.infer\n"
        "import pointnet12_tpu_torch.kernels.fps_cuda\n"
        "import pointnet12_tpu_torch.kernels.ballquery_cuda\n"
        "import pointnet12_tpu_torch.kernels.threenn_cuda\n"
        "import pointnet12_tpu_torch.kernels.segsum_cuda\n"
        "import pointnet12_tpu_torch.kernels.bn_stats_cuda\n"
        "import pointnet12_tpu_torch.kernels.grid_cuda\n"
        "import pointnet12_tpu_torch.kernels.fused_sa_cuda\n"
        "import pointnet12_tpu_torch.ops.segsum, pointnet12_tpu_torch.ops.bn_stats\n"
        "import pointnet12_tpu_torch.ops.grid, pointnet12_tpu_torch.ops.fused_sa\n"
        "import pointnet12_tpu_torch.nn.set_abstraction\n"
        "import pointnet12_tpu_torch.train.precise_bn\n"
        "import pointnet12_tpu_torch.train.loop, pointnet12_tpu_torch.train.losses\n"
        "import pointnet12_tpu_torch.train.metrics, pointnet12_tpu_torch.train.optim\n"
        "import pointnet12_tpu_torch.kernels.build\n"
        "import pointnet12_tpu_torch.kernels.selfcheck\n"
        "import pointnet12_tpu_torch.utils.jax_import\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',\n"
        "                                    'pointnet12_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


# ---------------------------------------------------------------- L2 modules


@pytest.mark.parametrize(
    "n,npoint,radius,d,mlp",
    [(1024, 256, 0.2, 6, [16, 16, 32]), (256, 64, 0.4, 13, [32, 32, 64])],
)
def test_set_abstraction_matches_jax(n, npoint, radius, d, mlp):
    xyz = _cloud(20, 2, n, 3)
    feats = np.random.RandomState(21).randn(2, n, d).astype(np.float32)
    jmod = JaxSetAbstraction(npoint, radius, 32, mlp, impl="jnp")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats))
    variables = perturb_variables(variables, 22)
    want_xyz, want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats))

    port = SetAbstraction(npoint, radius, 32, 3 + d, mlp)
    port.load_state_dict({
        k: _t(v) for k, v in convert_shared_mlp(
            variables["params"]["mlp"], variables["batch_stats"]["mlp"]
        ).items()
    })
    port.eval().fold_bn_()
    with torch.no_grad():
        got_xyz, got = port(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, npoint, mlp[-1])
    assert_quantiles(got.numpy(), want)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_propagation_matches_jax(skip):
    fine, coarse = _cloud(30, 2, 512, 3), _cloud(31, 2, 128, 3)
    rng = np.random.RandomState(32)
    f_fine = rng.randn(2, 512, 8).astype(np.float32) if skip else None
    f_coarse = rng.randn(2, 128, 16).astype(np.float32)
    jmod = JaxFeaturePropagation([32, 16])
    args = (jnp.asarray(fine), jnp.asarray(coarse),
            None if f_fine is None else jnp.asarray(f_fine), jnp.asarray(f_coarse))
    variables = perturb_variables(jmod.init(jax.random.PRNGKey(1), *args), 33)
    want = jmod.apply(variables, *args)

    port = FeaturePropagation((8 if skip else 0) + 16, [32, 16])
    port.load_state_dict({
        k: _t(v) for k, v in convert_shared_mlp(
            variables["params"]["mlp"], variables["batch_stats"]["mlp"]
        ).items()
    })
    port.eval().fold_bn_()
    with torch.no_grad():
        got = port(_t(fine), _t(coarse), None if f_fine is None else _t(f_fine), _t(f_coarse))
    assert got.shape == (2, 512, 16)
    assert_quantiles(got.numpy(), want)


def test_modules_refuse_train_mode_and_unfolded_eval():
    """Train mode runs (batch-statistics BN); eval still refuses to run
    until BN is folded."""
    port = FeaturePropagation(16, [8])
    x = torch.rand(1, 4, 3)
    out = port(x, x, None, torch.rand(1, 4, 16))
    assert port.training and out.shape == (1, 4, 8)
    port.eval()
    with pytest.raises(RuntimeError, match="fold_bn_"):
        port(x, x, None, torch.zeros(1, 4, 16))


# ------------------------------------------- the range plans of the searches
#
# csrc/ballquery.cu and csrc/threenn.cu split a cloud into contiguous index
# ranges, one warp a range, and merge the ranges' results; the plans pick
# the split and first_k_in_plan_order / three_nn_in_plan_order write the
# kernels' order in plain ops. On the card chip_smoke.py holds each kernel
# to its model bit for bit; here the models are held to the JAX package.

EDGE_N = (3, 33, 1000, 1024, 4096, 4097, 12289, 32768)
SLICE_SA = ((4096, 1024, 0.1), (1024, 256, 0.2), (256, 64, 0.4), (64, 16, 0.8))
# the decoder's levels: (queries, references), FP1-FP4
SLICE_FP = ((4096, 1024), (1024, 256), (256, 64), (64, 16))
BQ_SHAPES = [(16, n, max(1, n // 4), k) for n in EDGE_N for k in (1, 32, 64, 128) if k <= n]
BQ_SHAPES += [(16, n, s, 32) for n, s, _ in SLICE_SA] + [(128, 1024, 1024, 32)]
NN_SHAPES = [(16, n, max(3, n // 4)) for n in EDGE_N] + [(16, n, m) for n, m in SLICE_FP]


def _grid_cloud(seed, *shape):
    """Coordinates on a 1/64 grid in [0, 1): the direct and expansion forms
    of a squared distance are both exact there."""
    return (np.random.RandomState(seed).randint(0, 64, size=shape) / 64).astype(np.float32)


def _ranges_of(length, n):
    return [(lo, min(lo + length, n)) for lo in range(0, n, length)]


def _assert_ranges_cover(plan, n):
    ranges = _ranges_of(plan.length, n)
    assert len(ranges) <= plan.ranges and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    assert plan.chunk >= 32 and plan.chunk & (plan.chunk - 1) == 0
    assert plan.ranges * plan.groups <= range_layout.MAX_WARPS


@pytest.mark.parametrize("b,n,s,k", BQ_SHAPES)
def test_ballquery_plan_covers_the_cloud_within_shared_memory(b, n, s, k):
    plan = ballquery_plan(b, n, s, k)
    _assert_ranges_cover(plan, n)
    lanes = plan.groups * plan.per_lane * plan.ranges * 32
    region = max(plan.ranges * plan.chunk * 16, plan.groups * plan.per_lane * 32 * (k | 1) * 4)
    if plan.per_lane == 0:  # a warp a center: no staging, no lists
        assert n <= 256 and plan.ranges == 1 and plan.shared_bytes == 0 and not plan.scratch
    else:
        assert plan.shared_bytes == region + lanes * 4 + (
            0 if plan.scratch else lanes * (k | 1) * 4)
    assert plan.shared_bytes <= range_layout.MAX_SHARED_BYTES
    if (n, s, k) in {(sn, ss, 32) for sn, ss, _ in SLICE_SA}:
        # two blocks an SM at the slice shapes, by shared memory and threads
        assert plan.shared_bytes <= range_layout.TWO_BLOCKS_BYTES
        assert 2 * plan.ranges * plan.groups * 32 <= 2048


@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_three_nn_plan_covers_the_references_within_shared_memory(b, n, m):
    plan = three_nn_plan(b, n, m)
    _assert_ranges_cover(plan, m)
    cand = 2 * plan.ranges * 3 * plan.groups * 32 * 4 if plan.ranges > 1 else 0
    assert plan.shared_bytes == plan.ranges * plan.chunk * 16 + cand
    assert plan.shared_bytes <= range_layout.MAX_SHARED_BYTES
    if (n, m) in SLICE_FP:
        assert plan.shared_bytes <= range_layout.TWO_BLOCKS_BYTES
        assert 2 * plan.ranges * plan.groups * 32 <= 2048


def test_plans_at_the_slice_shapes_fill_the_card():
    # the defaults the plan sweep of chip_smoke.py chose (PERF.md): the
    # first level's launch holds the warps the plan aims at, the small
    # levels split into ranges
    from pointnet12_tpu_torch.kernels import ballquery_cuda as bq, threenn_cuda as nn

    sa = [ballquery_plan(16, n, s, 32) for n, s, _ in SLICE_SA]
    assert [(p.per_lane, p.ranges) for p in sa] == [(2, 16), (1, 16), (0, 1), (0, 1)]
    fp = [three_nn_plan(16, n, m) for n, m in SLICE_FP]
    assert [p.ranges for p in fp] == [1, 4, 2, 1]
    assert 16 * 1024 // (32 * sa[0].per_lane) * sa[0].ranges >= bq.WARPS
    assert 16 * 4096 // 32 * fp[0].ranges >= nn.WARPS
    # a large batch packs two groups of centers a block, the first level
    # of 3-NN four groups of queries
    assert ballquery_plan(128, 1024, 1024, 32)[:3] == (2, 2, 2)
    assert fp[0].groups == 4


def _jax_ballquery(radius, k, xyz, centers):
    return np.asarray(jax_ballquery.query_ball_point(
        radius, k, jnp.asarray(xyz), jnp.asarray(centers), impl="jnp"))


def _r2(radius):
    return float(np.float32(radius * radius))


@pytest.mark.parametrize("b,n,s,k", BQ_SHAPES)
def test_first_k_in_plan_order_matches_jnp_on_grid_clouds(b, n, s, k):
    # the plan of the full shape, run on 2 clouds and up to 64 centers
    plan = ballquery_plan(b, n, s, k)
    radius = 0.2 if n >= 1024 else 0.4
    xyz = _grid_cloud(n + k, 2, n, 3)
    centers = np.concatenate([xyz[:, : min(s, 48)],  _grid_cloud(k, 2, 16, 3)], axis=1)
    got = first_k_in_plan_order(_t(xyz), _t(centers), _r2(radius), k, plan).numpy()
    np.testing.assert_array_equal(got, _jax_ballquery(radius, k, xyz, centers))


@pytest.mark.parametrize("per_lane,ranges", [(0, 1), (1, 1), (1, 2), (2, 3), (1, 4), (2, 8), (1, 16)])
@pytest.mark.parametrize("k", [1, 5, 32])
def test_first_k_in_plan_order_matches_jnp_at_any_split(per_lane, ranges, k):
    plan = ballquery_plan(2, 700, 40, k, per_lane=per_lane, ranges=ranges)
    xyz, centers = _grid_cloud(3, 2, 700, 3), _grid_cloud(4, 2, 40, 3)
    got = first_k_in_plan_order(_t(xyz), _t(centers), _r2(0.3), k, plan).numpy()
    np.testing.assert_array_equal(got, _jax_ballquery(0.3, k, xyz, centers))


def _straddling_cloud(length):
    """A cloud far from the center but for four points at the indices
    length-2 .. length+1: two at the end of range 0, two at the start of
    range 1."""
    xyz = np.full((1, 3 * length, 3), 5.0, np.float32)
    xyz[0, length - 2:length + 2] = [[0.0, 0.0, 0.0], [0.25, 0, 0], [0, 0.25, 0], [0, 0, 0.25]]
    return xyz


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_ballquery_hits_straddling_a_range_end_merge_in_index_order(k):
    plan = ballquery_plan(1, 192, 1, k, ranges=3)
    assert plan.length == 64
    xyz, center = _straddling_cloud(64), np.zeros((1, 1, 3), np.float32)
    got = first_k_in_plan_order(_t(xyz), _t(center), _r2(0.5), k, plan).numpy()
    want = _jax_ballquery(0.5, k, xyz, center)
    np.testing.assert_array_equal(got, want)
    hits = [62, 63, 64, 65][:k]
    assert got[0, 0].tolist() == hits + [62] * (k - len(hits))


@pytest.mark.parametrize("k", [1, 16, 32])
def test_ballquery_k_reached_inside_the_first_range(k):
    # every point of the first range in radius: the row is its first k, the
    # later ranges' hits never reach it
    plan = ballquery_plan(2, 256, 8, k, ranges=4)
    xyz = _grid_cloud(7, 2, 256, 3)
    xyz[:, :plan.length] = 0.5
    centers = np.full((2, 8, 3), 0.5, np.float32)
    got = first_k_in_plan_order(_t(xyz), _t(centers), _r2(0.2), k, plan).numpy()
    np.testing.assert_array_equal(got, _jax_ballquery(0.2, k, xyz, centers))
    assert (got == np.arange(k)).all()


@pytest.mark.parametrize("ranges", [1, 4])
def test_ballquery_empty_balls_pad_with_n_in_plan_order(ranges):
    plan = ballquery_plan(1, 300, 4, 32, ranges=ranges)
    xyz = _grid_cloud(8, 1, 300, 3)
    centers = np.concatenate([np.full((1, 2, 3), 10.0, np.float32), xyz[:, :2]], axis=1)
    got = first_k_in_plan_order(_t(xyz), _t(centers), _r2(0.1), 32, plan).numpy()
    np.testing.assert_array_equal(got, _jax_ballquery(0.1, 32, xyz, centers))
    assert (got[0, :2] == 300).all() and (got[0, 2:] < 300).all()


def _jax_three_nn(q, r):
    d, i = jax_interpolate.three_nn(jnp.asarray(q), jnp.asarray(r), impl="jnp")
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_three_nn_in_plan_order_matches_jnp_on_grid_clouds(b, n, m):
    # ties are common on the grid: the order of equal distances is held too
    plan = three_nn_plan(b, n, m)
    q = _grid_cloud(n, 2, min(n, 64), 3)
    r = _grid_cloud(m + 1, 2, m, 3)
    d, i = three_nn_in_plan_order(_t(q), _t(r), plan)
    wd, wi = _jax_three_nn(q, r)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(d.numpy(), wd)


@pytest.mark.parametrize("ranges", [1, 2, 3, 4, 8, 16])
def test_three_nn_in_plan_order_matches_jnp_at_any_split(ranges):
    plan = three_nn_plan(2, 200, 600, ranges=ranges)
    q, r = _grid_cloud(5, 2, 200, 3), _grid_cloud(6, 2, 600, 3)
    d, i = three_nn_in_plan_order(_t(q), _t(r), plan)
    wd, wi = _jax_three_nn(q, r)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(d.numpy(), wd)


@pytest.mark.parametrize("m", [3, 4, 17, 4097])
def test_three_nn_twinned_references_across_a_range_boundary(m):
    # reference j and j + length are the same point, and the query sits on
    # it: the tie across the ranges goes to the lower index
    ranges = 2 if m >= 4 else 1
    plan = three_nn_plan(1, 64, m, ranges=ranges)
    r = _grid_cloud(m, 1, m, 3)
    if ranges > 1:
        r[:, plan.length:2 * plan.length] = r[:, :min(plan.length, m - plan.length)]
    q = np.concatenate([r[:, :min(m, 32)], _grid_cloud(9, 1, 32, 3)], axis=1)
    d, i = three_nn_in_plan_order(_t(q), _t(r), plan)
    wd, wi = _jax_three_nn(q, r)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(d.numpy(), wd)
    if ranges > 1:  # query 0 sits on reference 0 and on its twin, `length`
        assert (r[0, plan.length] == r[0, 0]).all()
        assert i.numpy()[0, 0, 0] == 0 and d.numpy()[0, 0, 0] == 0.0


def _stub_launch(monkeypatch, module):
    """The wrapper's device check passes for a CPU tensor and the launch is
    recorded, not run; the count goes back afterwards."""
    from pointnet12_tpu_torch.kernels import build

    launched = []

    def check_tensor(kernel, name, t, dtype, shape, device=None):
        assert t.dtype == dtype and t.is_contiguous()
        return tuple(t.shape)

    monkeypatch.setattr(build, "check_tensor", check_tensor)
    monkeypatch.setattr(build, "launch", lambda name, device, *args: launched.append(args))
    return launched


@pytest.mark.parametrize("nsample", [65, 1000])
def test_ballquery_cuda_refuses_nsample_above_n(nsample, monkeypatch):
    # as ballquery_torch and JAX's lax.top_k refuse it
    launched = _stub_launch(monkeypatch, ballquery_cuda)
    monkeypatch.setattr(ballquery_cuda, "launches", 0)
    xyz = torch.zeros(2, 64, 3)
    with pytest.raises(ValueError, match="nsample"):
        ballquery_cuda(0.2, nsample, xyz, xyz[:, :8].contiguous())
    with pytest.raises(ValueError, match="nsample"):
        query_ball_point(0.2, nsample, xyz, xyz[:, :8].contiguous(), impl="torch")
    assert launched == [] and ballquery_cuda.launches == 0


@pytest.mark.parametrize("b,n,s,k", [(16, 4096, 1024, 32), (16, 256, 64, 32), (16, 64, 16, 32),
                                     (1, 12289, 3072, 64)])
def test_ballquery_cuda_launches_once_with_its_plan(b, n, s, k, monkeypatch):
    from pointnet12_tpu_torch.kernels import ballquery_cuda as module

    launched = _stub_launch(monkeypatch, ballquery_cuda)
    made, real_empty = [], torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(module.torch, "empty", empty)
    monkeypatch.setattr(ballquery_cuda, "launches", 0)
    out = ballquery_cuda(0.1, k, torch.zeros(b, n, 3), torch.zeros(b, s, 3))
    plan = ballquery_plan(b, n, s, k)
    assert out.shape == (b, s, k) and ballquery_cuda.launches == 1 and len(launched) == 1
    *_, scratch_ptr, b_, n_, s_, k_, r2, per_lane, ranges, groups, length, shift, smem = launched[0]
    assert (b_, n_, s_, k_, r2) == (b, n, s, k, _r2(0.1))
    assert (per_lane, ranges, groups, length, 1 << shift, smem) == (
        plan.per_lane, plan.ranges, plan.groups, plan.length, plan.chunk, plan.shared_bytes)
    lists = b * -(-s // 32) * plan.ranges * 32 * (k | 1)
    assert made == [(b, s, k)] + ([(lists,)] if plan.scratch else [])
    assert (scratch_ptr is not None) == plan.scratch


@pytest.mark.parametrize("b,n,m", [(16, 4096, 1024), (16, 1024, 256), (70000, 64, 16)])
def test_three_nn_cuda_launches_once_with_its_plan(b, n, m, monkeypatch):
    # one grid dimension over the blocks: no cap on B (the old kernel put
    # the batch on gridDim.y, at most 65535)
    launched = _stub_launch(monkeypatch, three_nn_cuda)
    monkeypatch.setattr(three_nn_cuda, "launches", 0)
    q, r = torch.zeros(b, n, 3), torch.zeros(b, m, 3)
    d, i = three_nn_cuda(q, r)
    plan = three_nn_plan(b, n, m)
    assert d.shape == i.shape == (b, n, 3) and three_nn_cuda.launches == 1
    *_, b_, n_, m_, ranges, groups, length, shift, smem = launched[0]
    assert (b_, n_, m_) == (b, n, m)
    assert (ranges, groups, length, 1 << shift, smem) == (
        plan.ranges, plan.groups, plan.length, plan.chunk, plan.shared_bytes)
