#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (fp32, and bf16 with
stochastic rounding and the fused BN statistics), the fused eval
set-abstraction serving path (``impl="fused"``) and the serving of
8192-point clouds through the grid ball query on one CUDA card and check
them.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --fp32-bn-step`` runs only phase 9's trace of the
fp32 fused train step and its dense_bn_stats device µs per call: a copy of
this file run from the root of another checkout measures that tree's
kernel in the same call.)

It builds the CUDA kernels of ``pointnet12_tpu_torch/csrc`` (into
``build/kernels/``), then:

1. device: requires a CUDA card and prints ``nvidia-smi``'s name and power
   limit;
2. precision and build: true fp32 matmuls, the nvcc build and its time;
   ptxas's registers and shared memory of every kernel; for the kernels
   redesigned for the tensor cores (``dense_bn_stats_mma``'s bf16 and fp32
   instances, both fused SA kernels) their HMMA/HGMMA instructions counted
   in the SASS (``cuobjdump -sass``), none failing the run;
3. kernels: each CUDA kernel against its plain PyTorch version at every
   shape of the pointnet2_semseg slice (B=16, N=4096): FPS indices exact,
   ball-query indices exact off the radius boundary, 3-NN indices exact off
   distance ties and d2 within 1e-5; every call of ``ballquery.cu`` and
   ``threenn.cu``, here and in every later phase, also bit for bit on every
   row, no mask, against its order model (``first_k_in_plan_order``,
   ``three_nn_in_plan_order``: the kernel's per-range results and merge in
   plain ops);
4. the slice: a ``Predictor`` of pointnet2_semseg (13 classes, random
   weights from a seed, non-trivial BN statistics) serves 4 requests of
   (16, 4096, 9) and one short request of 5 clouds through ``pad_batch``;
   the launch counters must rise by 4 FPS, 4 ball-query and 4 3-NN launches
   per forward, and the log-probs must meet the bars of
   ``tests/test_parity.py`` against the plain path's (``impl="torch"``) on
   the card and the CPU's on two clouds. These requests sit on a 1/64
   grid, where both distance forms are exact;
5. continuous clouds: one more request of uniform clouds. Every kernel
   call of its forward is held against its plain version on the same
   inputs (the checks of phase 3); the plain path, fed the kernel path's
   neighbour indices in place of its own, must meet the bars of
   ``tests/test_parity.py`` against the kernel path; and with its own
   neighbours it must meet the median bar and agree on 99% of the labels;
6. times: each kernel wrapper and its plain version at each slice shape
   (CUDA events), the Predictor's clouds/sec on the kernel path and on
   the plain path over several windows (median, min, max); then a
   torch.profiler trace of the kernel path: device busy time, idle share,
   each kernel's device time at each slice shape, and the kernels that
   take the time;
7. the train step (pointnet2_semseg, fp32, 13 classes, Adam lr 1e-3 with
   weight decay 1e-4, dropout 0.5, FPS starts and dropout drawn from a
   card generator): 10 steps on one fixed (16, 4096, 9) batch whose labels
   follow a rule of the coordinates. Every loss finite and the last below
   the first; per step 7 segment-sum launches and 4 each of FPS, ball
   query and 3-NN; then an eval step whose confusion matrix sums to B*N.
   The 7 segment-sum calls of one more step, each against its plain
   version within 1e-5 of the call's largest value, and the segment sum
   at C of 1, 3, 6 and 130 (its scalar form), with every index equal,
   with indices outside [0, M) and at B=1. On 1/64 grid clouds, FPS from
   index 0 and no dropout, the gradients of the kernel path against the
   plain path's, per parameter (``tests/test_train_parity.py:136-152``:
   atol 5e-5 + rtol 2e-4 of the largest). Times: the train step on both
   paths over several windows, a profiler trace of the train step, and
   the segment sum at each of its 7 shapes beside its bound, its plain
   version, the one sparse product that computes it (``torch.sparse.mm``;
   the two timed in turns) and, at the 3 unweighted shapes,
   ``index_add_``; the wrapper (its memset and its kernel) and the sparse
   product also in device time, each traced alone.

8. the fused Dense + BN statistics (``csrc/bn_stats.cu``): first the SR
   cast on the card against the CPU, bit for bit; then the kernel against
   its plain version at the 17 shapes of the fused train step, in fp32
   and bf16, at activation scale and with every column at mean/std 3
   (fp32 y within 1e-5 of the largest |y|, bf16 y within one ulp of the
   rounded product plus one of y, the statistics within 1e-5 of their
   scale of the plain one-pass form of the kernel's own y), y, mean and
   var the same bits over two launches, the statistics (both dtypes) the
   bits of ``stats_in_kernel_order`` (the kernel's summation order in
   plain ops) of the kernel's own y, each timed beside its plain
   version, ``F.linear`` alone (by events and in device time) and
   ``F.linear`` plus the plain statistics, and its bound (fp32: the SIMT
   bound and the tensor-core one of three TF32 products, as rows 8-9);
9. the slice's main path, bf16 + SR with the fused statistics
   (``--bf16 --bf16_sr``, ``fused_bn_stats=True``): 10 Adam steps on
   phase 7's batch, every loss finite and the last below the first, per
   step 17 dense_bn_stats launches and 4+4+4+7 of the others; the bf16
   eval step (confusion sums to B*N); one request to a bf16 Predictor of
   the trained weights against its plain path; every kernel call of one
   more step against its plain version. Gradients of the fused path,
   kernel against plain path on grid clouds, FPS from index 0, no
   dropout, no SR: fp32 to the global bars of
   ``tests/test_train_parity.py:155-169``, bf16 to the plain path's own
   spread under a one-ulp nudge of the input. Times: step medians of
   bf16+SR fused, bf16+SR unfused and fp32 fused, a profiler trace of
   each, in the bf16+SR fused step's the SR casts' device time, and in
   both fused steps' dense_bn_stats' device µs at each shape;
10. Path F, the fused eval set abstraction: a ``Predictor`` with
   ``impl="fused"`` of phase 4's weights serves 4 requests of (16, 4096, 9)
   grid clouds: per forward 1 fused grid SA layer (SA1), 3 fused dense
   ones (SA2-SA4), 1 grid prep, 4 FPS and 4 3-NN launches and no ball
   query; log-probs within the parity bars of the plain path's. On a
   request of continuous clouds it meets the bars against the unfused
   kernel ``Predictor`` (the same distance function, so the same
   neighbours), and every kernel call of that forward is held against its
   plain version; both fused kernels run at every SA level's inputs, and
   with three centers of every cloud moved out of every ball (the clamped
   sentinel row), within 5e-4 off the radius boundary, each output the
   same bits over two launches;
11. Path G, 8192-point clouds with ``impl="auto"``: one request of
   (16, 8192, 9) grid clouds, per forward 1 grid ball query (SA1), 1
   grid prep, 3 ``ballquery.cu``, 4 FPS (at N=8192 too) and 4 3-NN
   launches, log-probs within the bars of the plain path's; every kernel
   call of a continuous-cloud forward held against its plain version; the
   grid ball query with centers out of every ball, at a plan whose lists
   overflow (compacted) and whose union streams in tiles, at K = 1 and
   128, on the two clustered clouds of ``tests/test_kernels.py:80-129``
   scaled to N=8192 (the spot's centers pass the threshold to the scan)
   and at B=1, N=32768; the grid prep kernel against its plain version, all five
   tensors bit for bit, at N=4096, 8192 and 32768 (S=1024) on uniform,
   clustered, 1/64-grid (points on cell faces), degenerate (every point
   equal) and one-cell clouds, and with centers out of every ball, with
   the grid ball query on each. Every call of ``ballquery_grid.cu``, here
   and in phase 12, is also held bit for bit on every row, no mask, to
   the contract (``first_k_in_plan_order`` over one range), and logs how
   many centers take each of its paths;
12. times of the new kernels at each shape of Paths F and G: wrapper,
   plain version, bound, ``torch.searchsorted`` (the one PyTorch call for
   the cell offsets, held equal to their plain version first, timed in
   turns with the grid prep's wrapper) and, as
   yardsticks, the unfused kernel path of each fused layer
   (``ballquery.cu``, gather, cuBLAS chain, K-max) and ``ballquery.cu``
   beside the grid ball query, by CUDA events and again in device time
   from a profiler trace of each call (the grid wrappers with their
   prep; the prep kernel alone, which must hold one device event, the
   plain prep and ``torch.searchsorted``); the ball-query crossover curve
   (the grid route and ``ballquery.cu`` at N = 4096, 8192, 16384, S = N/4,
   uniform and clustered clouds, equal indices, events and device time);
   the grid plan sweep (``[sweep]``: run, list capacity, threshold, tile,
   one at a time around the default) at Path G's SA1 and the crossover's
   clustered cloud at N=8192, each instance held to the contract and its
   kernel timed on the device;
   the fused and unfused ``Predictor``'s clouds/sec at N=4096 and the
   N=8192 one's over windows; profiler traces of both paths' forwards with
   each kernel's device µs; a table of the fused layers: the kernel's
   device µs beside its SIMT and tensor-core bounds, its wrapper and the
   unfused kernel path;
13. the launch path: host ns of 1000 calls of each part of the segment
   sum's and the grid prep's wrappers (checks, allocation, the old launch's
   device switch and ``Stream`` object, the raw calls that replace them,
   the ctypes call, ``build.launch``, the whole wrapper; the grid's five
   views, made only on demand) beside an empty call and one PyTorch op;
14. FPS at any N: the kernel equal to its plain version at N = 12289,
   16384 and 32768 (B=16 from random starts drawn from a card generator,
   B=1 from index 0) and at N=4096 on degenerate, 1/64-grid and clustered
   clouds from random starts; at the four slice shapes, Path G's SA1 and
   each new N every thread count with an instance held equal and timed
   (the sweep: CUDA events, and device time up to N=8192), the default's
   wrapper and device time (one device event a call), ns an iteration and
   bound; one ``Predictor`` forward of B=2 clouds of N=16384, every kernel
   call held to its plain version, log-probs finite and normalised;
15. ball query and 3-NN at their edges (log prefix ``[neighbours]``): the
   ball query at K = 1, 32, 64, 128, with centers out of every ball, on
   clustered clouds whose centers reach K in the first range, at N = 12289
   and 32768 (B=1), on 128 clouds of 1024 points each a center; 3-NN with
   M = 3, 4, 17, 4097 and twinned references
   across a range boundary, at 1, 2 and 4 ranges; each call held to its
   plain version and to its order model. Then the plan sweep (``[sweep]``):
   at each slice shape every instance (1-16 ranges; for the ball query one
   or two centers a lane, or a warp a center) held to its order model and
   timed on the device. The main path's device µs of both kernels at each
   level are logged beside the earlier design's and the bound (phase 6).

Every profiler trace whose launches are counted (phases 6, 7, 9, 12) or
timed call by call holds padding calls before and after the measured
ones, which lie between two stretches of idle card (``traced_window``):
a trace loses one or two device events at its ends.

Every kernel's least time on the card (``bound_ms``) is the larger of the
bytes it must move over 3.35 TB/s and the operations it does over
67 TFLOP/s (fp32 outside the tensor cores; 989 TFLOP/s on the tensor
cores for dense_bn_stats' bf16 product), counted from this run's inputs.
The fused SA layers and dense_bn_stats' fp32 route have two
(``fused_bounds``): that one, and the products as three TF32 products
each at 495 TFLOP/s on the tensor cores beside the other ops at the SIMT
rate, the larger of those two times and the bytes time; ``bound_ms`` is
the lower of the two.
Any failure raises and exits non-zero. Imports nothing of JAX. The last
two lines are the ``{"kernels": [...]}`` summary of the nine kernels of
``KERNELS`` and the ``{"ok": true, "device": ...}`` line.
"""

import collections
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from pointnet12_tpu_torch.infer import Predictor, pad_batch
from pointnet12_tpu_torch.kernels import build, selfcheck
from pointnet12_tpu_torch.kernels import ballquery_cuda as ballquery_module
from pointnet12_tpu_torch.kernels.ballquery_cuda import (
    ballquery_cuda, ballquery_plan, first_k_in_plan_order,
)
from pointnet12_tpu_torch.kernels.bn_stats_cuda import dense_bn_stats_cuda, stats_in_kernel_order
from pointnet12_tpu_torch.kernels.fps_cuda import THREADS, fps_cuda, fps_plan
from pointnet12_tpu_torch.kernels.fused_sa_cuda import (
    fused_sa_eval_dense_cuda, fused_sa_eval_grid_cuda,
)
from pointnet12_tpu_torch.kernels import grid_cuda as grid_module
from pointnet12_tpu_torch.kernels.grid_cuda import Grid, ballquery_grid_cuda, grid_prep_cuda
from pointnet12_tpu_torch.kernels.segsum_cuda import segment_matmul_cuda
from pointnet12_tpu_torch.kernels.threenn_cuda import (
    three_nn_cuda, three_nn_in_plan_order, three_nn_plan,
)
from pointnet12_tpu_torch.models import get_model, model_precision_kwargs
from pointnet12_tpu_torch.nn import mlp as port_mlp
from pointnet12_tpu_torch.ops import ballquery as ops_ballquery
from pointnet12_tpu_torch.ops import interpolate as ops_interpolate
from pointnet12_tpu_torch.ops.ballquery import ballquery_torch
from pointnet12_tpu_torch.ops.bn_stats import dense_bn_stats_torch
from pointnet12_tpu_torch.ops.distance import square_distance
from pointnet12_tpu_torch.ops.fps import fps_torch
from pointnet12_tpu_torch.ops.fused_sa import fused_sa_eval_torch
from pointnet12_tpu_torch.ops.gather import index_points
from pointnet12_tpu_torch.ops.grid import G as GRID_RES, cell_offsets_torch, grid_prep, grid_prep_torch
from pointnet12_tpu_torch.ops.interpolate import three_nn_torch
from pointnet12_tpu_torch.ops.segsum import segment_matmul_torch
from pointnet12_tpu_torch.train import loop
from pointnet12_tpu_torch.train.losses import segmentation_loss

B, N, C, CLASSES, K = 16, 4096, 9, 13, 32
N_GRID = 8192  # Path G's clouds: SA1 takes the grid ball query
SA = [(1024, 0.1), (256, 0.2), (64, 0.4), (16, 0.8)]  # (npoint, radius)
KERNELS = {
    # levels: the SA level (index into SA) of each of a forward's 4
    # launches, in launch order; the decoder runs FP4 (level 3) first.
    # forward / step / fused_step / fused_forward / grid_forward: launches
    # per eval forward (fp32 or bf16), per fp32 train step, per bf16+SR
    # train step with the fused BN statistics, per forward of Path F
    # (impl="fused", N=4096) and per forward of Path G (N=8192).
    "fps": dict(
        wrapper=fps_cuda, kernel="fps_kernel", levels=(0, 1, 2, 3),
        forward=4, step=4, fused_step=4, fused_forward=4, grid_forward=4,
        source="pointnet12_tpu_torch/csrc/fps.cu",
        replaces="pointnet12_tpu/kernels/fps_pallas.py:82",
    ),
    "ballquery": dict(
        wrapper=ballquery_cuda, kernel="ballquery_kernel", levels=(0, 1, 2, 3),
        forward=4, step=4, fused_step=4, fused_forward=0, grid_forward=3,
        source="pointnet12_tpu_torch/csrc/ballquery.cu",
        replaces="pointnet12_tpu/kernels/ballquery_bitmask.py:273",
        also_replaces="pointnet12_tpu/kernels/ballquery_pallas.py:122",
    ),
    "three_nn": dict(
        wrapper=three_nn_cuda, kernel="three_nn_kernel", levels=(3, 2, 1, 0),
        forward=4, step=4, fused_step=4, fused_forward=4, grid_forward=4,
        source="pointnet12_tpu_torch/csrc/threenn.cu",
        replaces="pointnet12_tpu/kernels/threenn_pallas.py:105",
    ),
    # the backward only: d ref of FP4-FP1 and d points of SA2-SA4
    "segment_matmul": dict(
        wrapper=segment_matmul_cuda, kernel="segment_matmul_kernel",
        forward=0, step=7, fused_step=7, fused_forward=0, grid_forward=0,
        source="pointnet12_tpu_torch/csrc/segsum.cu",
        replaces="pointnet12_tpu/kernels/segsum_pallas.py:160",
    ),
    # the train forward with fused_bn_stats: dense_1, dense_2 of SA1-SA4,
    # then every layer of FP4-FP1 (bn_calls(), in launch order); both
    # dtypes run dense_bn_stats_mma, on the tensor cores
    "dense_bn_stats": dict(
        wrapper=dense_bn_stats_cuda, kernel="dense_bn_stats_mma",
        forward=0, step=0, fused_step=17, fused_forward=0, grid_forward=0,
        source="pointnet12_tpu_torch/csrc/bn_stats.cu",
        replaces="pointnet12_tpu/kernels/bn_stats_fused.py:144",
    ),
    # the whole grid prep (bounds, keys, the two stable sorts, the offsets
    # table) in one launch: SA1 of Path F (the grid fused layer) and of
    # Path G (the grid ball query)
    "grid_prep": dict(
        wrapper=grid_prep_cuda, kernel="grid_prep_kernel",
        forward=0, step=0, fused_step=0, fused_forward=1, grid_forward=1,
        source="pointnet12_tpu_torch/csrc/grid_prep.cu",
        replaces="pointnet12_tpu/kernels/ballquery_grid.py:209",
        also_replaces="pointnet12_tpu/kernels/ballquery_grid.py:242-315",
    ),
    "ballquery_grid": dict(
        wrapper=ballquery_grid_cuda, kernel="ballquery_grid_kernel",
        forward=0, step=0, fused_step=0, fused_forward=0, grid_forward=1,
        source="pointnet12_tpu_torch/csrc/ballquery_grid.cu",
        replaces="pointnet12_tpu/kernels/ballquery_grid.py:353",
    ),
    # Path F: SA2, SA3, SA4 in launch order
    "fused_sa_dense": dict(
        wrapper=fused_sa_eval_dense_cuda, kernel="fused_sa_dense_kernel",
        forward=0, step=0, fused_step=0, fused_forward=3, grid_forward=0,
        source="pointnet12_tpu_torch/csrc/fused_sa.cu",
        replaces="pointnet12_tpu/kernels/fused_sa_eval.py:163",
    ),
    "fused_sa_grid": dict(
        wrapper=fused_sa_eval_grid_cuda, kernel="fused_sa_grid_kernel",
        forward=0, step=0, fused_step=0, fused_forward=1, grid_forward=0,
        source="pointnet12_tpu_torch/csrc/fused_sa.cu",
        replaces="pointnet12_tpu/kernels/fused_sa_eval.py:452",
    ),
}
SERVE = [name for name, k in KERNELS.items() if k["forward"]]
NEW = ("grid_prep", "ballquery_grid", "fused_sa_dense", "fused_sa_grid")
FUSED = ("fused_sa_dense", "fused_sa_grid")
PLAIN = {"fps": fps_torch, "ballquery": ballquery_torch, "three_nn": three_nn_torch,
         "segment_matmul": segment_matmul_torch, "dense_bn_stats": dense_bn_stats_torch,
         "grid_prep": grid_prep_torch, "ballquery_grid": ballquery_torch,
         "fused_sa_dense": fused_sa_eval_torch, "fused_sa_grid": fused_sa_eval_torch}


def bn_calls():
    """(label, x shape, Co) of the 17 dense_bn_stats calls of a fused train
    step, in launch order: the grouped (B, S, K, C) layers of SA1-SA4, then
    the (B, N, C) layers of FP4-FP1."""
    return [
        (f"SA{level} dense_{j}", (B, s, K, mlp[j - 1]), mlp[j])
        for level, s, mlp in ((1, 1024, (32, 32, 64)), (2, 256, (64, 64, 128)),
                              (3, 64, (128, 128, 256)), (4, 16, (256, 256, 512)))
        for j in (1, 2)
    ] + [
        (f"FP{level} dense_{j}", (B, n, widths[j]), widths[j + 1])
        for level, n, widths in ((4, 64, (768, 256, 256)), (3, 256, (384, 256, 256)),
                                 (2, 1024, (320, 256, 128)), (1, N, (128, 128, 128, 128)))
        for j in range(len(widths) - 1)
    ]


D2_ATOL = 1e-5  # direct vs expansion form of values in [0, 3]
# of each call's largest |value|: no looser than tests/test_kernels.py:285
# (rtol and atol 1e-5) where the values are under 1
SEGSUM_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 5e-5  # tests/test_train_parity.py:136-152
FUSED_ATOL = 5e-4  # the fused layers' bar, tests/test_kernels.py:321-426
TRAIN_STEPS = 10
CROSSOVER_N = (4096, 8192, 16384)  # the ball-query routes' curve, S = N / 4
HOST_REPS = 1000  # calls of each part of the launch path
# of the largest mean |y| and E[y^2] over the columns: the kernel's statistics
# against the plain one-pass form of its own y (fp32 sums in other orders)
BN_STATS_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 op/s outside
# the tensor cores, bf16 and TF32 op/s on the tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
BF16_OPS_PER_S, TF32_OPS_PER_S = 989e12, 495e12
# the kernels redesigned for the tensor cores, by a part of the (mangled)
# name their SASS functions carry: each must hold HMMA (mma.sync) or HGMMA
# (wgmma). dense_bn_stats_mma<unsigned short, BN> is the bf16 route ("It"),
# dense_bn_stats_mma<float, BN> the fp32 route ("If", three TF32 products).
TENSOR_CORE_KERNELS = ("dense_bn_stats_mmaIt", "dense_bn_stats_mmaIf", "fused_sa_dense_kernel",
                       "fused_sa_grid_kernel")


class SmokeFailure(RuntimeError):
    pass


def log(*args):
    print(*args, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters, warmup=2):
    """Mean device milliseconds of ``fn()`` over ``iters`` runs (CUDA events,
    after ``warmup`` runs)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters, rounds=4):
    """Median ms of each of ``fns`` (CUDA events, :func:`time_ms` of
    ``iters`` calls), timed in turns over ``rounds`` rounds whose order
    alternates (a, b, b, a, ...), so that a drift of the host's pace falls
    on both alike."""
    times = [[] for _ in fns]
    for k in range(rounds):
        for i in (range(len(fns)) if k % 2 == 0 else reversed(range(len(fns)))):
            times[i].append(time_ms(fns[i], iters=iters))
    return [statistics.median(t) for t in times]


def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this check runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return torch.device("cuda:0"), smi


def cuobjdump():
    """The CUDA toolkit's ``cuobjdump``: on PATH, else beside ``nvcc``."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidate = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    require(os.path.exists(candidate), "cuobjdump not found on PATH or beside nvcc")
    return candidate


def sass_mma_counts(path):
    """``{function: count}`` of the HMMA (mma.sync) and HGMMA (wgmma)
    instructions in the SASS of each kernel of the library at ``path``."""
    sass = subprocess.run([cuobjdump(), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def phase_build():
    """The nvcc build; ptxas's register and shared-memory report of every
    kernel; for each kernel redesigned for the tensor cores its ptxas
    report again and its count of HMMA/HGMMA instructions in the SASS
    (``cuobjdump -sass``): it fails if one holds none."""
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    # the bf16 path needs fp32 accumulation in cuBLAS's bf16 matmuls
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    path, seconds, nvcc_log = build.build()
    build.library()
    log(f"[build] {path.name}: {seconds:.2f} s"
        + (" (cached)" if not nvcc_log and seconds == 0.0 else ""))
    lines = [line.strip() for line in nvcc_log.splitlines()]
    for line in lines:
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line}")
    # ptxas prints each entry's name, its properties (stack, spills), then
    # its registers and shared memory
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in TENSOR_CORE_KERNELS):
            report = "; ".join(x.removeprefix("ptxas info    : ") for x in lines[i + 2:i + 4])
            log(f"[build] tensor cores: {line.split(chr(39))[1]} ptxas: {report}")
    counts = sass_mma_counts(path)
    for kernel in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in counts.items() if kernel in fn}
        require(found, f"[build] no SASS function for {kernel}")
        for fn, n in found.items():
            log(f"[build] tensor cores: {n} HMMA/HGMMA instructions in the SASS of {fn}")
            require(n > 0, f"[build] {fn} holds no HMMA or HGMMA instruction")


def level_clouds(dev, gen):
    """The xyz of every level of the slice: l0 (B, 4096, 3) unit-cube
    clouds, l1..l4 their FPS subsamples, as the model makes them."""
    levels = [torch.rand(B, N, 3, generator=gen).to(dev)]
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    for npoint, _ in SA:
        idx = fps_torch(levels[-1], npoint, start)
        levels.append(index_points(levels[-1], idx).contiguous())
    return levels


def check_call(phase, name, args, got, want=None):
    """Hold one kernel call's output ``got`` against its plain version on
    the same ``args`` (``want``, where the caller already has it): FPS
    indices and the grid prep's five tensors exact,
    ball-query rows (scan or grid) exact off the radius boundary, fused SA
    rows within ``FUSED_ATOL`` off it, 3-NN rows exact off distance ties
    and d2 within ``D2_ATOL``, segment sums within ``SEGSUM_TOL`` of the
    call's largest value (atomics add in no fixed order). Logs the counts, fails on any
    unmasked mismatch, and returns the max abs error off the masked rows."""
    want = PLAIN[name](*args) if want is None else want
    if name == "fps":
        xyz, npoint, _ = args
        label = f"fps N={xyz.shape[1]} S={npoint}"
        bad = int((got != want).sum())
        err = float((got - want).abs().max())
        report = f"{bad} mismatched indices"
    elif name == "grid_prep":
        _, xyz, centers = args[:3]
        label = f"grid_prep B={xyz.shape[0]} N={xyz.shape[1]} S={centers.shape[1]}"
        diffs = {key: int((got[key] != want[key]).sum()) for key in want}
        require(all(got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
                    for key in want), f"[{phase}] {label}: shapes or dtypes differ")
        bad = sum(diffs.values())
        err = max(float((got[key] - want[key]).abs().max()) for key in want)
        report = "mismatched " + ", ".join(f"{key} {d}" for key, d in diffs.items())
    elif name in FUSED:
        radius, _, xyz, centers, w, _, layers = args
        label = (f"{name} N={xyz.shape[1]} S={centers.shape[1]} r={radius} "
                 f"C1={w.shape[2]} -> {layers[-1][0].shape[1]}")
        ok = selfcheck.boundary_ok_mask(radius, xyz, centers)
        diff = (got - want).abs().amax(-1)
        bad = int(((diff > FUSED_ATOL) & ok).sum())
        err = float((diff * ok).max())
        report = (f"{int((~ok).sum())} of {ok.numel()} rows masked, max |err| off them "
                  f"{err:.3e}, {bad} rows over {FUSED_ATOL}")
    elif name in ("ballquery", "ballquery_grid"):
        radius, _, xyz, centers = args
        label = f"{name} N={xyz.shape[1]} S={centers.shape[1]} r={radius}"
        ok = selfcheck.boundary_ok_mask(radius, xyz, centers)
        rows_bad = (got != want).any(-1)
        bad = int((rows_bad & ok).sum())
        err = float(((got - want).abs().amax(-1) * ok).max())
        report = (f"{int((~ok).sum())} of {ok.numel()} rows masked, "
                  f"{int(rows_bad.sum())} rows differ, {bad} unmasked")
    elif name == "segment_matmul":
        idx, weights, values, m = args
        label = f"segment_matmul {segsum_label(idx.shape[1], m)}"
        err, bad, report = segsum_error(got, want)
        report = (f"J={idx.shape[1]} R={idx.shape[2]} M={m} C={values.shape[2]}"
                  f"{' weighted' if weights is not None else ''}: {report}")
    elif name == "dense_bn_stats":
        x, weight, _ = args
        label = (f"dense_bn_stats {str(x.dtype).removeprefix('torch.')} "
                 f"x {tuple(x.shape)} Co={weight.shape[0]}")
        err, bad, report = bn_stats_error(args, got, want)
    else:
        query, ref = args
        label = f"three_nn N={query.shape[1]} M={ref.shape[1]}"
        (d, i), (wd, wi) = got, want
        ok = selfcheck.tie_ok_mask(query, ref)
        rows_bad = (i != wi).any(-1)
        bad = int((rows_bad & ok).sum())
        err = float((d - wd).abs().max())
        report = (f"{int((~ok).sum())} of {ok.numel()} rows masked, "
                  f"{int(rows_bad.sum())} rows differ, {bad} unmasked; "
                  f"max |d2 err| {err:.3e}")
        require(err <= D2_ATOL, f"[{phase}] {label}: d2 error {err}")
    log(f"[{phase}] {label}: {report}")
    require(bad == 0, f"[{phase}] {label}: {bad} unmasked mismatches")
    if name in ("ballquery", "three_nn", "ballquery_grid"):
        check_order_model(phase, name, args, got)
    return err


def r2_of(radius):
    """``radius * radius`` rounded to f32 once, as the wrappers pass it."""
    return torch.tensor(radius * radius, dtype=torch.float32).item()


def check_order_model(phase, name, args, got, plan=None):
    """Hold a call of ``ballquery.cu``, ``threenn.cu`` or
    ``ballquery_grid.cu`` bit for bit, on every row and with no mask,
    against its order model at ``plan`` (by default the wrapper's):
    ``first_k_in_plan_order`` or ``three_nn_in_plan_order``, the kernel's
    per-range results and merge in plain ops on the same direct-form
    distances; for the grid kernel, whose rows are the contract at any of
    its plans, ``first_k_in_plan_order`` over one range of all N points.
    Fails on any differing row."""
    if name in ("ballquery", "ballquery_grid"):
        radius, k, xyz, centers = args
        b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
        plan = (ballquery_plan(b, n, s, k, per_lane=0) if name == "ballquery_grid"
                else plan or ballquery_plan(b, n, s, k))
        want = first_k_in_plan_order(xyz, centers, r2_of(radius), k, plan)
        differ = (got != want).any(-1)
        label = f"B={xyz.shape[0]} N={xyz.shape[1]} S={centers.shape[1]} K={k} r={radius}"
    else:
        query, ref = args
        plan = plan or three_nn_plan(query.shape[0], query.shape[1], ref.shape[1])
        (d, i), (wd, wi) = got, three_nn_in_plan_order(query, ref, plan)
        differ = ((d != wd) | (i != wi)).any(-1)
        label = f"B={query.shape[0]} N={query.shape[1]} M={ref.shape[1]}"
    bad = int(differ.sum())
    model = ("the contract (the order model over one range)" if name == "ballquery_grid"
             else f"order model at {plan_label(plan)}")
    log(f"[{phase}] {name} {label}: {model}: {differ.numel() - bad} of {differ.numel()} "
        "rows equal")
    require(bad == 0, f"[{phase}] {name} {label}: {bad} rows differ from the order model")


def segsum_error(got, want):
    """``(max abs error, elements outside the bar, report)`` of a segment
    sum against its plain version. The bar is ``SEGSUM_TOL`` of the call's
    largest |value| (of 1 where that is larger): the train step's sums are
    gradients of a mean over B*N points, far below 1, so a fixed atol of
    1e-5 would sit above most of their elements."""
    diff, mag = (got - want).abs(), want.abs()
    largest = float(mag.max())
    tol = SEGSUM_TOL * min(1.0, largest)
    bad = int((diff > tol).sum())
    err = float(diff.max())
    return err, bad, (f"max |err| {err:.3e}, |value| largest {largest:.3e} median "
                      f"{float(mag.median()):.3e}, {bad} outside {tol:.3e} "
                      f"({SEGSUM_TOL} of the largest)")


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps of two bf16 tensors (bit patterns
    mapped onto a signed line, so -0 == +0)."""
    def line(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def one_pass_stats(y):
    """The plain version's one-pass statistics of ``y`` (as
    ``ops/bn_stats.py`` takes them) and, per column, mean |y| and E[y^2]."""
    yf = y.float().reshape(-1, y.shape[-1])
    r = yf.shape[0]
    mean = yf.sum(0) / r
    sq = (yf * yf).sum(0) / r
    return mean, torch.clamp_min(sq - mean * mean, 0.0), yf.abs().mean(0), sq


def bf16_ulp(v):
    """The spacing of bf16 values at each element of ``v``."""
    _, exp = torch.frexp(v.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), exp - 8)


def bn_stats_error(args, got, want):
    """``(max abs error of y, elements outside the bars, report)`` of a
    dense_bn_stats call against its plain version on the same inputs.

    fp32 y within ``SEGSUM_TOL`` (1e-5) of the call's largest |y|. bf16 y
    within one ulp of the rounded product plus one ulp of y: the fp32
    products sum in other orders, so a product near a bf16 rounding
    boundary rounds one ulp either way, and where the bias cancels part
    of the product that one ulp is several of y's; y's own rounding adds
    one more. The shares at one ulp of y and beyond are logged.

    The statistics are held to the plain one-pass form of the kernel's OWN
    y, within ``BN_STATS_TOL`` of the largest mean |y| (mean) and E[y^2]
    (var) over the columns: that isolates the fused sums from the y
    flips; the gap to the plain version's statistics is logged beside."""
    x, weight, _ = args
    (y, mean, var), (wy, wmean, wvar) = got, want
    largest = float(wy.abs().max())
    diff = (y.float() - wy.float()).abs()
    err = float(diff.max())
    if y.dtype == torch.bfloat16:
        product = (x.float() @ weight.float().T).to(torch.bfloat16)
        bad = int((diff > bf16_ulp(product) + bf16_ulp(wy)).sum())
        ulps = bf16_ulps(y, wy)
        y_report = (f"y {float((ulps == 1).float().mean()):.3e} at 1 ulp, "
                    f"{int((ulps > 1).sum())} beyond (largest {int(ulps.max())}), "
                    f"{bad} outside the bar")
    else:
        bad = int((diff > SEGSUM_TOL * largest).sum())
        y_report = f"y max |err| {err:.3e} of largest {largest:.3e}, {bad} outside"
    own_mean, own_var, abs_mean, sq = one_pass_stats(y)
    m_bar = BN_STATS_TOL * float(abs_mean.max())
    v_bar = BN_STATS_TOL * float(sq.max())
    m_err = float((mean - own_mean).abs().max())
    v_err = float((var - own_var).abs().max())
    bad += int(m_err > m_bar) + int(v_err > v_bar)
    report = (f"{y_report}; mean {m_err:.3e} (bar {m_bar:.3e}), var {v_err:.3e} "
              f"(bar {v_bar:.3e}) against its own y; against the plain statistics "
              f"mean {float((mean - wmean).abs().max()):.3e}, var "
              f"{float((var - wvar).abs().max()):.3e}")
    return err, bad, report


def same_bits(a, b):
    """Whether two tensors hold the same bits (so -0 != +0 and NaN == NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def bn_stats_bounds(x, co):
    """The least time of one dense_bn_stats call: x, W and y once, the fp32
    bias, mean and var; 2 ops a product term, 4 an output (bias, y^2, two
    sums). bf16: every op at the 989 TFLOP/s of the tensor cores. fp32 two
    bounds, as ``fused_bounds`` gives the fused layers: every op at the
    SIMT rate, or the products as three TF32 products on the tensor cores
    beside the other ops at the SIMT rate; the least time is the lower.
    -> ``{bound_ms, bound_by}`` (fp32 also ``bound_simt_ms``,
    ``bound_tc_ms``)."""
    r, ci = x.numel() // x.shape[-1], x.shape[-1]
    nbytes = x.element_size() * (r * ci + co * ci + r * co) + 4 * 3 * co
    products, other = 2 * r * ci * co, 4 * r * co
    if x.dtype == torch.bfloat16:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (products + other) / BF16_OPS_PER_S * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    simt, tc = fused_bounds(nbytes, products, other)
    least = min(simt, tc)
    return {"bound_ms": least[0], "bound_by": least[1], "bound_simt_ms": simt[0],
            "bound_tc_ms": tc[0]}


def bn_stats_inputs(shape, co, dtype, mean3, gen):
    """Seeded operands of one call on the card: activation scale (x a ReLU
    of a normal, He-scaled W, bias 0.1 N(0, 1)), or with ``mean3`` every
    column of y at mean 3 standard deviations off zero (x normal, bias 3
    times the column's |W|): the one-pass variance's hard case."""
    dev = gen.device
    x = torch.randn(shape, generator=gen, device=dev)
    if not mean3:
        x = x.relu_()
    w = torch.randn((co, shape[-1]), generator=gen, device=dev) * (2.0 / shape[-1]) ** 0.5
    b = (3.0 * w.norm(dim=1) if mean3
         else 0.1 * torch.randn((co,), generator=gen, device=dev))
    return x.to(dtype), w.to(dtype), b.float()


def phase_bn_kernel(dev, smi):
    """dense_bn_stats against its plain version at the 17 shapes of the
    fused train step, in fp32 and bf16, at activation scale and at mean/std
    3 (``bn_stats_error``'s bars), then timed at each: the wrapper, its
    plain version, ``F.linear`` alone (cuBLAS, the product only: the
    yardstick), ``F.linear`` plus the plain one-pass statistics, and the
    bound (CUDA events). Also the SR cast: the card's bits equal the
    CPU's."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((B, 1024, 32), generator=gen, device=dev) * 3
    for seed in (0, 2654435761, 2**32 - 1):
        same = torch.equal(port_mlp.sr_to_bf16(x, seed).cpu().view(torch.int16),
                           port_mlp.sr_to_bf16(x.cpu(), seed).view(torch.int16))
        require(same, f"sr_to_bf16 seed {seed}: the card's bits differ from the CPU's")
    log("[bn kernel] sr_to_bf16 on the card equals the CPU bit for bit (3 seeds)")

    err = 0.0
    times = {d: {k: [] for k in ("ms", "plain_ms", "linear_ms", "linear_device_ms",
                                 "linear_stats_ms", "bound_ms", "bound_by")
                 + (("bound_simt_ms", "bound_tc_ms") if d == "fp32" else ())}
             for d in ("bf16", "fp32")}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for label, shape, co in bn_calls():
            for mean3 in (False, True):
                args = bn_stats_inputs(shape, co, dtype, mean3, gen)
                got = dense_bn_stats_cuda(*args)
                e = check_call("bn kernel", "dense_bn_stats", args, got)
                err = max(err, e)
                require(all(same_bits(a, b) for a, b in zip(got, dense_bn_stats_cuda(*args))),
                        f"[bn kernel] {dname} {label}: y, mean or var differ between two "
                        "launches on the same inputs")
                # the kernel's fixed order, modelled in plain ops
                model = stats_in_kernel_order(got[0])
                require(same_bits(got[1], model[0]) and same_bits(got[2], model[1]),
                        f"[bn kernel] {dname} {label}: the statistics differ from the sums in "
                        "the kernel's order (stats_in_kernel_order) of its own y")
            log(f"[bn kernel] {dname} {label}: y, mean and var the same bits over two "
                "launches (both input kinds); mean and var the bits of "
                "stats_in_kernel_order of the kernel's y")
            xx, w, b = args

            def linear_stats():
                y = F.linear(xx, w) + (b if dtype == torch.float32 else b.to(dtype))
                return one_pass_stats(y)

            bounds = bn_stats_bounds(xx, co)
            linear_dev = call_device_ms(f"{dname} {label} F.linear", lambda: F.linear(xx, w))
            entry = {
                "ms": time_ms(lambda: dense_bn_stats_cuda(xx, w, b), iters=20),
                "plain_ms": time_ms(lambda: dense_bn_stats_torch(xx, w, b), iters=10),
                "linear_ms": time_ms(lambda: F.linear(xx, w), iters=20),
                "linear_device_ms": None if linear_dev is None else linear_dev[0],
                "linear_stats_ms": time_ms(linear_stats, iters=10),
                **bounds,
            }
            for key, value in entry.items():
                times[dname][key].append(value)
            log(f"[bn times] {dname} {label} x {shape} Co={co}: wrapper "
                f"{entry['ms'] * 1e3:.1f} us, plain {entry['plain_ms'] * 1e3:.1f} us, "
                f"F.linear {entry['linear_ms'] * 1e3:.1f} us ("
                + ("device not measured" if linear_dev is None
                   else f"{entry['linear_device_ms'] * 1e3:.1f} us on the device")
                + "), F.linear + stats "
                f"{entry['linear_stats_ms'] * 1e3:.1f} us, bound "
                f"{entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']}"
                + ("" if dtype == torch.bfloat16 else
                   f"; SIMT {entry['bound_simt_ms'] * 1e3:.2f}, tensor cores "
                   f"{entry['bound_tc_ms'] * 1e3:.2f}") + f") ({smi})")
            del args, xx, w, b
    for dname, t in times.items():
        lin_dev = (None if None in t["linear_device_ms"] else sum(t["linear_device_ms"]))
        log(f"[bn times] {dname} sum over the 17 shapes: wrapper {sum(t['ms']):.3f} ms, "
            f"plain {sum(t['plain_ms']):.3f} ms, F.linear {sum(t['linear_ms']):.3f} ms ("
            + ("device not measured" if lin_dev is None else f"{lin_dev:.3f} ms on the device")
            + "), "
            f"F.linear + stats {sum(t['linear_stats_ms']):.3f} ms, bound "
            f"{sum(t['bound_ms']):.3f} ms"
            + (f" (SIMT {sum(t['bound_simt_ms']):.3f}, tensor cores "
               f"{sum(t['bound_tc_ms']):.3f})" if dname == "fp32" else "") + f" ({smi})")
    return err, times


def phase_kernels(dev, levels):
    """Each kernel against its plain version at every slice shape."""
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    err = {name: 0.0 for name in KERNELS}
    for level, (npoint, radius) in enumerate(SA):
        xyz, centers = levels[level], levels[level + 1]
        calls = {
            "fps": (xyz, npoint, start),
            "ballquery": (radius, K, xyz, centers),
            # FP at this level: the fine points query the coarse ones
            "three_nn": (xyz, centers),
        }
        for name, args in calls.items():
            got = KERNELS[name]["wrapper"](*args)
            err[name] = max(err[name], check_call("kernels", name, args, got))

    # every point twice: each argmax ties with a twin, the lower index wins
    twins = torch.cat([levels[1], levels[1]], dim=1).contiguous()
    args = (twins, 512, start)
    log("[kernels] fps on twinned points (every argmax a tie):")
    check_call("kernels", "fps", args, fps_cuda(*args))
    torch.cuda.synchronize()
    return err


def random_state_dict(model, gen):
    """Weights from a seeded generator: He-scaled matmuls, BN affine and
    running statistics away from their 1/0/0/1 init."""
    sd = {}
    for key, v in model.state_dict().items():
        shape, leaf = v.shape, key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = v
        elif leaf == "weight" and v.dim() == 2:
            sd[key] = torch.randn(shape, generator=gen) * (2.0 / shape[1]) ** 0.5
        elif leaf == "weight":  # BN scale
            sd[key] = 1.0 + 0.2 * torch.randn(shape, generator=gen)
        elif leaf == "running_var":
            sd[key] = 0.5 + torch.rand(shape, generator=gen)
        else:  # biases, running_mean
            sd[key] = 0.1 * torch.randn(shape, generator=gen)
    return sd


def logit_err(got, want):
    err = (got.float() - want.float()).abs().amax(-1).flatten()
    return float(torch.quantile(err, 0.99)), float(err.median())


def parity(phase, name, got, want):
    p99, med = logit_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[{phase}] {name}: p99 {p99:.3e}, median {med:.3e}, "
        f"labels agree {agree:.5f}")
    return p99, med, agree


def check_parity(phase, name, got, want):
    """The bars of tests/test_parity.py:128-132."""
    p99, med, _ = parity(phase, name, got, want)
    require(p99 < 1e-3 and med < 1e-4, f"{name}: p99 {p99}, median {med}")


def grid_clouds(n_clouds, gen, n=None):
    """(n_clouds, n, 9) clouds whose xyz lie on a 1/64 grid of the unit
    cube. There both distance forms (the kernels' direct, the plain
    versions' expansion) are exact, so both paths must make the same
    neighbour decisions and any gap between their log-probs is a fault."""
    n = N if n is None else n
    pts = torch.rand(n_clouds, n, C, generator=gen)
    pts[..., :3] = torch.randint(0, 64, (n_clouds, n, 3), generator=gen) / 64.0
    return pts.numpy()


def zero_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_launches(phase, count, key, unit="forwards"):
    """Every kernel's launches since ``zero_launches()``, held to
    ``KERNELS[name][key]`` for each of ``count`` forwards (or steps)."""
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    log(f"[{phase}] {count} {unit}, launches {launches}")
    for name, got in launches.items():
        want = KERNELS[name][key]
        require(got == want * count,
                f"[{phase}] {name}: {got} launches in {count} {unit}, want {want} each")
    return launches


def check_log_probs(phase, outs, shapes):
    """Log-probs of the given shapes, finite, each row summing to 1."""
    for out, shape in zip(outs, shapes, strict=True):
        require(tuple(out.shape) == shape, f"[{phase}] shape {tuple(out.shape)}, want {shape}")
        require(bool(torch.isfinite(out).all()), f"[{phase}] non-finite log-probs")
        require(bool(torch.allclose(out.exp().sum(-1), torch.ones((), device=out.device),
                                    atol=1e-4)), f"[{phase}] log-probs do not normalise")


def phase_slice(dev, gen):
    model = get_model("pointnet2_semseg", num_classes=CLASSES, device=dev)
    sd = random_state_dict(model, gen)
    model.load_state_dict(sd)
    pred = Predictor(model, dev)
    plain = Predictor.from_state_dict(
        "pointnet2_semseg", sd, CLASSES, device=dev, impl="torch"
    )
    requests = [grid_clouds(B, gen) for _ in range(4)]
    padded, n_valid = pad_batch(grid_clouds(5, gen), B)

    zero_launches()
    outs = [pred(r) for r in requests]
    outs.append(pred(padded)[:n_valid])
    launches = read_launches("slice", len(outs), "forward")
    check_log_probs("slice", outs, [(B, N, CLASSES)] * 4 + [(n_valid, N, CLASSES)])

    for i, req in enumerate(requests):
        check_parity("slice", f"request {i} kernel vs plain on the card", outs[i], plain(req))
    check_parity("slice", "short request kernel vs plain on the card", outs[4],
                 plain(padded)[:n_valid])
    cpu = Predictor.from_state_dict(
        "pointnet2_semseg", sd, CLASSES, device="cpu", impl="torch"
    )
    check_parity("slice", "2 clouds kernel path on the card vs the CPU",
                 outs[0][:2].cpu(), cpu(requests[0][:2]))
    for name, k in KERNELS.items():
        require(k["wrapper"].launches == launches[name],
                f"{name}: the plain path launched the kernel")
    return pred, plain, requests[0], launches, sd


@contextlib.contextmanager
def patched(replacements):
    """Set the module attributes ``{(module, name): value}`` for the
    duration of the block."""
    saved = {key: getattr(*key) for key in replacements}
    for (module, name), value in replacements.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for (module, name), value in saved.items():
            setattr(module, name, value)


def recording_wrappers(calls):
    """Stand-ins for the kernel wrappers that launch the real one and
    append ``(name, copies of args, output)`` to ``calls``. The ops import each
    wrapper from its module when they launch, so they find these; so does
    the wrapper's own ``<wrapper>.launches += 1``, which counts on the
    stand-in while it is in place."""
    def record(name, wrapper):
        def run(*args):
            out = wrapper(*args)
            # a snapshot: the optimizer updates a parameter argument in place
            calls.append((name, tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                                      else a for a in args), out))
            return out
        run.launches = 0
        run.kernel_name = name
        return run
    return {
        (sys.modules[k["wrapper"].__module__], k["wrapper"].__name__):
            record(name, k["wrapper"])
        for name, k in KERNELS.items()
    }


def recorded_forward(phase, fn, key, err):
    """``fn()`` with the recording wrappers in place: each kernel called and
    counted ``KERNELS[name][key]`` times, then every call held against its
    plain version (the checks of phase 3; ``err`` keeps each kernel's
    largest error). Returns the output and the calls."""
    calls = []
    stand_ins = recording_wrappers(calls)
    with patched(stand_ins):
        out = fn()
    torch.cuda.synchronize()
    counts = collections.Counter(name for name, _, _ in calls)
    log(f"[{phase}] kernel calls recorded: {dict(counts)}")
    for run in stand_ins.values():
        want = KERNELS[run.kernel_name][key]
        require(counts[run.kernel_name] == want and run.launches == want,
                f"[{phase}] {run.kernel_name}: {counts[run.kernel_name]} calls, "
                f"{run.launches} launches, want {want}")
    with torch.inference_mode():
        for name, args, got in calls:
            err[name] = max(err.get(name, 0.0), check_call(phase, name, args, got))
    return out, calls


def replayed_neighbours(calls):
    """Stand-ins for the plain ball query and 3-NN that return the kernel
    path's neighbour indices, recorded in ``calls``, for the same inputs;
    the 3-NN distances stay the plain expansion form, at those indices."""
    queue = {name: [c for c in calls if c[0] == name]
             for name in ("ballquery", "three_nn")}

    def ball(radius, nsample, xyz, new_xyz):
        _, args, idx = queue["ballquery"].pop(0)
        require(torch.equal(args[2], xyz) and torch.equal(args[3], new_xyz),
                "the plain path's ball-query inputs differ from the kernel path's")
        return idx

    def three(query, ref):
        _, args, (_, idx) = queue["three_nn"].pop(0)
        require(torch.equal(args[0], query) and torch.equal(args[1], ref),
                "the plain path's 3-NN inputs differ from the kernel path's")
        return square_distance(query, ref).gather(-1, idx.long()), idx

    return {(ops_ballquery, "ballquery_torch"): ball,
            (ops_interpolate, "three_nn_torch"): three}


def phase_continuous(gen, pred, plain):
    """A request of continuous uniform clouds. There a point within ~1e-7
    of a radius is decided either way by the two distance forms, and one
    such flip at SA2 moves about 1% of a cloud's log-probs, so the parity
    bars do not hold between the two paths as they stand. Instead: every
    kernel call of the forward meets the checks of phase 3 on its own
    inputs; the plain path on the kernel path's neighbours meets the bars;
    and the plain path on its own neighbours meets the median bar and
    agrees on 99% of the labels."""
    continuous = torch.rand(B, N, C, generator=gen).numpy()
    got, calls = recorded_forward("continuous", lambda: pred(continuous), "forward", {})
    with patched(replayed_neighbours(calls)):
        check_parity("continuous", "kernel path vs plain path on the kernel "
                     "path's neighbours", got, plain(continuous))
    _, med, agree = parity("continuous", "kernel path vs plain path on its "
                           "own neighbours", got, plain(continuous))
    require(med < 1e-4 and agree >= 0.99,
            f"continuous request: median {med}, labels agree {agree}")


def bound(nbytes, ops):
    """``(ms, "bytes" or "operations")``: the least time the card could take
    to move ``nbytes`` through device memory and do ``ops`` fp32 operations,
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scanned_pairs(radius, xyz, centers):
    """Pairs the index-order scan (``csrc/neighbours.cuh::first_k_scan``)
    reads on these clouds: a center scans warps of 32 points until K are
    in radius."""
    n = xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    found = (square_distance(centers, xyz) <= r2).cumsum(-1, dtype=torch.int32)
    reach = ((found < K).sum(-1) + 1).clamp(max=n)
    return int(((reach + 31) // 32 * 32).clamp(max=n).sum())


def grid_candidates(radius, xyz, centers):
    """Points the grid searches (``csrc/neighbours.cuh::first_k_grid`` of the
    fused grid layer, the walk of ``csrc/ballquery_grid.cu``) read on these
    clouds: those of the up to 27 cells around each center."""
    g = grid_prep(radius, xyz, centers, impl="torch")
    off, cell = g["offsets"].long(), g["sqkey"].long()
    res = GRID_RES
    qx, qy, qz = cell // (res * res), (cell // res) % res, cell % res
    z0, z1 = (qz - 1).clamp(min=0), (qz + 1).clamp(max=res - 1)
    total = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x, y = qx + dx, qy + dy
            inside = (x >= 0) & (x < res) & (y >= 0) & (y < res)
            base = (x.clamp(0, res - 1) * res + y.clamp(0, res - 1)) * res
            count = off.gather(1, base + z1 + 1) - off.gather(1, base + z0)
            total += int((count * inside).sum())
    return total


def serve_work(levels):
    """``{name: [(bytes, ops) per SA level]}`` of the serving kernels on this
    run's clouds: each input read once, each output written once."""
    work = {name: [] for name in SERVE}
    for level, (npoint, radius) in enumerate(SA):
        xyz, centers = levels[level], levels[level + 1]
        n, s = xyz.shape[1], centers.shape[1]
        # FPS: npoint passes over every point, ~10 ops a point (3 sub, 3 mul,
        # 2 add, the running min, the argmax compare)
        work["fps"].append((B * n * 12 + B * 4 + B * npoint * 4, 10 * B * npoint * n))
        # ball query: 9 ops a scanned pair (3 sub, 3 mul, 2 add, the compare)
        work["ballquery"].append(
            (B * (n + s) * 12 + B * s * K * 4, 9 * scanned_pairs(radius, xyz, centers))
        )
        # 3-NN (FP at this level: the n fine points query the s coarse ones):
        # every pair, 9 ops for the distance and one compare
        work["three_nn"].append((B * (n + s) * 12 + B * n * 3 * 8, 10 * B * n * s))
    return work


def phase_times(dev, levels, pred, plain, request, smi):
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    work = serve_work(levels)
    times = {name: {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": []}
             for name in SERVE}
    for level, (npoint, radius) in enumerate(SA):
        xyz, centers = levels[level], levels[level + 1]
        n = xyz.shape[1]
        pairs = {
            "fps": (lambda: fps_cuda(xyz, npoint, start),
                    lambda: fps_torch(xyz, npoint, start)),
            "ballquery": (lambda: ballquery_cuda(radius, K, xyz, centers),
                          lambda: ballquery_torch(radius, K, xyz, centers)),
            "three_nn": (lambda: three_nn_cuda(xyz, centers),
                         lambda: three_nn_torch(xyz, centers)),
        }
        for name, (kernel, plain_fn) in pairs.items():
            ms = time_ms(kernel, iters=50)
            plain_ms = time_ms(plain_fn, iters=3 if name == "fps" else 10)
            bound_ms, bound_by = bound(*work[name][level])
            for key, value in (("ms", ms), ("plain_ms", plain_ms),
                               ("bound_ms", bound_ms), ("bound_by", bound_by)):
                times[name][key].append(value)
            log(f"[times] {name} B={B} N={n} S/M={npoint}: kernel "
                f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}) ({smi})")

    # several windows in one call: the host sets the pace of a forward, so
    # one window alone says little; report the median and the spread
    x = torch.as_tensor(request, device=dev)
    for label, p, windows, iters in (("kernel path", pred, 9, 20),
                                     ("plain path", plain, 3, 2)):
        report_windows(f"Predictor {label}", lambda: p(x), windows, iters, "batch", smi)
    return times


def report_windows(label, fn, windows, iters, unit, smi, n=None):
    """Time ``fn`` over ``windows`` windows of ``iters`` calls (CUDA events,
    2 warm-up calls first) and log the median, min and max ms per call and
    the clouds/sec at the median. Returns the median."""
    ms = [time_ms(fn, iters=iters, warmup=2 if w == 0 else 0) for w in range(windows)]
    med = statistics.median(ms)
    log(f"[times] {label}: median {med:.3f} ms per {unit} of "
        f"{B}x{N if n is None else n}x{C} (min {min(ms):.3f}, max {max(ms):.3f} over "
        f"{windows} windows of {iters}), {B / med * 1e3:.1f} clouds/sec "
        f"({smi})")
    log(f"[times] {label} windows, ms: " + ", ".join(f"{m:.3f}" for m in ms))
    return med


def annotated_device_us(events, annotation, device):
    """Device µs of the kernels in ``device`` (a trace's measured events)
    launched inside the ``record_function`` ranges named ``annotation``:
    the host-side launch calls in those ranges give the correlation ids of
    their device events. Returns the µs, the ranges that launched one of
    them and their number."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == annotation]
    measured = {e.get("args", {}).get("correlation") for e in device}
    launches = [float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat", "").startswith("cuda_")
                and e.get("args", {}).get("correlation") in measured]
    ids = {e["args"]["correlation"] for e in events
           if e.get("ph") == "X" and e.get("cat", "").startswith("cuda_")
           and e.get("args", {}).get("correlation") in measured
           and any(a <= float(e["ts"]) <= b for a, b in spans)}
    inside = [e for e in device if e.get("args", {}).get("correlation") in ids]
    ranges = sum(any(a <= t <= b for t in launches) for a, b in spans)
    return sum(float(e["dur"]) for e in inside), ranges, len(inside)


def trace_device(fn, reps):
    """``(device events, host µs, trace events)`` of ``reps`` calls of
    ``fn`` (after one untraced call) in a torch.profiler (CUPTI) trace, the
    device events (kernels, copies, fills) sorted by start."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f).get("traceEvents", [])
    device = sorted((e for e in trace if e.get("ph") == "X"
                     and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    return device, wall_us, trace


def traced_window(label, fn, reps, pad, idle_s, per_call=None, attempts=3):
    """``(device events, host µs, trace events)`` of ``reps`` calls of ``fn``
    in a profiler trace that also holds ``pad`` calls before and after
    them and a few tiny fills at its two ends, so that they are neither
    the first nor the last thing the trace holds (a trace loses device
    events at its ends, more of them after long kernels). The measured calls
    are told apart on the device's own clock: the card is synchronized and
    left idle for ``idle_s`` before and after them, and their events are
    those between the trace's two longest gaps, each of which must exceed
    half of ``idle_s``; where ``per_call`` is given they must number
    ``per_call * reps``. (The host's clock cannot tell them apart: the
    trace's device times drift from it by up to milliseconds.) A trace
    that fails these checks, having lost events, is taken again, up to
    ``attempts`` times in all, as is one that holds no device events at
    all. The host µs span the measured calls and their synchronization.
    ``None`` without a card (a rehearsal on the CPU)."""
    wall = []

    def flush():
        # tiny fills at both ends of the trace, a quarter of the idle time
        # away: the events a trace loses at its ends are these first
        if torch.cuda.is_available():
            for _ in range(8):
                torch.zeros(1, device=torch.cuda.current_device())
        torch.cuda.synchronize()
        time.sleep(idle_s / 4)

    def run():
        flush()
        for _ in range(pad):
            fn()
        torch.cuda.synchronize()
        time.sleep(idle_s)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)
        time.sleep(idle_s)
        for _ in range(pad):
            fn()
        torch.cuda.synchronize()
        time.sleep(idle_s / 4)
        flush()

    for attempt in range(1, attempts + 1):
        device, _, trace = trace_device(run, 1)
        if not device and not torch.cuda.is_available():
            return None  # a rehearsal on the CPU: nothing to measure
        if not device:
            fault = "the trace holds no device events"
            log(f"[trace window] {label}: {fault} (attempt {attempt} of {attempts})")
            continue
        gaps, end = [], float(device[0]["ts"])
        for e in device:  # sorted by start; gaps[i] precedes device[i]
            gaps.append(float(e["ts"]) - end)
            end = max(end, float(e["ts"]) + float(e["dur"]))
        first, last = sorted(sorted(range(len(device)), key=gaps.__getitem__)[-2:])
        inside = device[first:last]
        log(f"[trace window] {label}: {len(inside)} device events between gaps of "
            f"{gaps[first] / 1e3:.1f} and {gaps[last] / 1e3:.1f} ms, {len(device)} in the "
            f"trace of {reps + 2 * pad} calls")
        fault = None
        if min(gaps[first], gaps[last]) <= idle_s * 0.5e6:
            fault = "the measured calls are not set apart by idle gaps"
        elif not inside or len(inside) % reps:
            fault = f"{len(inside)} device events for {reps} calls"
        elif per_call is not None and len(inside) != per_call * reps:
            fault = f"{len(inside) // reps} device events a call, want {per_call}"
        if fault is None:
            return inside, wall[-1], trace
        log(f"[trace window] {label}: {fault} (attempt {attempt} of {attempts})")
    raise SmokeFailure(f"[trace window] {label}: {fault}")


def profile_device(phase, fn, reps, unit, smi, annotations=None):
    """Device events of ``reps`` calls of ``fn``, one padding call on each
    side (:func:`traced_window`, 50 ms of idle card around the measured
    ones); logs the device busy time (the union of the kernel, copy and
    fill intervals), the idle share of the host's window and the device
    ops that take the time. ``None`` when the trace holds no device events.
    ``annotations``, a dict of ``record_function`` names, gets each one's
    device µs per call of ``fn`` and its share of the busy time."""
    window = traced_window(phase, fn, reps, pad=1, idle_s=0.05)
    if window is None:
        log(f"[{phase}] the trace holds no device events: device time not measured")
        return None
    device, wall_us, trace = window
    busy, end = 0.0, -1.0
    for e in device:
        start, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in device:
        name = e.get("name", "?")
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + float(e["dur"]), count + 1)
    log(f"[{phase}] per {unit}: device busy {busy / reps / 1e3:.3f} ms of "
        f"{wall_us / reps / 1e3:.3f} ms wall, idle share "
        f"{1 - busy / wall_us:.3f}, {len(device) / reps:.0f} device "
        f"events ({smi})")
    for name in annotations or {}:
        us, ranges, kernels = annotated_device_us(trace, name, device)
        annotations[name] = (us / reps, us / busy)
        log(f"[{phase}] {name}: {us / reps:.1f} us per {unit} on the device, "
            f"{us / busy:.3f} of the busy time ({ranges / reps:.0f} ranges, "
            f"{kernels / reps:.0f} device events per {unit})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (total, count) in top:
        log(f"[{phase}] {total / reps:9.1f} us/{unit}  {count / reps:5.1f}x  "
            f"{name[:90]}")
    return device


def launches_of(device, name, kernel=None):
    """The trace's launches of the kernel ``KERNELS[name]`` (or of the
    ``__global__`` function ``kernel``), in order; a template's name goes
    on with ``<``."""
    kernel = kernel or KERNELS[name]["kernel"]
    return [e for e in device
            if f"::{kernel}(" in e.get("name", "") or f"::{kernel}<" in e.get("name", "")]


def phase_profile(pred, request, smi):
    """Device busy time and kernel breakdown of 3 kernel-path forwards.
    Returns each serving kernel's device ms per launch at each SA level
    (``None`` when the trace holds no device events)."""
    x = torch.as_tensor(request, device=pred.device)
    forwards = 3
    device = profile_device("profile", lambda: pred(x), forwards, "forward", smi)
    if device is None:
        return None
    # a forward launches each ported kernel 4 times, in the order of
    # KERNELS[...]["levels"]
    device_ms = {}
    for name in SERVE:
        launches = launches_of(device, name)
        require(len(launches) == 4 * forwards,
                f"[profile] {name}: {len(launches)} launches in the trace")
        ms = [0.0] * len(SA)
        for j, e in enumerate(launches):
            ms[KERNELS[name]["levels"][j % 4]] += float(e["dur"]) / forwards / 1e3
        device_ms[name] = ms
        for level, (npoint, _) in enumerate(SA):
            log(f"[profile] {name} SA level {level + 1} (S/M={npoint}): "
                f"device {ms[level] * 1e3:.1f} us per launch ({smi})")
    return device_ms


# ---------------------------------------------------------------- training


def segsum_label(j, m):
    """Which backward of the train step sums J=j rows into m segments."""
    if j == 3:  # three_interpolate's d ref: M is the coarse level
        return {16: "FP4 d ref", 64: "FP3 d ref", 256: "FP2 d ref",
                1024: "FP1 d ref"}.get(m, f"J=3 M={m}")
    # the lifted first Dense's d points: M is the SA layer's input points
    return {1024: "SA2 d pts", 256: "SA3 d pts", 64: "SA4 d pts"}.get(m, f"J=1 M={m}")


def labelled_clouds(pts):
    """Labels that follow a rule of the coordinates, so the loss can fall:
    13 slabs across x + y."""
    return ((pts[..., 0] + pts[..., 1]) * (CLASSES / 2)).long().clamp(max=CLASSES - 1)


def phase_train(dev, gen):
    """The train path: 10 Adam steps on one fixed batch with random FPS
    starts and dropout 0.5 drawn from a card generator, launch counts read
    just after them, then the eval step on the same batch."""
    state = loop.create_train_state("pointnet2_semseg", CLASSES, device=dev, seed=0)
    points = torch.rand(B, N, C, generator=gen).to(dev)
    batch = {"points": points, "label": labelled_clouds(points)}
    card_gen = torch.Generator(device=dev).manual_seed(1)
    step = loop.make_train_step()

    zero_launches()
    losses = [float(step(state, batch, card_gen)["loss"]) for _ in range(TRAIN_STEPS)]
    launches = read_launches("train", TRAIN_STEPS, "step", "Adam steps")
    log("[train] losses " + ", ".join(f"{x:.5f}" for x in losses))
    require(all(math.isfinite(x) for x in losses), "a non-finite loss")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")

    zero_launches()
    metrics = loop.make_eval_step(CLASSES)(state, batch)
    eval_launches = read_launches("train", 1, "forward", "eval step")
    total = float(metrics["confusion"].sum())
    log(f"[train] eval step: loss {float(metrics['loss']):.5f}, accuracy "
        f"{float(metrics['accuracy']):.5f}, confusion sums to {total:.0f}, count "
        f"{float(metrics['count']):.0f}")
    require(total == B * N and float(metrics["count"]) == B * N,
            f"the eval confusion sums to {total}, want {B * N}")
    return state, batch, card_gen, launches, eval_launches


def phase_train_calls(state, batch, card_gen):
    """Every kernel call of one more train step against its plain version
    on the same inputs: the 7 segment sums within rtol/atol 1e-5, the point
    ops as in phase 3. Returns the segment sums' ``(args, out)`` in launch
    order and their largest abs error."""
    calls = []
    with patched(recording_wrappers(calls)):
        loop.make_train_step()(state, batch, card_gen)
    torch.cuda.synchronize()
    counts = collections.Counter(name for name, _, _ in calls)
    log(f"[train] kernel calls of one step: {dict(counts)}")
    for name, k in KERNELS.items():
        require(counts[name] == k["step"], f"{name}: {counts[name]} calls in a step")
    err = 0.0
    with torch.no_grad():
        for name, args, out in calls:
            e = check_call("train", name, args, out)
            if name == "segment_matmul":
                err = max(err, e)
    return [(args, out) for name, args, out in calls if name == "segment_matmul"], err


def phase_train_grads(dev, gen):
    """Gradients of one train-mode forward and backward, kernel path against
    plain path (impl="torch"), same weights, on 1/64-grid clouds (both
    distance forms exact, so both paths pick the same neighbours), FPS from
    index 0 and no dropout: every parameter within GRAD_ATOL + GRAD_RTOL of
    its largest plain gradient."""
    points = torch.as_tensor(grid_clouds(B, gen), device=dev)
    labels = labelled_clouds(points)
    result = {}
    for impl in ("auto", "torch"):
        model = loop.create_train_state(
            "pointnet2_semseg", CLASSES, device=dev, seed=0, dropout_rate=0.0, impl=impl
        ).model
        loss = segmentation_loss(model(points), labels)
        loss.backward()
        result[impl] = (float(loss.detach()), dict(model.named_parameters()))
    (loss_k, got), (loss_p, want) = result["auto"], result["torch"]
    ratios = {
        name: float((got[name].grad - p.grad).abs().max())
        / (GRAD_ATOL + GRAD_RTOL * float(p.grad.abs().max()))
        for name, p in want.items()
    }
    worst_name = max(ratios, key=ratios.get)
    worst = ratios[worst_name]
    log(f"[train] grid-cloud gradients, kernel vs plain path: loss {loss_k:.7f} vs "
        f"{loss_p:.7f}; worst parameter {worst_name} at {worst:.4f} of its bar "
        f"(atol {GRAD_ATOL} + rtol {GRAD_RTOL} of the largest), {len(want)} parameters")
    require(worst < 1.0, f"gradient of {worst_name} at {worst} of its bar")


def segsum_work(args):
    """(bytes, ops) of one segment sum: values, indices, weights read once,
    out written once; a multiply-add per element and contribution (an add
    when unweighted)."""
    idx, weights, values, m = args
    b, j, r = idx.shape
    c = values.shape[2]
    nbytes = 4 * (b * r * c + b * j * r * (1 if weights is None else 2) + b * m * c)
    return nbytes, (1 if weights is None else 2) * b * j * r * c


def sparse_operands(idx, weights, values, m):
    """The segment sum as one sparse product ``s @ dense``: ``s`` a
    (B*M, B*R) CSR matrix holding w[b,j,r] (1 when unweighted) at row
    b*M + idx[b,j,r], column b*R + r; ``dense`` the values as (B*R, C)."""
    b, j, r = idx.shape
    dev = values.device
    base = torch.arange(b, device=dev)[:, None, None]
    rows = (idx.long() + base * m).reshape(-1)
    cols = (torch.arange(r, device=dev) + base * r).expand(b, j, r).reshape(-1)
    vals = torch.ones(rows.shape, device=dev) if weights is None else weights.reshape(-1)
    s = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (b * m, b * r),
                                check_invariants=True)
    return s.coalesce().to_sparse_csr(), values.reshape(b * r, -1)


def segsum_extra_args(dev, gen):
    """``[(label, (idx, weights, values, m))]`` of the segment sum beyond the
    train step's 7 shapes, values at a gradient's scale (uniform in
    +-1e-3), weights in [0, 1) as the interpolation's: C of 1, 3, 6 and 130
    (the scalar form of the kernel); every index equal (the worst
    contention: all rows of a cloud into one segment); indices outside
    ``[0, M)``; one cloud. Each weighted (J=3) and unweighted (J=1)."""
    def make(b, j, r, c, m, lo=0, hi=None, equal=False, weighted=True):
        idx = torch.randint(lo, m if hi is None else hi, (b, j, r), generator=gen,
                            dtype=torch.int32)
        if equal:
            idx.fill_(m // 3)
        w = torch.rand((b, j, r), generator=gen) if weighted else None
        v = (torch.rand((b, r, c), generator=gen) * 2 - 1) * 1e-3
        return (idx.to(dev), None if w is None else w.to(dev), v.to(dev), m)

    cases = []
    for c in (1, 3, 6, 130):
        cases += [(f"C={c}, weighted", make(B, 3, 1024, c, 256)),
                  (f"C={c}, unweighted", make(B, 1, 2048, c, 512, weighted=False))]
    return cases + [
        ("every index equal, weighted", make(B, 3, 2048, 128, 512, equal=True)),
        ("every index equal, unweighted", make(B, 1, 4096, 64, 1024, equal=True,
                                               weighted=False)),
        ("indices outside [0, M), weighted", make(B, 3, 1024, 128, 256, lo=-64, hi=320)),
        ("indices outside [0, M), unweighted", make(B, 1, 2048, 64, 512, lo=-128, hi=640,
                                                    weighted=False)),
        ("B=1, weighted", make(1, 3, 4096, 128, 1024)),
        ("B=1, unweighted", make(1, 1, 8192, 64, 1024, weighted=False)),
    ]


def phase_segsum_shapes(dev, gen):
    """The segment sum against its plain version at the shapes of
    :func:`segsum_extra_args`, within ``SEGSUM_TOL`` of each call's largest
    |value|. Returns the largest abs error."""
    err = 0.0
    with torch.no_grad():
        for label, args in segsum_extra_args(dev, gen):
            log(f"[segsum shapes] {label}:")
            err = max(err, check_call("segsum shapes", "segment_matmul", args,
                                      segment_matmul_cuda(*args)))
    return err


def phase_train_times(state, batch, card_gen, seg_calls, smi):
    """The train step on the kernel path and on the plain path over several
    windows, a profiler trace of the kernel path, and the segment sum at
    each of its 7 shapes: wrapper, plain version, the sparse product
    (``library_ms``, held to the plain version first) and, at the
    unweighted shapes, ``index_add_`` by CUDA events; device time from the
    trace; bound."""
    dev = batch["points"].device
    step = loop.make_train_step()
    plain = loop.create_train_state("pointnet2_semseg", CLASSES, device=dev, seed=0,
                                    impl="torch")
    step_ms = report_windows("train step kernel path",
                             lambda: step(state, batch, card_gen), 5, 5, "step", smi)
    plain_ms = report_windows("train step plain path",
                              lambda: step(plain, batch, card_gen), 3, 2, "step", smi)
    del plain

    steps = 3
    device = profile_device("train profile", lambda: step(state, batch, card_gen),
                            steps, "step", smi)
    seg_device = None
    if device is not None:
        launches = launches_of(device, "segment_matmul")
        require(len(launches) == 7 * steps,
                f"[train profile] segment_matmul: {len(launches)} launches in the trace")
        # the trace's launches follow the recorded calls' order
        seg_device = [sum(float(e["dur"]) for e in launches[j::7]) / steps / 1e3
                      for j in range(7)]

    shapes = []
    for j, (args, _) in enumerate(seg_calls):
        idx, weights, values, m = args
        bound_ms, bound_by = bound(*segsum_work(args))
        b, _, r = idx.shape
        c = values.shape[2]
        s, dense = sparse_operands(*args)
        _, bad, report = segsum_error((s @ dense).reshape(b, m, c),
                                      segment_matmul_torch(*args))
        call = segsum_label(idx.shape[1], m)
        log(f"[train times] sparse product {call} vs plain: {report}")
        require(bad == 0, f"the sparse product disagrees at {call}")
        # the wrapper alone in device time: its zeroing (a memset) and its kernel
        wrapper_dev = call_device_ms(f"segment_matmul {call}",
                                     functools.partial(segment_matmul_cuda, *args), events=2)
        library_dev = call_device_ms(f"sparse product {call}", lambda: s @ dense)
        # the wrapper and the sparse product in turns: both are host-paced
        ms, library_ms = in_turns([lambda: segment_matmul_cuda(*args), lambda: s @ dense],
                                  iters=50)
        entry = {
            "call": call,
            "ms": ms,
            "plain_ms": time_ms(lambda: segment_matmul_torch(*args), iters=10),
            "device_ms": None if seg_device is None else seg_device[j],
            "wrapper_device_ms": None if wrapper_dev is None else wrapper_dev[0],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": None if library_dev is None else library_dev[0],
            "index_add_ms": None,
        }
        if weights is None:
            # index_add_ into zeros computes it too, the batch offsets folded
            # into the indices beforehand
            flat = (idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1)
            entry["index_add_ms"] = time_ms(
                lambda: torch.zeros((b * m, c), device=dev).index_add_(0, flat, dense),
                iters=50,
            )
        shapes.append(entry)
        def us(key):
            return "not measured" if entry[key] is None else f"{entry[key] * 1e3:.1f} us"

        index_add = ("" if entry["index_add_ms"] is None
                     else f", index_add_ {entry['index_add_ms'] * 1e3:.1f} us")
        log(f"[train times] segment_matmul {call} (J={idx.shape[1]} R={r} M={m} C={c}): "
            f"kernel in the step's trace {us('device_ms')}, wrapper alone on the device "
            f"{us('wrapper_device_ms')} (memset + kernel), by events {entry['ms'] * 1e3:.1f} "
            f"us, plain {entry['plain_ms'] * 1e3:.1f} us, sparse product "
            f"{entry['library_ms'] * 1e3:.1f} us (device {us('library_device_ms')})"
            f"{index_add}, bound {bound_ms * 1e3:.2f} us ({bound_by}) ({smi})")
    return step_ms, plain_ms, shapes


# ---------------------------------------------------------------- bf16 + SR, fused BN statistics


def fused_state(dev, **kw):
    """A pointnet2_semseg train state (seed 0) with the fused statistics:
    bf16 + SR (``--bf16 --bf16_sr``) unless told otherwise by ``kw``."""
    kw = {"fused_bn_stats": True,
          **model_precision_kwargs("pointnet2_semseg", bf16=True, bf16_sr=True), **kw}
    return loop.create_train_state("pointnet2_semseg", CLASSES, device=dev, seed=0, **kw)


def phase_fused_train(dev, batch):
    """The slice's main path: 10 Adam steps of bf16 + SR with the fused BN
    statistics on phase 7's batch, launch counts read just after them;
    then the bf16 eval step, and one request to a bf16 ``Predictor`` of
    the trained weights against its plain path on grid clouds."""
    state = fused_state(dev)
    card_gen = torch.Generator(device=dev).manual_seed(2)
    step = loop.make_train_step()
    zero_launches()
    losses = [float(step(state, batch, card_gen)["loss"]) for _ in range(TRAIN_STEPS)]
    launches = read_launches("fused train", TRAIN_STEPS, "fused_step",
                             "Adam steps of bf16+SR with the fused BN statistics")
    log("[fused train] losses " + ", ".join(f"{x:.5f}" for x in losses))
    require(all(math.isfinite(x) for x in losses), "a non-finite bf16 loss")
    require(losses[-1] < losses[0], f"the bf16 loss did not fall: {losses[0]} -> {losses[-1]}")

    zero_launches()
    metrics = loop.make_eval_step(CLASSES)(state, batch)
    eval_launches = read_launches("fused train", 1, "forward", "bf16 eval step")
    total = float(metrics["confusion"].sum())
    log(f"[fused train] bf16 eval step: loss {float(metrics['loss']):.5f}, accuracy "
        f"{float(metrics['accuracy']):.5f}, confusion sums to {total:.0f}")
    require(total == B * N, f"the bf16 eval confusion sums to {total}, want {B * N}")

    sd = {k: v.detach() for k, v in state.model.state_dict().items()}
    request = grid_clouds(B, torch.Generator().manual_seed(5))
    outs = {}
    for impl in ("auto", "torch"):
        pred = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev,
                                         impl=impl, dtype=torch.bfloat16)
        outs[impl] = pred(request)
    out = outs["auto"]
    check_log_probs("fused train", [out], [(B, N, CLASSES)])
    # grid clouds: both paths pick the same neighbours, so they differ only
    # where the 3-NN weights' last bits flip a bf16 rounding
    p99, med, agree = parity("fused train", "bf16 Predictor kernel vs plain path", out,
                             outs["torch"])
    require(p99 < 5e-2 and med < 5e-3 and agree >= 0.99,
            f"bf16 Predictor: p99 {p99}, median {med}, labels agree {agree}")
    return state, card_gen, launches, eval_launches


def phase_fused_calls(state, batch, card_gen):
    """Every kernel call of one more fused step against its plain version
    on the same inputs; returns the largest dense_bn_stats error."""
    calls = []
    with patched(recording_wrappers(calls)):
        loop.make_train_step()(state, batch, card_gen)
    torch.cuda.synchronize()
    counts = collections.Counter(name for name, _, _ in calls)
    log(f"[fused train] kernel calls of one step: {dict(counts)}")
    for name, k in KERNELS.items():
        require(counts[name] == k["fused_step"], f"{name}: {counts[name]} calls in a fused step")
    shapes = [(tuple(args[0].shape), args[1].shape[0]) for name, args, _ in calls
              if name == "dense_bn_stats"]
    require(shapes == [(shape, co) for _, shape, co in bn_calls()],
            f"the fused step's dense_bn_stats shapes {shapes}")
    err = 0.0
    with torch.no_grad():
        for name, args, out in calls:
            e = check_call("fused train", name, args, out)
            if name == "dense_bn_stats":
                err = max(err, e)
    return err


def grads_of(model, points, labels):
    loss = segmentation_loss(model(points), labels)
    loss.backward()
    return float(loss.detach()), {k: p.grad.float() for k, p in model.named_parameters()}


def global_gap(got, want):
    """Cosine and relative L2 error of two gradient dicts as one vector."""
    a = torch.cat([got[k].flatten() for k in sorted(want)]).double()
    b = torch.cat([want[k].flatten() for k in sorted(want)]).double()
    return float(a @ b / (a.norm() * b.norm())), float((a - b).norm() / b.norm())


def worst_ratio(got, want):
    """``(ratio, name)`` of the parameter whose largest error takes the
    largest share of its bar, GRAD_ATOL + GRAD_RTOL of its largest plain
    gradient (tests/test_train_parity.py:136-152)."""
    ratios = {name: float((got[name] - g).abs().max())
              / (GRAD_ATOL + GRAD_RTOL * float(g.abs().max())) for name, g in want.items()}
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst


def phase_fused_grads(dev, gen):
    """Gradients of the fused path, kernel path against plain path, same
    weights, 1/64-grid clouds, FPS from index 0, no dropout, no SR, in
    fp32 and in bf16. The kernel's product sums in another order than
    cuBLAS's, so its y may differ in the last bit, and where two
    neighbours' activations sit that close the K-max picks the other one:
    per element the gradient then moves as far as under a one-ulp nudge
    of the input (tests/test_torch_port_train.py and
    tests/test_torch_port_precision.py measure that spread on the CPU).
    So each dtype is held to global bars, with the plain path's own
    spread under a one-ulp nudge of the input features measured beside:
    - fp32: cosine above 0.999 and relative L2 error under 0.05, the
      global bars of tests/test_train_parity.py:155-169;
    - bf16: the relative L2 gap, and one minus the cosine, each within
      twice the nudge's plus 0.01.
    The worst per-parameter share of the per-element bars of phase 7 is
    logged for both pairs."""
    points = torch.as_tensor(grid_clouds(B, gen), device=dev)
    labels = labelled_clouds(points)
    nudged = points.clone()
    nudged[..., 3:] = torch.nextafter(nudged[..., 3:], torch.tensor(2.0, device=dev))
    kw = dict(dropout_rate=0.0, fused_bn_stats=True, sr=False, grouped_sr=False)
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        res = {}
        for run, impl, pts in (("kernel", "auto", points), ("plain", "torch", points),
                               ("nudged", "torch", nudged)):
            res[run] = grads_of(fused_state(dev, dtype=dtype, impl=impl, **kw).model, pts, labels)
        plain = res["plain"][1]
        cos, rel = global_gap(res["kernel"][1], plain)
        n_cos, n_rel = global_gap(res["nudged"][1], plain)
        ratio, worst = worst_ratio(res["kernel"][1], plain)
        n_ratio, n_worst = worst_ratio(res["nudged"][1], plain)
        log(f"[fused grads] {dname} fused, kernel vs plain: loss {res['kernel'][0]:.7f} vs "
            f"{res['plain'][0]:.7f}, cosine {cos:.6f}, relative L2 {rel:.4e}, worst "
            f"parameter {worst} at {ratio:.4f} of its per-element bar; the plain path "
            f"under a one-ulp nudge: loss {res['nudged'][0]:.7f}, cosine {n_cos:.6f}, "
            f"relative L2 {n_rel:.4e}, worst {n_worst} at {n_ratio:.4f}")
        if dtype == torch.float32:
            ok = cos > 0.999 and rel < 0.05
        else:
            ok = rel <= 2 * n_rel + 0.01 and 1 - cos <= 2 * (1 - n_cos) + 0.01
        require(ok, f"{dname} fused gradients: cosine {cos}, relative L2 {rel} (nudge: "
                    f"cosine {n_cos}, relative L2 {n_rel})")


def step_bn_device(label, fn, steps, smi, annotations=None):
    """The device ms of each of a fused train step's 17 dense_bn_stats
    calls, the kernel and its finalize pass, in a profiler trace of
    ``steps`` steps (:func:`profile_device`): the trace's events named
    ``dense_bn_stats``, two a call in launch order, of whatever kernel a
    tree's ``csrc/bn_stats.cu`` has. ``None`` when the trace holds no
    device events."""
    device = profile_device(label, fn, steps, "step", smi, annotations=annotations)
    if device is None:
        return None
    events = [e for e in device if "dense_bn_stats" in e.get("name", "")]
    require(len(events) == 2 * 17 * steps,
            f"[{label}] {len(events)} dense_bn_stats device events in {steps} steps")
    require(all("finalize" in e["name"] for e in events[1::2]),
            f"[{label}] dense_bn_stats: a kernel without its finalize pass")
    per_call = [sum(float(e["dur"]) for e in events[2 * j::34] + events[2 * j + 1::34])
                / steps / 1e3 for j in range(17)]
    return per_call


def log_bn_device(label, per_call, t, smi):
    """Each dense_bn_stats call's device µs in a step's trace beside its
    bound and ``F.linear``'s (phase 8's ``t`` of that dtype), then the sum."""
    lin = t["linear_device_ms"]
    for j, ((call, shape, co), ms) in enumerate(zip(bn_calls(), per_call)):
        log(f"[{label}] dense_bn_stats {call} x {shape} Co={co}: device "
            f"{ms * 1e3:.1f} us per launch (its two kernels), bound "
            f"{t['bound_ms'][j] * 1e3:.2f} us ({t['bound_by'][j]}), F.linear "
            + ("not measured" if lin[j] is None else f"{lin[j] * 1e3:.1f} us") + " on the "
            f"device, {t['linear_ms'][j] * 1e3:.1f} us by events ({smi})")
    simt = (f"; SIMT bound {sum(t['bound_simt_ms']) * 1e3:.1f} us, tensor cores "
            f"{sum(t['bound_tc_ms']) * 1e3:.1f} us" if "bound_simt_ms" in t else "")
    log(f"[{label}] dense_bn_stats: {sum(per_call) * 1e3:.1f} us per step on the device in "
        f"17 launches, bound {sum(t['bound_ms']) * 1e3:.1f} us{simt}, F.linear at the 17 "
        "shapes " + ("not measured" if None in lin else f"{sum(lin) * 1e3:.1f} us")
        + f" on the device, {sum(t['linear_ms']) * 1e3:.1f} us by events ({smi})")


def phase_fused_times(dev, state, batch, card_gen, bn_times, smi):
    """Train-step medians over windows (bf16+SR fused, bf16+SR unfused,
    fp32 fused) with a profiler trace of each: busy time, idle share, top
    ops; in the two fused steps' traces dense_bn_stats' device µs at each
    of its 17 shapes (its two kernels: :func:`step_bn_device`), and in the
    bf16+SR fused step's also the SR casts' device time (their kernels,
    found through a ``record_function`` range around each cast). Returns
    ``(medians, {dtype: per-call device ms}, SR casts)``."""
    step = loop.make_train_step()
    steps = 3
    medians = {"bf16+SR fused": report_windows(
        "train step bf16+SR fused", lambda: step(state, batch, card_gen), 5, 5, "step", smi)}
    bn_device = {}
    for label, kw in (("bf16+SR unfused", dict(fused_bn_stats=False)),
                      ("fp32 fused", dict(dtype=torch.float32, sr=False, grouped_sr=False))):
        other = fused_state(dev, **kw)
        medians[label] = report_windows(f"train step {label}",
                                        lambda: step(other, batch, card_gen), 5, 5, "step", smi)
        if label == "fp32 fused":
            bn_device["fp32"] = step_bn_device(f"{label} profile",
                                               lambda: step(other, batch, card_gen), steps, smi)
        else:
            profile_device(f"{label} profile", lambda: step(other, batch, card_gen), steps,
                           "step", smi)
        del other

    sr_cast = port_mlp.sr_to_bf16

    def annotated_sr(x, seed):
        with torch.profiler.record_function("pn12::sr_to_bf16"):
            return sr_cast(x, seed)

    spans = {"pn12::sr_to_bf16": None}
    with patched({(port_mlp, "sr_to_bf16"): annotated_sr}):
        bn_device["bf16"] = step_bn_device(
            "fused profile", lambda: step(state, batch, card_gen), steps, smi, annotations=spans)
    for dname, label in (("bf16", "fused profile"), ("fp32", "fp32 fused profile")):
        if bn_device[dname] is not None:
            log_bn_device(label, bn_device[dname], bn_times[dname], smi)
    return medians, bn_device, spans["pn12::sr_to_bf16"]


def fp32_bn_step_only():
    """``--fp32-bn-step``: dense_bn_stats' device µs in the fp32 fused train
    step alone (phase 9's trace and extraction, 3 steps), for comparing the
    ``csrc/bn_stats.cu`` of two trees in one call: run a copy of this file
    from the root of each checkout. It uses only the port's entry points
    (the train state and step, the build), so an older tree runs it too."""
    dev, smi = phase_device()
    build.build()
    build.library()
    gen = torch.Generator().manual_seed(0)
    points = torch.rand(B, N, C, generator=gen).to(dev)
    batch = {"points": points, "label": labelled_clouds(points)}
    state = fused_state(dev, dtype=torch.float32, sr=False, grouped_sr=False)
    step = loop.make_train_step()
    card_gen = torch.Generator(device=dev).manual_seed(2)
    per_call = step_bn_device("fp32 fused profile", lambda: step(state, batch, card_gen), 3,
                                 smi)
    require(per_call is not None, "the fp32 fused step's trace holds no device events")
    for (call, shape, co), ms in zip(bn_calls(), per_call):
        log(f"[fp32 bn step] dense_bn_stats {call} x {shape} Co={co}: device {ms * 1e3:.1f} us "
            f"per launch (its two kernels) ({smi})")
    log(f"[fp32 bn step] dense_bn_stats: {sum(per_call) * 1e3:.1f} us per fp32 fused step on "
        f"the device in 17 launches ({smi})")
    print(smi)
    print(json.dumps({"fp32_fused_step_dense_bn_stats_device_ms": per_call}))


# ---------------------------------------------------------------- Path F and Path G


def out_of_every_ball(centers):
    """``centers`` with the first three of each cloud moved far from every
    point: their ball query finds none, and the fused layers gather the
    clamped sentinel row w[N - 1]."""
    far = centers.clone()
    far[:, :3] = 10.0
    return far


def phase_fused_serve(dev, gen, sd, pred, err):
    """Path F: a fused Predictor of phase 4's weights serves 4 requests of
    grid clouds, launch counts read just after them, log-probs against
    the plain path; a continuous request against the unfused kernel
    Predictor with every kernel call held to its plain version; both fused
    kernels at every SA level's inputs, and with centers out of every
    ball. Returns the Predictor, the launches and the recorded calls."""
    fused = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev,
                                      impl="fused")
    plain = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev,
                                      impl="torch")
    requests = [grid_clouds(B, gen) for _ in range(4)]
    zero_launches()
    outs = [fused(r) for r in requests]
    launches = read_launches("fused serve", len(outs), "fused_forward")
    check_log_probs("fused serve", outs, [(B, N, CLASSES)] * len(outs))
    for i, req in enumerate(requests):
        check_parity("fused serve", f"request {i} fused path vs plain path on the card",
                     outs[i], plain(req))
    del plain

    continuous = torch.rand(B, N, C, generator=gen).numpy()
    got, calls = recorded_forward("fused serve", lambda: fused(continuous),
                                  "fused_forward", err)
    # the fused layers pick the neighbours of the unfused kernel path (the
    # same direct-form distances), so only the chain's sums differ
    check_parity("fused serve", "fused path vs unfused kernel path on continuous clouds",
                 got, pred(continuous))
    with torch.inference_mode():
        for _, args, _ in [c for c in calls if c[0] in FUSED]:
            radius, nsample, xyz, centers, w, t, layers = args
            for cs in (centers, out_of_every_ball(centers)):
                if cs is not centers:
                    log("[fused kernels] three centers a cloud out of every ball:")
                a = (radius, nsample, xyz, cs, w, t, layers)
                for name in FUSED:
                    got = KERNELS[name]["wrapper"](*a)
                    err[name] = max(err[name], check_call("fused kernels", name, a, got))
                    require(same_bits(got, KERNELS[name]["wrapper"](*a)),
                            f"[fused kernels] {name} {sa_level(a)}: the output differs "
                            "between two launches on the same inputs")
                log(f"[fused kernels] {sa_level(a)}: both kernels' outputs the same bits "
                    "over two launches")
    return fused, launches, calls


def clustered_clouds(dev, gen, n=N_GRID):
    """The clustered clouds of tests/test_kernels.py:80-129 scaled to
    ``n`` points: 300/512 of them on one spot at 0.5, or 500/640 at 0.31,
    the rest uniform."""
    out = []
    for spot, share in ((0.5, 300 / 512), (0.31, 500 / 640)):
        xyz = torch.rand(B, n, 3, generator=gen)
        xyz[:, : round(share * n)] = spot
        out.append((f"{round(share * n)} of {n} points at {spot}", xyz.to(dev)))
    return out


def phase_grid_serve(dev, gen, sd, err):
    """Path G: an impl="auto" Predictor of phase 4's weights serves one
    request of (16, 8192, 9) grid clouds, launch counts read just after
    it, log-probs against the plain path; every kernel call of a
    continuous-cloud forward held to its plain version; the grid ball
    query on the clustered clouds and with centers out of every ball.
    Returns the Predictor, the launches and the recorded calls."""
    pred = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev)
    plain = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev,
                                      impl="torch")
    request = grid_clouds(B, gen, N_GRID)
    zero_launches()
    out = pred(request)
    launches = read_launches("grid serve", 1, "grid_forward")
    check_log_probs("grid serve", [out], [(B, N_GRID, CLASSES)])
    check_parity("grid serve", "N=8192 kernel path vs plain path on the card", out,
                 plain(request))
    del plain

    continuous = torch.rand(B, N_GRID, C, generator=gen).numpy()
    _, calls = recorded_forward("grid serve", lambda: pred(continuous), "grid_forward", err)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        radius, nsample, xyz, centers = next(a for n, a, _ in calls if n == "ballquery_grid")
        # K=1 with a capacity of 4: a center of more hits cuts its list
        forced = grid_module.grid_plan(B, N_GRID, centers.shape[1], 1, capacity=4, tile=256)
        cases = [("continuous, 3 centers a cloud out of every ball", xyz,
                  out_of_every_ball(centers), nsample, None),
                 (f"continuous, K=1, lists over capacity {forced.capacity} and the union over "
                  f"a tile of {forced.tile} points", xyz, centers, 1, forced)]
        cases += [(f"continuous, K={k}", xyz, centers, k, None) for k in (1, 128)]
        # the spot's cell holds thousands of points: its centers pass the threshold
        for label, cloud in clustered_clouds(dev, gen):
            fps_idx = fps_cuda(cloud, SA[0][0], start)
            cases.append((label, cloud, index_points(cloud, fps_idx).contiguous(), nsample,
                          None))
        cloud = torch.rand(1, 4 * N_GRID, 3, generator=gen).to(dev)
        cases.append((f"B=1 N={4 * N_GRID}", cloud, random_centers(cloud, N_GRID, gen),
                      nsample, None))
        for label, cloud, cs, k, plan in cases:
            a = (radius, k, cloud, cs)
            log(f"[grid kernels] {label}: {grid_paths(a, plan)}")
            err["ballquery_grid"] = max(err["ballquery_grid"], check_call(
                "grid kernels", "ballquery_grid", a, ballquery_grid_cuda(*a, plan=plan)))
    return pred, launches, calls


def grid_paths(args, plan=None):
    """The grid kernel's plan for ``args`` and how many centers take each of
    its paths there (``grid_cuda.center_paths``: the list, the scan over the
    threshold, the list compacted over the capacity), from the plain grid
    prep."""
    radius, k, xyz, centers = args
    plan = plan or grid_module.grid_plan(xyz.shape[0], xyz.shape[1], centers.shape[1], k)
    step = max(1, 2**25 // (xyz.shape[0] * xyz.shape[1]))  # centers a chunk
    hits = torch.cat([(square_distance(centers[:, i:i + step], xyz) <= r2_of(radius)).sum(-1)
                      for i in range(0, centers.shape[1], step)], dim=1)
    paths = grid_module.center_paths(grid_prep_torch(radius, xyz, centers), hits, plan)
    counts = torch.bincount(paths.flatten().long(), minlength=3).tolist()
    return (f"run={plan.run} capacity={plan.capacity} threshold={plan.threshold} "
            f"tile={plan.tile}; centers by path: list {counts[0]}, scan over the threshold "
            f"{counts[1]}, list compacted over the capacity {counts[2]}")


def prep_clouds(n, gen):
    """``[(label, xyz (B, n, 3) on the CPU)]`` that the grid prep kernel is
    held on: uniform clouds; the clustered clouds of phase 11; clouds on
    the 1/64 grid with both corners of the unit cube, so the cells are
    exactly 1/8 wide and every point whose coordinate is a multiple of 1/8
    sits on a cell face; every point of a cloud equal (extent 0, so the cell
    size is the radius); a cloud inside a box narrower than the radius (all
    its points in one cell)."""
    lattice = torch.randint(0, 65, (B, n, 3), generator=gen) / 64.0
    lattice[:, 0], lattice[:, 1] = 0.0, 1.0
    one_cell = 0.2 + 0.05 * torch.rand(B, n, 3, generator=gen)
    return [
        ("uniform", torch.rand(B, n, 3, generator=gen)),
        *[(f"clustered, {label}", c) for label, c in clustered_clouds("cpu", gen, n)],
        ("1/64 grid, points on cell faces", lattice),
        ("degenerate, every point equal", torch.full((B, n, 3), 0.3)),
        ("one cell", one_cell),
    ]


def phase_prep_clouds(dev, gen, err, radius=0.1, s=1024):
    """The grid prep kernel against its plain version, all five tensors bit
    for bit, at N=4096 and N=8192 (S=1024, B=16, r=0.1) on the clouds of
    :func:`prep_clouds`, and on uniform clouds with three centers a cloud
    out of every ball (outside the bounding box); and at N=32768, a list
    too long to stage in shared memory, where the kernel takes its other
    form (keys recomputed, scattered to device memory). The grid ball query
    (K=32) on each: held to its plain version and to the contract."""
    for n in (4096, 8192, 32768):
        clouds = prep_clouds(n, gen)
        xyz = clouds[0][1].to(dev)
        clouds.append(("uniform, 3 centers a cloud out of every ball", xyz,
                       out_of_every_ball(random_centers(xyz, s, gen))))
        for label, cloud, *given in clouds:
            xyz = cloud.to(dev)
            centers = given[0] if given else random_centers(xyz, s, gen)
            log(f"[grid prep] N={n} S={s} {label}:")
            args = (radius, xyz, centers)
            err["grid_prep"] = max(err["grid_prep"], check_call(
                "grid prep", "grid_prep", args, grid_prep_cuda(*args)))
            args = (radius, K, xyz, centers)
            log(f"[grid prep] the grid ball query: {grid_paths(args)}")
            err["ballquery_grid"] = max(err["ballquery_grid"], check_call(
                "grid prep", "ballquery_grid", args, ballquery_grid_cuda(*args)))


def fused_work(args, search):
    """``(bytes, product ops, other ops)`` of one fused layer call: its
    inputs and output once; 2 ops a multiply-add of the chain's products;
    2 an output of a layer (bias, ReLU), 2 an element of the gather
    (subtract, ReLU) and 1 of the K-max, and 9 a point the neighbour search
    reads (``search``, counted on these inputs)."""
    _, k, xyz, centers, w, t, layers = args
    b, s, c1 = centers.shape[0], centers.shape[1], w.shape[2]
    rows, co = b * s * k, layers[-1][0].shape[1]
    nbytes = 4 * (xyz.numel() + centers.numel() + w.numel() + t.numel() + b * s * co
                  + sum(kern.numel() + bias.numel() for kern, bias in layers))
    products = sum(2 * rows * kern.numel() for kern, _ in layers)
    other = 2 * rows * c1 + rows * co + 9 * search + sum(2 * rows * kern.shape[1]
                                                         for kern, _ in layers)
    return nbytes, products, other


def fused_bounds(nbytes, products, other):
    """The two least times of a fused layer, each ``(ms, "bytes" or
    "operations")``: on the SIMT units, every op at 67 TFLOP/s of fp32
    (the larger of that and the bytes time); on the tensor cores, the
    chain's products as three TF32 products each at 495 TFLOP/s beside the
    other ops on the SIMT units, the two kinds of unit working at once (the
    larger of the two op times and the bytes time)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    simt = (products + other) / FP32_OPS_PER_S * 1e3
    tc = max(3 * products / TF32_OPS_PER_S, other / FP32_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= simt else (simt, "operations"),
            (t_bytes, "bytes") if t_bytes >= tc else (tc, "operations"))


def unfused_layer(radius, nsample, xyz, centers, w, t, layers):
    """One SA layer as the port's unfused eval forward runs it, the fused
    kernels' yardstick: ``ballquery.cu``, the gather of w[idx] - t and
    its ReLU, each Dense on cuBLAS (``F.linear``), the K-max, the ReLU."""
    acts = torch.relu(index_points(w, ballquery_cuda(radius, nsample, xyz, centers))
                      - t[:, :, None, :])
    for i, (kern, bias) in enumerate(layers):
        acts = F.linear(acts, kern.T, bias)
        if i < len(layers) - 1:
            acts = torch.relu(acts)
    return torch.relu(acts.amax(dim=2))


def device_ms_per_call(device, name, per_forward, forwards):
    """Device ms of each of a forward's ``per_forward`` launches of
    ``name`` in a trace of ``forwards`` forwards, in launch order."""
    launches = launches_of(device, name)
    require(len(launches) == per_forward * forwards,
            f"[profile] {name}: {len(launches)} launches in the trace")
    return [sum(float(e["dur"]) for e in launches[j::per_forward]) / forwards / 1e3
            for j in range(per_forward)]


def sa_level(args):
    """``"SA<level> N=<points>"`` of a fused layer's call."""
    xyz, centers = args[2], args[3]
    return f"SA{1 + [n for n, _ in SA].index(centers.shape[1])} N={xyz.shape[1]}"


def call_device_ms(label, fn, reps=5, pad=3, events=None):
    """``(ms, events)`` per call of ``fn``: the summed durations of the
    device events of ``reps`` calls, in a profiler trace that also holds
    ``pad`` calls before and after them, set apart by 10 ms of idle card
    (:func:`traced_window`); and the number of those events a call holds,
    which must equal ``events`` where it is given. ``None`` when the trace
    holds no device events."""
    window = traced_window(label, fn, reps, pad, idle_s=0.01, per_call=events)
    if window is None:
        return None
    inside = window[0]
    return sum(float(e["dur"]) for e in inside) / reps / 1e3, len(inside) // reps


def offsets_library(skey, cells):
    """The one PyTorch call for the cell offsets of the sorted keys
    ``skey``: the leftmost insertion point of each id counts the keys below
    it."""
    ids = torch.arange(cells + 1, dtype=torch.int32,
                       device=skey.device).expand(skey.shape[0], -1).contiguous()
    return functools.partial(torch.searchsorted, skey, ids, out_int32=True)


def prep_args(calls):
    """``(radius, xyz, centers)`` of the recorded grid_prep call in ``calls``."""
    return next(a for n, a, _ in calls if n == "grid_prep")[:3]


def prep_work(xyz, centers):
    """``(bytes, ops)`` of one grid prep: the points and centers read once,
    perm, skey, qperm, sqkey and the offsets written once; 6 ops a point for
    the bounds (a min and a max an axis) and 20 a key (3 subtracts, 3
    divides, 3 floors, 6 clamps, 3 integer multiply-adds, 2 for its count
    and its place in the sort)."""
    b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
    nbytes = 4 * (xyz.numel() + centers.numel() + 2 * b * n + b * (GRID_RES**3 + 1)
                  + 2 * b * s)
    return nbytes, 6 * b * n + 20 * b * (n + s)


def layer_device_ms(fused_calls, grid_calls):
    """``{label: (ms, events)}`` per call (:func:`call_device_ms`) of each
    fused layer's wrapper (SA1's with its grid prep) beside the unfused
    kernel path of the same layer; at the SA1 of Paths F and G of the grid
    prep (one launch), the plain prep (the PyTorch ops it replaces) and
    ``torch.searchsorted`` (the offsets alone); at Path G's SA1 of the grid
    ball query's wrapper and ``ballquery.cu``. ``None`` when the traces
    hold no device events."""
    calls = {}
    for name, args, _ in [c for c in fused_calls if c[0] in FUSED]:
        calls[f"{sa_level(args)} {name}"] = (
            functools.partial(KERNELS[name]["wrapper"], *args),
            2 if name == "fused_sa_grid" else 1)
        calls[f"{sa_level(args)} unfused"] = (functools.partial(unfused_layer, *args), None)
    for path, recorded in (("Path F SA1", fused_calls), ("Path G SA1", grid_calls)):
        radius, xyz, centers = prep_args(recorded)
        calls[f"{path} grid_prep"] = (
            functools.partial(grid_prep, radius, xyz, centers, impl="cuda"), 1)
        calls[f"{path} grid_prep plain"] = (
            functools.partial(grid_prep_torch, radius, xyz, centers), None)
        skey = grid_prep_torch(radius, xyz, centers)["skey"]
        calls[f"{path} searchsorted"] = (offsets_library(skey, GRID_RES**3), None)
    args = next(a for n, a, _ in grid_calls if n == "ballquery_grid")
    calls["Path G SA1 ballquery_grid"] = (functools.partial(ballquery_grid_cuda, *args), 2)
    calls["Path G SA1 ballquery.cu"] = (functools.partial(ballquery_cuda, *args), 1)
    out = {}
    with torch.inference_mode():
        for label, (fn, events) in calls.items():
            out[label] = call_device_ms(label, fn, events=events)
            if out[label] is None:
                log("[layer times] the trace holds no device events: device time not measured")
                return None
    return out


def random_centers(xyz, s, gen):
    """``s`` distinct points of each cloud, drawn at random."""
    pick = torch.argsort(torch.rand(xyz.shape[:2], generator=gen), dim=1)[:, :s]
    return index_points(xyz, pick.to(xyz.device)).contiguous()


def crossover_curve(dev, smi):
    """The card's ball-query crossover: the grid route (``ballquery_grid_cuda``,
    its prep included) and the scan (``ballquery.cu``) at B=16, S=N/4, K=32,
    r=0.1, N = 4096, 8192, 16384, on uniform clouds and on the first
    clustered cloud of :func:`clustered_clouds` (300/512 of the points on
    one spot at 0.5), by CUDA events and in device time. The two use the
    same direct-form distance, so their indices must be equal. ``_route``
    is not changed by it."""
    gen = torch.Generator().manual_seed(7)
    radius, rows = 0.1, []
    for n in CROSSOVER_N:
        for kind, cloud in prep_clouds(n, gen)[:2]:
            xyz = cloud.to(dev)
            centers = random_centers(xyz, n // 4, gen)
            args = (radius, K, xyz, centers)
            with torch.inference_mode():
                got = ballquery_grid_cuda(*args)
                log(f"[crossover] N={n} {kind}: {grid_paths(args)}")
                check_order_model("crossover", "ballquery_grid", args, got)
                require(torch.equal(got, ballquery_cuda(*args)),
                        f"[crossover] N={n} {kind}: the grid and scan routes differ")
                grid_dev = call_device_ms(f"crossover grid N={n} {kind}",
                                          functools.partial(ballquery_grid_cuda, *args),
                                          events=2)
                scan_dev = call_device_ms(f"crossover scan N={n} {kind}",
                                          functools.partial(ballquery_cuda, *args), events=1)
            row = {"n": n, "s": n // 4, "cloud": kind,
                   "grid_ms": time_ms(lambda: ballquery_grid_cuda(*args), iters=30),
                   "scan_ms": time_ms(lambda: ballquery_cuda(*args), iters=30),
                   "grid_device_ms": None if grid_dev is None else grid_dev[0],
                   "scan_device_ms": None if scan_dev is None else scan_dev[0]}
            rows.append(row)
            dev_txt = ("device not measured" if grid_dev is None else
                       f"device grid {row['grid_device_ms'] * 1e3:.1f} us, scan "
                       f"{row['scan_device_ms'] * 1e3:.1f} us")
            log(f"[crossover] N={n} S={n // 4} {kind}: by events grid "
                f"{row['grid_ms'] * 1e3:.1f} us, scan {row['scan_ms'] * 1e3:.1f} us; "
                f"{dev_txt} ({smi})")
            del xyz, centers, args
    return rows


def grid_kernel_device_ms(label, fn):
    """Device ms of the grid ball query's kernel alone (not its prep) per
    call of ``fn``, a ``ballquery_grid_cuda`` call of two device events, in
    a padded trace (:func:`traced_window`); ``None`` without device
    events."""
    window = traced_window(label, fn, reps=5, pad=3, idle_s=0.01, per_call=2)
    if window is None:
        return None
    return sum(float(e["dur"]) for e in window[0]
               if "ballquery_grid_kernel" in e.get("name", "")) / 5 / 1e3


def grid_sweep(label, args, smi):
    """The grid plan sweep at ``args``: around the default plan, one knob at
    a time, every run (8-128 centers a block), list capacity (32-256),
    threshold (2-16 times a uniform cloud's points in a cell, or none) and
    tile (512-8192 points), each instance held bit for bit to the contract
    and its kernel timed on the device. Returns ``[{plan, device_ms,
    default}]``."""
    radius, k, xyz, centers = args
    b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
    default = grid_module.grid_plan(b, n, s, k)
    uniform = -(-n // GRID_RES**3)
    knobs = {"run": (8, 16, 32, 64, 128), "capacity": (32, 64, 96, 128, 256),
             "threshold": (2 * uniform, 4 * uniform, 8 * uniform, 16 * uniform,
                           grid_module.NO_THRESHOLD),
             "tile": (512, 1024, 2048, 4096, 8192)}
    plans = [default] + [grid_module.grid_plan(b, n, s, k, **{knob: v})
                         for knob, values in knobs.items() for v in values]
    rows = []
    with torch.inference_mode():
        for plan in dict.fromkeys(plans):  # in order, once each
            fn = functools.partial(ballquery_grid_cuda, *args, plan=plan)
            check_order_model("sweep", "ballquery_grid", args, fn())
            ms = grid_kernel_device_ms(f"grid sweep {label} {plan}", fn)
            rows.append({"plan": plan._asdict(), "default": plan == default, "device_ms": ms})
            log(f"[sweep] ballquery_grid {label} B={b} N={n} S={s} run={plan.run} "
                f"capacity={plan.capacity} threshold={plan.threshold} tile={plan.tile}"
                f"{' (default)' if plan == default else ''}: "
                + ("device not measured" if ms is None else f"kernel {ms * 1e3:.1f} us on the "
                   "device") + f" ({smi})")
    timed = [r for r in rows if r["device_ms"] is not None]
    if timed:
        best = min(timed, key=lambda r: r["device_ms"])
        log(f"[sweep] ballquery_grid {label}: fastest {best['plan']}, "
            f"{best['device_ms'] * 1e3:.1f} us; the default "
            f"{next(r['device_ms'] for r in timed if r['default']) * 1e3:.1f} us ({smi})")
    return rows


def phase_new_times(fused_calls, grid_calls, pred, fused, grid_pred, request, smi):
    """Times of the new kernels at each shape of Paths F and G (CUDA
    events): wrapper, plain version, bound, the one PyTorch call for the
    cell offsets (``torch.searchsorted``, held equal to the plain offsets
    first) and yardstick (the unfused kernel path of each fused layer,
    ``ballquery.cu`` beside the grid ball query); the same wrappers,
    yardsticks, the plain prep and ``torch.searchsorted`` in device time
    (:func:`layer_device_ms`); the ball-query crossover curve; the
    Predictors over windows; profiler traces of a Path F and a Path G
    forward. Returns ``(times, medians)``."""
    times = {name: {key: [] for key in ("call", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "yardstick_ms", "device_ms",
                                        "wrapper_device_ms", "yardstick_device_ms",
                                        "plain_device_ms", "plain_device_events",
                                        "library_device_ms")
                    + (("bound_simt_ms", "bound_tc_ms") if name in FUSED else ())}
             for name in NEW}

    def add(name, call, ms, plain_ms, work, yardstick_ms, library_ms=None, extra=""):
        both = ""
        if name in FUSED:
            # the table's bound is the lower of the SIMT and tensor-core ones:
            # the least the card could take for the same work
            simt, tc = fused_bounds(*work)
            bound_ms, bound_by = min(simt, tc)
            times[name]["bound_simt_ms"].append(simt[0])
            times[name]["bound_tc_ms"].append(tc[0])
            both = (f"; SIMT {simt[0] * 1e3:.2f} us ({simt[1]}), tensor cores "
                    f"{tc[0] * 1e3:.2f} us ({tc[1]})")
        else:
            bound_ms, bound_by = bound(*work)
        for key, value in (("call", call), ("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound_ms), ("bound_by", bound_by),
                           ("library_ms", library_ms), ("yardstick_ms", yardstick_ms)):
            times[name][key].append(value)
        log(f"[new times] {name} {call}: wrapper {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}{both})"
            + ("" if library_ms is None else f", library {library_ms * 1e3:.1f} us")
            + ("" if yardstick_ms is None else f", yardstick {yardstick_ms * 1e3:.1f} us")
            + f"{extra} ({smi})")

    for name, args, _ in [c for c in fused_calls if c[0] in FUSED]:
        radius, _, xyz, centers = args[:4]
        level = sa_level(args)
        search = (grid_candidates(radius, xyz, centers) if name == "fused_sa_grid"
                  else scanned_pairs(radius, xyz, centers))
        other = "fused_sa_dense" if name == "fused_sa_grid" else "fused_sa_grid"
        other_ms = time_ms(lambda: KERNELS[other]["wrapper"](*args), iters=20)
        add(name, level, time_ms(lambda: KERNELS[name]["wrapper"](*args), iters=20),
            time_ms(lambda: fused_sa_eval_torch(*args), iters=5),
            fused_work(args, search), time_ms(lambda: unfused_layer(*args), iters=20),
            extra=f"; the {other} kernel at this shape {other_ms * 1e3:.1f} us")
    for path, calls in (("Path F SA1", fused_calls), ("Path G SA1", grid_calls)):
        radius, xyz, centers = prep_args(calls)
        b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
        skey = grid_prep_torch(radius, xyz, centers)["skey"]
        library = offsets_library(skey, GRID_RES**3)
        require(torch.equal(library(), cell_offsets_torch(skey, GRID_RES**3)),
                f"[new times] torch.searchsorted disagrees with the plain cell offsets ({path})")
        # the wrapper and torch.searchsorted in turns: both are host-paced
        ms, library_ms = in_turns([lambda: grid_prep_cuda(radius, xyz, centers), library],
                                  iters=50)
        add("grid_prep", f"{path} B={b} N={n} S={s}", ms,
            time_ms(lambda: grid_prep_torch(radius, xyz, centers), iters=20),
            prep_work(xyz, centers), None, library_ms=library_ms,
            extra=" (library: torch.searchsorted, the offsets alone; both in turns)")
    args = next(a for n, a, _ in grid_calls if n == "ballquery_grid")
    radius, _, xyz, centers = args
    work = (4 * (xyz.numel() + centers.numel() + B * centers.shape[1] * K),
            9 * grid_candidates(radius, xyz, centers))
    add("ballquery_grid", f"Path G SA1 N={xyz.shape[1]} S={centers.shape[1]}",
        time_ms(lambda: ballquery_grid_cuda(*args), iters=50),
        time_ms(lambda: ballquery_torch(*args), iters=5), work,
        time_ms(lambda: ballquery_cuda(*args), iters=50))

    # the Predictors, fused and unfused in turn, over windows
    x = torch.as_tensor(request, device=fused.device)
    xg = torch.as_tensor(grid_clouds(B, torch.Generator().manual_seed(6), N_GRID),
                         device=fused.device)
    medians = {}
    for label, p in (("unfused kernel path", pred), ("fused path", fused),
                     ("fused path, again", fused), ("unfused kernel path, again", pred)):
        medians[label] = report_windows(f"Predictor {label}", lambda: p(x), 5, 20, "batch", smi)
    medians["N=8192"] = report_windows("Predictor N=8192 impl=auto", lambda: grid_pred(xg),
                                       5, 10, "batch", smi, n=N_GRID)

    layer_ms = layer_device_ms(fused_calls, grid_calls)
    if layer_ms is not None:
        for name, level in [(n, sa_level(a)) for n, a, _ in fused_calls if n in FUSED]:
            times[name]["wrapper_device_ms"].append(layer_ms[f"{level} {name}"][0])
            times[name]["yardstick_device_ms"].append(layer_ms[f"{level} unfused"][0])
            log(f"[layer times] {level}: {name} wrapper "
                f"{layer_ms[f'{level} {name}'][0] * 1e3:.1f} us on the device, the unfused "
                f"kernel path of the layer {layer_ms[f'{level} unfused'][0] * 1e3:.1f} us "
                f"({smi})")
        for path in ("Path F SA1", "Path G SA1"):
            (prep_ms, _), (plain_ms, plain_events), (lib_ms, lib_events) = (
                layer_ms[f"{path} {what}"] for what in ("grid_prep", "grid_prep plain",
                                                        "searchsorted"))
            t = times["grid_prep"]
            t["wrapper_device_ms"].append(prep_ms)
            t["plain_device_ms"].append(plain_ms)
            t["plain_device_events"].append(plain_events)
            t["library_device_ms"].append(lib_ms)
            log(f"[layer times] {path}: grid_prep {prep_ms * 1e3:.1f} us on the device in 1 "
                f"launch; the plain prep {plain_ms * 1e3:.1f} us in {plain_events} device "
                f"events; torch.searchsorted {lib_ms * 1e3:.1f} us in {lib_events} ({smi})")
        times["ballquery_grid"]["wrapper_device_ms"].append(
            layer_ms["Path G SA1 ballquery_grid"][0])
        times["ballquery_grid"]["yardstick_device_ms"].append(
            layer_ms["Path G SA1 ballquery.cu"][0])
        log("[layer times] Path G SA1: ballquery_grid wrapper "
            f"{layer_ms['Path G SA1 ballquery_grid'][0] * 1e3:.1f} us on the device, its "
            f"grid_prep {layer_ms['Path G SA1 grid_prep'][0] * 1e3:.1f} us, ballquery.cu "
            f"{layer_ms['Path G SA1 ballquery.cu'][0] * 1e3:.1f} us ({smi})")
    times["ballquery_grid"]["crossover"] = crossover_curve(xg.device, smi)
    # the plan sweep at Path G's SA1 and at the crossover's clustered cloud
    # (N=8192, S=2048: 300/512 of the points on one spot)
    cloud = prep_clouds(N_GRID, torch.Generator().manual_seed(8))[1][1].to(xg.device)
    clustered = (0.1, K, cloud, random_centers(cloud, N_GRID // 4, torch.Generator()
                                               .manual_seed(9)))
    times["ballquery_grid"]["plans"] = {
        "Path G SA1": grid_sweep("Path G SA1", args, smi),
        "clustered N=8192": grid_sweep("clustered N=8192", clustered, smi)}

    forwards = 3
    device = profile_device("fused profile", lambda: fused(x), forwards, "forward", smi)
    if device is not None:
        times["fused_sa_grid"]["device_ms"] = device_ms_per_call(device, "fused_sa_grid", 1,
                                                                 forwards)
        times["fused_sa_dense"]["device_ms"] = device_ms_per_call(device, "fused_sa_dense", 3,
                                                                  forwards)
        times["grid_prep"]["device_ms"] = device_ms_per_call(device, "grid_prep", 1, forwards)
    device = profile_device("grid profile", lambda: grid_pred(xg), forwards, "forward", smi)
    if device is not None:
        times["ballquery_grid"]["device_ms"] = device_ms_per_call(device, "ballquery_grid", 1,
                                                                  forwards)
        if times["grid_prep"]["device_ms"]:
            times["grid_prep"]["device_ms"] += device_ms_per_call(device, "grid_prep", 1,
                                                                  forwards)
        log("[grid profile] per launch at N=8192: ballquery.cu SA2-SA4 "
            + ", ".join(f"{ms * 1e3:.1f}" for ms in device_ms_per_call(
                device, "ballquery", 3, forwards))
            + " us; FPS SA1-SA4 " + ", ".join(f"{ms * 1e3:.1f}" for ms in device_ms_per_call(
                device, "fps", 4, forwards)) + f" us ({smi})")
    for name in NEW:
        dev_ms = times[name]["device_ms"]
        log(f"[new times] {name} device per launch: "
            + (", ".join(f"{c} {ms * 1e3:.1f} us" for c, ms in zip(times[name]["call"], dev_ms))
               if dev_ms else "not measured") + f" ({smi})")
    for name in FUSED:
        # rows 8-9 a layer: the kernel in the Path F trace beside both
        # bounds, its wrapper and the unfused kernel path traced alone
        t = times[name]
        for i, call in enumerate(t["call"]):
            def us(key):
                v = t[key][i] if i < len(t[key]) else None
                return "not measured" if v is None else f"{v * 1e3:.1f} us"
            log(f"[layer table] {name} {call}: kernel {us('device_ms')} on the device, bound "
                f"{t['bound_ms'][i] * 1e3:.2f} us ({t['bound_by'][i]}; SIMT "
                f"{t['bound_simt_ms'][i] * 1e3:.2f}, tensor cores {t['bound_tc_ms'][i] * 1e3:.2f}),"
                f" wrapper {us('wrapper_device_ms')} device / {us('ms')} events, unfused "
                f"kernel path {us('yardstick_device_ms')} device / {us('yardstick_ms')} events, "
                f"plain {us('plain_ms')} ({smi})")
    return times, medians


# ---------------------------------------------------------------- FPS at any N


FPS_LARGE_N = ((12289, 3072), (16384, 4096), (32768, 8192))  # (N, npoint), past 8192
FPS_PREDICTOR_N = 16384  # the Predictor forward of phase 14, B=2


def fps_work(b, n, npoint):
    """``(bytes, ops)`` of one FPS call: the cloud and the starts read once,
    the indices written once; ~10 ops a point an iteration (3 sub, 3 mul, 2
    add, the running min, the argmax compare)."""
    return b * n * 12 + b * 4 + b * npoint * 4, 10 * b * npoint * n


def fps_clouds(dev, gen, n=N):
    """``[(label, xyz (B, n, 3) on the card)]`` of the FPS checks' hard
    cases: every point equal (every argmax after the first a tie, won by
    index 0), a 1/64 grid (many exact ties) and the two clustered clouds of
    :func:`clustered_clouds`."""
    lattice = torch.randint(0, 64, (B, n, 3), generator=gen) / 64.0
    return [("degenerate, every point equal", torch.full((B, n, 3), 0.3, device=dev)),
            ("1/64 grid", lattice.to(dev)),
            *[(f"clustered, {label}", c) for label, c in clustered_clouds(dev, gen, n)]]


def timed_plain_fps(xyz, npoint, start):
    """``(indices, ms)`` of one call of the plain FPS (CUDA events): its
    Python loop of ``npoint`` iterations takes up to a second at N=32768,
    so it runs once, for its check and its time alike."""
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    begin.record()
    want = fps_torch(xyz, npoint, start)
    end.record()
    torch.cuda.synchronize()
    return want, begin.elapsed_time(end)


def fps_shape_times(label, xyz, npoint, start, want, smi, plain_ms=None):
    """The FPS kernel at one shape: each thread count with an instance
    (:func:`fps_plan`) held to the plain indices ``want`` and timed by CUDA
    events (the sweep), then the default plan's wrapper time, its device
    time (one device event a call, :func:`call_device_ms`), ns an iteration
    (device µs / npoint) and bound. Returns the shape's entry."""
    b, n = xyz.shape[0], xyz.shape[1]
    iters = 20 if n <= 8192 else 2
    sweep = {}
    for threads in THREADS:
        try:
            fps_plan(n, threads)
        except ValueError:
            continue
        got = fps_cuda(xyz, npoint, start, threads)
        require(torch.equal(got, want),
                f"[fps] {label} at {threads} threads: {int((got != want).sum())} mismatched")
        # by events, and at N <= 8192 (host-paced below ~1024 points by
        # events) in device time too
        fn = functools.partial(fps_cuda, xyz, npoint, start, threads)
        traced = (call_device_ms(f"fps {label} at {threads} threads", fn, reps=3, pad=2,
                                 events=1) if n <= 8192 else None)
        sweep[threads] = {"ms": time_ms(fn, iters=iters, warmup=1),
                          "device_ms": None if traced is None else traced[0]}
    plan = fps_plan(n)
    ms = time_ms(lambda: fps_cuda(xyz, npoint, start), iters=iters, warmup=1)
    reps, pad = (5, 3) if n <= 8192 else (2, 2)
    with torch.inference_mode():
        dev_ms = call_device_ms(f"fps {label}", functools.partial(fps_cuda, xyz, npoint, start),
                                reps=reps, pad=pad, events=1)
    bound_ms, bound_by = bound(*fps_work(b, n, npoint))
    entry = {"call": label, "b": b, "n": n, "npoint": npoint, "threads": plan.threads,
             "form": ("shared, streamed" if plan.streamed else "shared") if plan.shared
             else "registers",
             "ms": ms, "device_ms": None if dev_ms is None else dev_ms[0],
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "sweep": sweep}
    entry["ns_per_iteration"] = (None if dev_ms is None else dev_ms[0] * 1e6 / npoint)
    device = ("not measured" if dev_ms is None
              else f"{dev_ms[0] * 1e3:.1f} us, {entry['ns_per_iteration']:.0f} ns an iteration")
    plain = "" if plain_ms is None else f", plain {plain_ms * 1e3:.1f} us"
    log(f"[fps] {label}, S={npoint}: {plan.threads} threads ({entry['form']}"
        f"{f', {plan.streamed} streamed slots' if plan.streamed else ''}), wrapper "
        f"{ms * 1e3:.1f} us, device {device}{plain}, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}); sweep by events (device): "
        + ", ".join(f"{t} threads {v['ms'] * 1e3:.1f} us"
                    + ("" if v["device_ms"] is None else f" (device {v['device_ms'] * 1e3:.1f})")
                    for t, v in sweep.items()) + f" ({smi})")
    return entry


def phase_fps(dev, gen, levels, grid_calls, sd, err, smi):
    """FPS at any N: the kernel held exactly to its plain version at
    N = 12289, 16384 and 32768 (B=16 from random starts drawn from a card
    generator, B=1 from index 0), and at N=4096 on degenerate, 1/64-grid
    and clustered clouds from random starts; the thread-count sweep, the
    wrapper and device times and ns an iteration at the four slice shapes,
    at Path G's SA1 and at each new N; one Predictor forward of B=2 clouds
    of N=16384, its kernel calls held to their plain versions and its
    log-probs finite and normalised. Returns the shapes' entries."""
    card_gen = torch.Generator(device=dev).manual_seed(4)

    def random_start(b, n):
        return torch.randint(0, n, (b,), generator=card_gen, device=dev, dtype=torch.int32)

    with torch.inference_mode():
        for label, cloud in fps_clouds(dev, gen):
            args = (cloud, SA[0][0], random_start(B, N))
            log(f"[fps] N={N} {label}, random starts:")
            err["fps"] = max(err["fps"], check_call("fps", "fps", args, fps_cuda(*args)))

    entries = []
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    for level, (npoint, _) in enumerate(SA):
        xyz = levels[level]
        entries.append(fps_shape_times(f"SA{level + 1} B={B} N={xyz.shape[1]}", xyz, npoint, start,
                                       fps_torch(xyz, npoint, start), smi))
    xyz, npoint, gstart = next(a for name, a, _ in grid_calls if name == "fps")
    entries.append(fps_shape_times(f"Path G SA1 B={B} N={xyz.shape[1]}", xyz, npoint, gstart,
                                   fps_torch(xyz, npoint, gstart), smi))
    for n, npoint in FPS_LARGE_N:
        for b in (B, 1):
            xyz = torch.rand(b, n, 3, generator=gen).to(dev)
            st = random_start(b, n) if b == B else torch.zeros(b, dtype=torch.int32, device=dev)
            want, plain_ms = timed_plain_fps(xyz, npoint, st)
            label = f"B={b} N={n}"
            log(f"[fps] {label}, S={npoint}, {'random starts' if b == B else 'start 0'}:")
            err["fps"] = max(err["fps"], check_call("fps", "fps", (xyz, npoint, st),
                                                    fps_cuda(xyz, npoint, st), want=want))
            entries.append(fps_shape_times(label, xyz, npoint, st, want, smi, plain_ms))
            del xyz, want

    # the serving path at N=16384, which raised at SA1 before the cap went:
    # SA1 takes the grid ball query (N >= 8192), so a forward launches what
    # one of Path G does
    pred = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev)
    cloud = torch.rand(2, FPS_PREDICTOR_N, C, generator=gen).numpy()
    out, calls = recorded_forward("fps", lambda: pred(cloud), "grid_forward", err)
    check_log_probs("fps", [out], [(2, FPS_PREDICTOR_N, CLASSES)])
    log(f"[fps] Predictor B=2 N={FPS_PREDICTOR_N}: FPS at N = "
        + ", ".join(str(a[0].shape[1]) for name, a, _ in calls if name == "fps")
        + ", every call equal to the plain version; log-probs finite and normalised")
    return entries


# ------------------------------------------- ball query and 3-NN: plans and edges

# device µs per launch at SA1-SA4 / FP1-FP4 in the main path's trace of
# the two kernels' earlier design, a warp a center and a thread a query
# (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W)
EARLIER_DEVICE_US = {"ballquery": (112.5, 12.3, 4.2, 1.9), "three_nn": (56.2, 15.3, 5.2, 2.6)}
NEIGHBOUR_LARGE_N = (12289, 32768)  # ball query at B=1, S = N/4
LARGE_BATCH = 128  # clouds of SA2's 1024 points, every point a center
THREE_NN_EDGE_M = (3, 4, 17, 4097)


def log_neighbour_levels(device_ms, times, smi):
    """Each level's device µs of the two redesigned kernels in the main
    path's trace beside the earlier design's and the bound."""
    for name, unit in (("ballquery", "SA"), ("three_nn", "FP")):
        for level in range(len(SA)):
            dev_txt = ("device not measured" if device_ms is None
                       else f"device {device_ms[name][level] * 1e3:.1f} us")
            log(f"[neighbours] {name} {unit}{level + 1}: {dev_txt} per launch "
                f"(earlier design: {EARLIER_DEVICE_US[name][level]}), bound "
                f"{times[name]['bound_ms'][level] * 1e3:.2f} us ({smi})")


def plan_label(plan):
    return " ".join(f"{key}={value}" for key, value in plan._asdict().items()
                    if key in ("per_lane", "ranges", "groups"))


def sweep_plans(name, args, default, smi):
    """Every instance of the kernel at these inputs (each power-of-two split
    that leaves 32 points a range; for the ball query at one and two
    centers a lane, and a warp a center): held bit for bit to its order
    model and timed on the device, one event a call. Returns
    ``[{plan, device_ms, default}]``."""
    if name == "ballquery":
        radius, k, xyz, centers = args
        b, n, s = xyz.shape[0], xyz.shape[1], centers.shape[1]
        make = functools.partial(ballquery_plan, b, n, s, k)
        run = functools.partial(ballquery_cuda, radius, k, xyz, centers)
        per_lanes, points = ballquery_module.PER_LANE, n
    else:
        query, ref = args
        b, n = query.shape[:2]
        s = ref.shape[1]
        make = functools.partial(three_nn_plan, b, n, s)
        run = functools.partial(three_nn_cuda, query, ref)
        per_lanes, points = (None,), s
    rows = []
    for per_lane in per_lanes:
        for ranges in (1, 2, 4, 8, 16):
            # per_lane 0 (the ball query's warp a center) scans one range
            if ranges > 1 and (points // ranges < 32 or per_lane == 0):
                continue
            plan = (make(ranges=ranges) if per_lane is None
                    else make(per_lane=per_lane, ranges=ranges))
            with torch.inference_mode():
                check_order_model("sweep", name, args, run(plan=plan), plan)
                timed = call_device_ms(f"sweep {name} {plan_label(plan)}",
                                       functools.partial(run, plan=plan), events=1)
            rows.append({"plan": plan._asdict(), "default": plan == default,
                         "device_ms": None if timed is None else timed[0]})
            log(f"[sweep] {name} B={b} N={n} {'S' if name == 'ballquery' else 'M'}={s} "
                f"{plan_label(plan)}{' (default)' if plan == default else ''}: "
                + ("device not measured" if timed is None else f"device {timed[0] * 1e3:.1f} us")
                + f" ({smi})")
    timed = [r for r in rows if r["device_ms"] is not None]
    if timed:
        best = min(timed, key=lambda r: r["device_ms"])
        log(f"[sweep] {name} N={n}: fastest {plan_label(type(default)(**best['plan']))}, "
            f"{best['device_ms'] * 1e3:.1f} us; the default "
            f"{next(r['device_ms'] for r in timed if r['default']) * 1e3:.1f} us")
    return rows


def phase_neighbours(dev, gen, levels, err, smi):
    """The redesigned ball query and 3-NN at their edges, each call held to
    its plain version (masked rows) and bit for bit to its order model:
    the ball query at K = 1, 32, 64, 128 (r=0.2) on the slice's first
    level, with three centers of each cloud out of every ball, on the
    clustered clouds with half the centers on the spot (they reach K in
    the first range), at N = 12289 and 32768 (B=1, S=N/4), and on a batch
    of 128 clouds of 1024 points, each point a center (two groups of
    centers a block); 3-NN with
    M = 3, 4, 17, 4097 references and with the first level's 1024 centers
    twice over (reference j and j + 1024 equal, on either side of the
    boundary at two ranges) under queries on them, at the default plan and
    at 2 and 4 ranges. Then the plan
    sweep at the four slice shapes of each. Returns ``{name: sweep}``."""
    xyz, centers = levels[0], levels[1]
    with torch.inference_mode():
        calls = [(0.2, k, xyz, centers) for k in (1, 32, 64, 128)]
        calls.append((0.1, K, xyz, out_of_every_ball(centers)))
        for label, cloud in clustered_clouds(dev, gen, N):
            spot = cloud[:, :SA[0][0] // 2]
            calls.append((0.1, K, cloud, torch.cat(
                [spot, random_centers(cloud, SA[0][0] // 2, gen)], 1).contiguous()))
            log(f"[neighbours] clustered cloud, {label}")
        for n in NEIGHBOUR_LARGE_N:
            cloud = torch.rand(1, n, 3, generator=gen).to(dev)
            calls.append((0.1, K, cloud, random_centers(cloud, n // 4, gen)))
        # a large batch, every point a center: two groups a block
        cloud = torch.rand(LARGE_BATCH, SA[1][0] * 4, 3, generator=gen).to(dev)
        require(ballquery_plan(LARGE_BATCH, cloud.shape[1], cloud.shape[1], K).groups > 1,
                "[neighbours] the large batch's plan holds one group a block")
        calls.append((0.2, K, cloud, cloud))
        for args in calls:
            err["ballquery"] = max(err["ballquery"],
                                   check_call("neighbours", "ballquery", args, ballquery_cuda(*args)))
        query = levels[0]
        nn_calls = [(query, torch.rand(B, m, 3, generator=gen).to(dev)) for m in THREE_NN_EDGE_M]
        twins = torch.cat([levels[1], levels[1]], 1).contiguous()
        on_refs = torch.cat([levels[1][:, :512], query[:, 512:]], 1).contiguous()
        nn_calls.append((on_refs, twins))
        for args in nn_calls:
            err["three_nn"] = max(err["three_nn"],
                                  check_call("neighbours", "three_nn", args, three_nn_cuda(*args)))
            b, n, m = args[0].shape[0], args[0].shape[1], args[1].shape[1]
            for ranges in (2, 4):
                if m // ranges >= 2:
                    plan = three_nn_plan(b, n, m, ranges=ranges)
                    check_order_model("neighbours", "three_nn", args,
                                      three_nn_cuda(*args, plan=plan), plan)

    sweeps = {"ballquery": [], "three_nn": []}
    for level, (npoint, radius) in enumerate(SA):
        x, c = levels[level], levels[level + 1]
        sweeps["ballquery"].append(sweep_plans(
            "ballquery", (radius, K, x, c),
            ballquery_plan(B, x.shape[1], c.shape[1], K), smi))
        sweeps["three_nn"].append(sweep_plans(
            "three_nn", (x, c), three_nn_plan(B, x.shape[1], c.shape[1]), smi))
    return sweeps


# ---------------------------------------------------------------- the launch path


def host_ns(fn, reps=None, sync=False):
    """``(median, mean)`` host ns of one call of ``fn`` over ``reps`` calls
    (``HOST_REPS`` by default), each timed alone by ``time.perf_counter_ns`` after 20 untimed ones; with
    ``sync`` the card is synchronized after every call, outside the timed
    span, so a launch never waits on a full queue."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(HOST_REPS if reps is None else reps):
        t0 = time.perf_counter_ns()
        fn()
        samples.append(time.perf_counter_ns() - t0)
        if sync:
            torch.cuda.synchronize()
    return statistics.median(samples), statistics.fmean(samples)


def old_idiom(entry, dev, args):
    """The former launch of every wrapper (``build.library()``,
    ``torch.cuda.device``, a ``Stream`` object for the handle, the ctypes
    call, the code checked): the yardstick of :func:`build.launch`."""
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"pn12_{entry}")(*args, stream)
    require(code == 0, f"{entry}: launch failed ({code})")


def phase_launch_path(seg_args, prep_call, smi):
    """Where a wrapper's host time goes, part by part, for the segment sum
    at FP1's shape and the grid prep at Path G's SA1 (host ns of 1000 calls
    of each part, :func:`host_ns`): its checks, the output's allocation
    (``torch.zeros``, as the segment sum's output was zeroed before, and
    ``torch.empty``), ``build.library()``, the device switch
    (``torch.cuda.device``) and the ``Stream`` object
    (``current_stream().cuda_stream``) of the old launch, the calls that
    take their place (``_cuda_getDevice``, ``_cuda_getCurrentRawStream``),
    the ctypes call alone, the whole old launch, ``build.launch`` and the
    whole wrapper; beside them an empty call and one PyTorch op
    (``torch.searchsorted`` of the offsets). Returns ``{label: (median,
    mean)}``."""
    idx, weights, values, m = seg_args
    b, j, r = idx.shape
    c = values.shape[2]
    dev = values.device
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    seg_ptrs = (idx.data_ptr(), None if weights is None else weights.data_ptr(),
                values.data_ptr(), out.data_ptr(), b, j, r, m, c)

    def seg_checks():
        build.check_tensor("segment_matmul", "idx", idx, torch.int32, (None, None, None))
        if weights is not None:
            build.check_tensor("segment_matmul", "weights", weights, torch.float32,
                               (b, j, r), dev)
        build.check_tensor("segment_matmul", "values", values, torch.float32, (b, r, None),
                           dev)

    radius, xyz, centers = prep_call
    n, s = xyz.shape[1], centers.shape[1]
    shapes = {"perm": (b, n), "skey": (b, n), "offsets": (b, GRID_RES**3 + 1),
              "qperm": (b, s), "sqkey": (b, s)}
    total = sum(r * c for r, c in shapes.values())
    grid = Grid(torch.empty(total, dtype=torch.int32, device=dev), shapes)
    prep_ptrs = (xyz.data_ptr(), centers.data_ptr(), *(grid.ptr(key) for key in shapes),
                 b, n, s, GRID_RES, radius)

    def prep_checks():
        build.check_tensor("grid_prep", "xyz", xyz, torch.float32, (None, None, 3))
        build.check_tensor("grid_prep", "new_xyz", centers, torch.float32, (b, None, 3), dev)

    def prep_buffer():
        return Grid(torch.empty(total, dtype=torch.int32, device=dev), shapes)

    def prep_views():
        return [grid[key] for key in shapes]

    def device_switch():
        with torch.cuda.device(dev):
            pass

    skey = grid_prep_torch(*prep_call)["skey"]
    searchsorted = offsets_library(skey, GRID_RES**3)
    parts = {
        "empty call": (lambda: None, False),
        "build.library()": (build.library, False),
        "torch.cuda.device enter + exit (old)": (device_switch, False),
        "current_stream().cuda_stream (old)": (
            lambda: torch.cuda.current_stream().cuda_stream, False),
        "_cuda_getDevice() (new)": (torch._C._cuda_getDevice, False),
        "_cuda_getCurrentRawStream (new)": (
            lambda: torch._C._cuda_getCurrentRawStream(dev.index), False),
        "one PyTorch op: torch.searchsorted": (searchsorted, True),
        "segment_matmul checks": (seg_checks, False),
        "segment_matmul torch.zeros (old)": (
            lambda: torch.zeros((b, m, c), dtype=torch.float32, device=dev), True),
        "segment_matmul torch.empty": (
            lambda: torch.empty((b, m, c), dtype=torch.float32, device=dev), False),
        "segment_matmul ctypes call": (
            lambda: lib.pn12_segment_matmul(*seg_ptrs, stream), True),
        "segment_matmul old launch": (
            lambda: old_idiom("segment_matmul", dev, seg_ptrs), True),
        "segment_matmul build.launch": (
            lambda: build.launch("segment_matmul", dev, *seg_ptrs), True),
        "segment_matmul wrapper": (lambda: segment_matmul_cuda(*seg_args), True),
        "grid_prep checks": (prep_checks, False),
        "grid_prep torch.empty + Grid": (prep_buffer, False),
        "grid_prep the five views (on demand only)": (prep_views, False),
        "grid_prep ctypes call": (lambda: lib.pn12_grid_prep(*prep_ptrs, stream), True),
        "grid_prep old launch": (lambda: old_idiom("grid_prep", dev, prep_ptrs), True),
        "grid_prep build.launch": (lambda: build.launch("grid_prep", dev, *prep_ptrs), True),
        "grid_prep wrapper": (lambda: grid_prep_cuda(*prep_call), True),
    }
    result = {}
    for label, (fn, sync) in parts.items():
        result[label] = host_ns(fn, sync=sync)
        log(f"[launch path] {label}: median {result[label][0] / 1e3:.2f} us, mean "
            f"{result[label][1] / 1e3:.2f} us a call on the host ({smi})")
    return result


def new_kernel_summary(name, by_path, err, times):
    """The ``{"kernels": [...]}`` entry of a kernel of this slice: sums over
    its shapes on Paths F and G, the shapes in ``per_shape``."""
    t, k = times[name], KERNELS[name]
    widest = max(range(len(t["bound_ms"])), key=t["bound_ms"].__getitem__)
    device = t["device_ms"]
    entry = {
        "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": err[name], "ms": sum(t["ms"]), "plain_ms": sum(t["plain_ms"]),
        "bound_ms": sum(t["bound_ms"]), "bound_by": t["bound_by"][widest],
        # torch.searchsorted computes the cell offsets, the grid prep's
        # by-product (no single PyTorch call computes the whole prep); no
        # single call computes the others, whose yardsticks (the unfused
        # kernel path of a fused layer, ballquery.cu beside the grid ball
        # query) are in per_shape
        "library_ms": None if None in t["library_ms"] else sum(t["library_ms"]),
        "device_ms": sum(device) if len(device) == len(t["ms"]) else None,
        "per_shape": t,
    }
    if "also_replaces" in k:
        entry["also_replaces"] = k["also_replaces"]
    return entry


def main():
    t0 = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    levels = level_clouds(dev, gen)
    err = phase_kernels(dev, levels)
    pred, plain, request, serve_launches, sd = phase_slice(dev, gen)
    phase_continuous(gen, pred, plain)
    times = phase_times(dev, levels, pred, plain, request, smi)
    device_ms = phase_profile(pred, request, smi)
    log_neighbour_levels(device_ms, times, smi)
    del pred, plain
    state, batch, card_gen, train_launches, eval_launches = phase_train(dev, gen)
    seg_calls, err["segment_matmul"] = phase_train_calls(state, batch, card_gen)
    err["segment_matmul"] = max(err["segment_matmul"], phase_segsum_shapes(dev, gen))
    phase_train_grads(dev, gen)
    step_ms, plain_step_ms, seg_shapes = phase_train_times(state, batch, card_gen,
                                                           seg_calls, smi)
    del state
    err["dense_bn_stats"], bn_times = phase_bn_kernel(dev, smi)
    fstate, fgen, fused_launches, fused_eval_launches = phase_fused_train(dev, batch)
    err["dense_bn_stats"] = max(err["dense_bn_stats"], phase_fused_calls(fstate, batch, fgen))
    phase_fused_grads(dev, gen)
    medians, bn_device, sr_cast = phase_fused_times(dev, fstate, batch, fgen, bn_times, smi)
    del fstate
    pred = Predictor.from_state_dict("pointnet2_semseg", sd, CLASSES, device=dev)
    fused, fused_serve_launches, fused_calls = phase_fused_serve(dev, gen, sd, pred, err)
    grid_pred, grid_serve_launches, grid_calls = phase_grid_serve(dev, gen, sd, err)
    phase_prep_clouds(dev, gen, err)
    new_times, serve_medians = phase_new_times(fused_calls, grid_calls, pred, fused, grid_pred,
                                               request, smi)
    phase_launch_path(seg_calls[0][0], prep_args(grid_calls), smi)
    fps_entries = phase_fps(dev, gen, levels, grid_calls, sd, err, smi)
    sweeps = phase_neighbours(dev, gen, levels, err, smi)
    log(f"[done] {time.perf_counter() - t0:.1f} s")

    summary = []
    for name, k in KERNELS.items():
        # launches counted on the main paths: 5 serving forwards, 10 fp32
        # train steps and one eval step, 10 bf16+SR fused train steps and
        # one bf16 eval step
        # and 4 forwards of Path F (impl="fused"), one of Path G (N=8192)
        by_path = {"serve": serve_launches[name], "train": train_launches[name],
                   "eval": eval_launches[name], "bf16_sr_fused_train": fused_launches[name],
                   "bf16_eval": fused_eval_launches[name],
                   "fused_serve": fused_serve_launches[name],
                   "grid_serve": grid_serve_launches[name]}
        if name in NEW:
            summary.append(new_kernel_summary(name, by_path, err, new_times))
            continue
        if name == "dense_bn_stats":
            # per bf16+SR fused train step: the sum over its 17 calls of the
            # wrapper and of the plain version at those shapes (CUDA events);
            # the device time from the trace of that step. The fp32 fused
            # step's device time and launches (the fp32 route, 17 a step, in
            # its trace) stand beside them. No single PyTorch call computes
            # y and its statistics: F.linear (the product alone) and F.linear
            # plus the plain statistics stand beside it per shape, in both
            # dtypes.
            t = bn_times["bf16"]
            fp32_device = bn_device["fp32"]
            summary.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err[name],
                "ms": sum(t["ms"]), "plain_ms": sum(t["plain_ms"]),
                "bound_ms": sum(t["bound_ms"]),
                "bound_by": t["bound_by"][max(range(17), key=t["bound_ms"].__getitem__)],
                "library_ms": None,
                "device_ms": None if bn_device["bf16"] is None else sum(bn_device["bf16"]),
                "fp32_fused_step": {
                    "device_ms": None if fp32_device is None else sum(fp32_device),
                    # the launches in its trace, a step
                    "launches": None if fp32_device is None else len(fp32_device),
                    "ms": sum(bn_times["fp32"]["ms"]),
                    "plain_ms": sum(bn_times["fp32"]["plain_ms"]),
                    "bound_ms": sum(bn_times["fp32"]["bound_ms"]),
                    "bound_simt_ms": sum(bn_times["fp32"]["bound_simt_ms"]),
                    "bound_tc_ms": sum(bn_times["fp32"]["bound_tc_ms"]),
                    "linear_device_ms": (None if None in bn_times["fp32"]["linear_device_ms"]
                                         else sum(bn_times["fp32"]["linear_device_ms"]))},
                "per_shape": {"call": [c[0] for c in bn_calls()],
                              "device_ms_bf16": bn_device["bf16"],
                              "device_ms_fp32": fp32_device, **bn_times},
            })
            continue
        if name in SERVE:
            # per forward: the sum over the slice's four shapes, CUDA events
            # around back-to-back calls of the wrapper and of the plain
            # version; the device time from the trace of the main path
            t = times[name]
            per_shape = dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                             bound_by=t["bound_by"],
                             device_ms=None if device_ms is None else device_ms[name])
            if name == "fps":
                # phase 14: threads, ns an iteration and the thread-count
                # sweep at the slice shapes, Path G's SA1 and the new N
                per_shape["shapes"] = fps_entries
            else:
                # phase 15: every plan at each slice shape, device time
                per_shape["plans"] = sweeps[name]
            library = None  # no single PyTorch call computes it
        else:
            # per train step: the sum over the 7 calls; the library call is
            # the sparse product at each of them (index_add_, per shape,
            # at the 3 unweighted ones only)
            per_shape = {key: [e[key] for e in seg_shapes]
                         for key in ("call", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "device_ms", "wrapper_device_ms", "library_ms",
                                     "library_device_ms", "index_add_ms")}
            library = sum(per_shape["library_ms"])
        widest = max(range(len(per_shape["bound_ms"])), key=per_shape["bound_ms"].__getitem__)
        device = per_shape["device_ms"]
        entry = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err[name],
            "ms": sum(per_shape["ms"]), "plain_ms": sum(per_shape["plain_ms"]),
            # the least time summed over the shapes, bound as its widest shape
            "bound_ms": sum(per_shape["bound_ms"]),
            "bound_by": per_shape["bound_by"][widest],
            "library_ms": library,
            "device_ms": None if device is None or None in device else sum(device),
            "per_shape": per_shape,
        }
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        summary.append(entry)
    log(f"[train] step: kernel path median {step_ms:.3f} ms, {B / step_ms * 1e3:.1f} "
        f"clouds/sec; plain path median {plain_step_ms:.3f} ms, "
        f"{B / plain_step_ms * 1e3:.1f} clouds/sec ({smi})")
    log("[fused train] step medians: " + ", ".join(
        f"{label} {ms:.3f} ms ({B / ms * 1e3:.1f} clouds/sec)" for label, ms in medians.items())
        + (f"; SR casts {sr_cast[0]:.1f} us per step on the device, {sr_cast[1]:.3f} of busy"
           if sr_cast else "") + f" ({smi})")
    log("[new times] Predictor medians: " + ", ".join(
        f"{label} {ms:.3f} ms ({B / ms * 1e3:.1f} clouds/sec)"
        for label, ms in serve_medians.items()) + f" ({smi})")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fp32-bn-step"]:
        fp32_bn_step_only()
    else:
        main()
