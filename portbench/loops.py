"""The general loops that drive the program, one per kind of traffic.

A traffic file's ``"loop"`` names one of ``LOOPS``; its other keys are
that loop's parameters. A loop builds the program's objects from the
configuration and the seed, warms up the cell's own shapes, measures for
the given seconds, optionally traces a short sub-window, frees the
program's state, and hands the reference what it needs to check the run.
It fills a :class:`Context`, from which the metric readers
(``metrics/*.py``) read.

From the program (``pointnet12_tpu_torch``) the loops take only its entry
points: ``train.loop.create_train_state`` / ``make_train_step`` fed by
``data.loader.Feeder`` (with ``parallel.mesh`` under data parallelism) and
``infer.Predictor.predict_labels``, and the kernel build
(``kernels.build.library``). Everything else is the benchmark's own.
"""

import random
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from portbench import check, trace
from portbench.data import make_pool
from portbench.seeds import streams
from portbench.trace import Trace
from portbench.weights import make_weights


@dataclass
class Context:
    """What a run measured, for the metric readers."""

    cfg: dict
    traffic: dict
    chips: int
    train: bool = False  # a train loop's window (three forwards a cloud)
    setup_s: float = 0.0
    window_s: float = 0.0
    clouds: int = 0
    attempted: int = 0
    latencies_s: list = field(default_factory=list)
    feeder_wait_s: list = field(default_factory=list)
    trace: Optional[Trace] = None  # device events only
    host_trace: Optional[Trace] = None  # with the host's ops, for the idle gaps
    families: dict = field(default_factory=dict)
    busy_s: Optional[float] = None  # the traced sub-window's, over the ranks
    rank_device: list = field(default_factory=list)  # each rank's [(name, µs)] of the trace
    memory_peak_bytes: int = 0
    checks: dict = field(default_factory=dict)  # number -> value
    marks: list = field(default_factory=list)  # set-up's stages
    marks_s: list = field(default_factory=list)  # when each step or request of the window ended


class Env:
    """Where a loop runs: the device, the data-parallel mesh (None in one
    process), the start time of the run and how to synchronise."""

    def __init__(self, device, start: float, mesh=None, gloo=None):
        self.device = torch.device(device)
        self.start = start
        self.mesh = mesh
        self.gloo = gloo  # a CPU group of the ranks, for host-side agreement
        self.marks = []  # (stage of set-up, seconds since the start)

    def mark(self, stage: str):
        self.marks.append((stage, time.time() - self.start))

    @property
    def lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (host side, no device sync)."""
        if self.gloo is None:
            return flag
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.gloo)
        return bool(t.item())

    def mean(self, value: float) -> float:
        if self.gloo is None:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        torch.distributed.all_reduce(t, group=self.gloo)
        return float(t.item()) / self.mesh.size

    def max(self, value: int) -> int:
        if self.gloo is None:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.gloo)
        return int(t.item())

    def agree_fault(self, fault):
        return fault if not self.any(fault is not None) else (fault or "a fault on another rank")

    def gather(self, obj) -> list:
        """``obj`` of every rank, in rank order (host side)."""
        if self.gloo is None:
            return [obj]
        out = [None] * self.mesh.size
        torch.distributed.all_gather_object(out, obj, group=self.gloo)
        return out

    def barrier(self):
        if self.gloo is not None:
            torch.distributed.barrier(group=self.gloo)


def _traces(ctx: Context, env: Env, one, reps: int, pad: int, families: dict):
    """The traced sub-window, twice: device events alone (busy and idle
    time, the kernels' device time and the families' calls), then with the
    host's ops for the idle gaps' names."""
    ctx.families = families
    ctx.trace = trace.traced_window(one, reps, pad, env.device, families,
                                    agree=env.agree_fault)
    if ctx.trace is not None:
        ctx.busy_s = env.mean(ctx.trace.busy_s)
        ctx.rank_device = env.gather([(e["name"], float(e["dur"])) for e in ctx.trace.device])
        try:  # only the breakdown's idle gaps read it
            ctx.host_trace = trace.traced_window(one, reps, pad, env.device, {}, host=True,
                                                 agree=env.agree_fault)
        except RuntimeError as e:
            print(f"the idle gaps are not named: {e}", file=sys.stderr)


def _memory_peak(env: Env) -> int:
    return torch.cuda.max_memory_allocated(env.device) if env.device.type == "cuda" else 0


def _model_kwargs(cfg: dict) -> dict:
    kw = {"dropout_rate": cfg["dropout"]}
    if cfg["channels"] != 3 or cfg["task"] == "seg":
        kw["in_channels"] = cfg["channels"]
    return kw


AGREE_EVERY = 8  # steps between the ranks' agreements to close the window


def train(env: Env, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
          families: dict, program=None) -> Context:
    """A closed loop of training: ``make_train_step`` on the ``Feeder``'s
    shuffled, augmented batches of the configuration's pool, rolled over
    epochs as ``run_training`` does; under data parallelism every rank
    draws the global batch and takes its rows (``shard_batch``). The first
    ``check.TRAIN_STEPS`` steps are set-up, and are what the reference
    checks; ``traffic["warmup"]`` more follow before the window. Ranks
    agree on the window's end every ``AGREE_EVERY`` steps (on the host),
    so it closes at most that many steps after ``seconds``."""
    from pointnet12_tpu_torch.data import Feeder
    from pointnet12_tpu_torch.data import augment as program_augment
    from pointnet12_tpu_torch.kernels import build
    from pointnet12_tpu_torch.parallel.mesh import replicate_, shard_batch
    from pointnet12_tpu_torch.train import loop

    program = program or loop
    s = streams(seed)
    ranks = 1 if env.mesh is None else env.mesh.size
    batch = cfg["batch"] * ranks  # the global batch: the configuration's batch a card
    ctx = Context(cfg, traffic, ranks, train=True)
    env.mark("imports")
    if env.device.type == "cuda":
        build.library()
    env.mark("kernels")
    weights = make_weights(cfg, s["weights"], env.device)
    env.mark("weights")
    pool = make_pool(cfg, cfg["data"]["pool"], s["data"])
    env.mark("data")
    augment_fn = getattr(program_augment, f"{cfg['data']['augment']}_augment")
    feeder = Feeder(pool, batch, shuffle=True, augment_fn=augment_fn, seed=s["feeder"],
                    prefetch=True)
    opt = dict(cfg["optimizer"], steps_per_epoch=len(feeder))
    state = loop.create_train_state(cfg["model"], cfg["num_classes"], device=env.device,
                                    state_dict=weights, optimizer=opt, **_model_kwargs(cfg))
    del weights
    if env.mesh is not None:
        replicate_(state.model, env.mesh)
    step = program.make_train_step(cfg["task"], mesh=env.mesh)
    shard = (lambda b: b) if env.mesh is None else (lambda b: shard_batch(b, env.mesh))
    generator = torch.Generator(env.device).manual_seed(s["steps"])
    env.mark("state")

    def endless():
        while True:
            yield from feeder

    batches = endless()
    watch = check.TrainWatch(state)
    for _ in range(check.TRAIN_STEPS):
        watch.after_step(step(state, shard(next(batches)), generator))
    watch.done()
    env.mark("checked steps")
    for _ in range(traffic["warmup"]):
        step(state, shard(next(batches)), generator)
    env.sync()
    env.mark("warm-up")
    env.barrier()
    ctx.setup_s = time.time() - env.start
    ctx.marks = env.marks

    steps, every = 0, 1 if env.gloo is None else AGREE_EVERY
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        b = next(batches)
        ctx.feeder_wait_s.append(time.perf_counter() - a)
        step(state, shard(b), generator)
        steps += 1
        ctx.marks_s.append(time.perf_counter() - t0)
        if steps % every == 0 and env.any(ctx.marks_s[-1] >= seconds):
            break
    env.sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.attempted, ctx.clouds = steps, steps * batch
    ctx.memory_peak_bytes = env.max(_memory_peak(env))

    if traced:
        def one():
            with trace.span("feeder_next"):
                b = next(batches)
            with trace.span("train_step"):
                step(state, shard(b), generator)

        _traces(ctx, env, one, traffic["trace_steps"], 1, families)
    del state, step, batches
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    if env.lead:
        ctx.checks = check.train(cfg, s, pool, batch, watch, env.device)
    return ctx


def serve_requests(cfg: dict, traffic: dict, s: dict) -> list:
    """The ``traffic["requests"]`` distinct request batches of a serving
    run, each of the configuration's batch of seeded clouds, in a seeded
    order."""
    b, n = cfg["batch"], traffic["requests"]
    pool = make_pool(cfg, n * b, s["data"])
    order = np.random.RandomState(s["requests"]).permutation(n * b)
    return [np.ascontiguousarray(pool.points[order[r * b:(r + 1) * b]]) for r in range(n)]


def _keeping(predictor_cls):
    """``predictor_cls`` whose call keeps its last log-probabilities (a
    reference, no copy): ``predict_labels`` computes its labels from them,
    and the check compares them."""

    class Keeping(predictor_cls):
        last = None

        def __call__(self, points):
            self.last = super().__call__(points)
            return self.last

    return Keeping


def serve(env: Env, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
          families: dict, program=None) -> Context:
    """One caller in a closed loop of labelling requests:
    ``Predictor.predict_labels`` on batches drawn in a seeded order from the
    distinct request batches, each timed from the call to the labels on the
    host. The check compares the log-probabilities from which
    ``predict_labels`` took the labels, for a seeded sample of
    ``traffic["sample"]`` served requests, with the reference's."""
    from pointnet12_tpu_torch.infer import Predictor
    from pointnet12_tpu_torch.kernels import build

    predictor_cls = _keeping(program or Predictor)
    s = streams(seed)
    ctx = Context(cfg, traffic, 1)
    env.mark("imports")
    if env.device.type == "cuda":
        build.library()
    env.mark("kernels")
    weights = make_weights(cfg, s["weights"], env.device)
    env.mark("weights")
    kw = _model_kwargs(cfg)
    kw.pop("dropout_rate")
    pred = predictor_cls.from_state_dict(cfg["model"], weights, cfg["num_classes"],
                                         device=env.device, **kw)
    del weights
    b = cfg["batch"]
    requests = serve_requests(cfg, traffic, s)
    pick = random.Random(s["requests"])
    sampler = random.Random(s["sample"])
    env.mark("predictor and data")
    for r in range(traffic["warmup"]):
        pred.predict_labels(requests[r % len(requests)])
    env.sync()
    env.mark("warm-up")
    ctx.setup_s = time.time() - env.start
    ctx.marks = env.marks

    sample = []  # a uniform sample of the served requests (reservoir)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r = pick.randrange(len(requests))
        a = time.perf_counter()
        pred.predict_labels(requests[r])
        ctx.latencies_s.append(time.perf_counter() - a)
        ctx.marks_s.append(time.perf_counter() - t0)
        i = len(ctx.latencies_s) - 1
        if i < traffic["sample"]:
            sample.append((r, pred.last))
        else:
            j = sampler.randrange(i + 1)
            if j < traffic["sample"]:
                sample[j] = (r, pred.last)
    ctx.window_s = time.perf_counter() - t0
    ctx.attempted = len(ctx.latencies_s)
    ctx.clouds = ctx.attempted * b
    ctx.memory_peak_bytes = _memory_peak(env)

    if traced:
        def one():
            with trace.span("request"):
                pred.predict_labels(requests[pick.randrange(len(requests))])

        _traces(ctx, env, one, traffic["trace_calls"], 2, families)
    del pred
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.checks = check.serve(cfg, s, [(requests[r], lp) for r, lp in sample], env.device)
    return ctx


LOOPS = {"train": train, "serve": serve}
