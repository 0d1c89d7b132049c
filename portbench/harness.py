"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run looks up the cell in ``BENCHMARK.json`` (``spec.py``), refuses to
run without enough cards, drives the program through the cell's loop
(``loops.py``), checks what the timed path produced against the plain
reference (``check.py``), and prints, as the last lines of standard
error, each compared number beside its limit and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``. A line before it gives the toolchain: card, count and power
limit, torch, CUDA and nvcc.

A cell of several cards starts one rank a card (this script again, with
``--rank``), over NCCL, with a rendezvous file in the temporary
directory; rank 0 measures and checks, and this process prints its line.
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from portbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "pointnet12_tpu")
EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_RANKS = 2, 3, 4
RANKS_TIMEOUT_S = 340


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell of several cards, started by the run itself
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    p.add_argument("--start", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``pointnet12_tpu_torch`` is not
    ``pointnet12_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def toolchain(chips: int) -> str:
    """The card's name, count and power limit, torch, CUDA and nvcc."""
    import torch

    def out(cmd):
        try:
            return subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            return ""

    limit = out(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"]).split("\n")[0]
    nvcc = [ln for ln in out([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "--version"])
            .splitlines() if "release" in ln]
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card"
    return (f"toolchain: {card} x{chips}, power limit "
            f"{limit.strip() or 'not read'}, torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, nvcc {nvcc[0].strip() if nvcc else 'not found'}")


def run_cell(spec: Spec, args, start: float, device=None, mesh=None, gloo=None,
             program=None, config=None, traffic=None) -> dict:
    """One run of the cell in this process (one rank of a data-parallel
    cell): the result line as a dict, empty on a rank other than 0.
    ``device`` None means the card; a test passes "cpu" and smaller
    ``config``/``traffic``; ``program`` replaces the program's entry for a
    fault test."""
    import torch

    from portbench import loops

    cell = spec.cell(args.workload)
    cfg = config or spec.config(cell["config"])
    mix = traffic or spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if device is None:
        device = f"cuda:{0 if mesh is None else mesh.rank}"
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = loops.Env(device, start, mesh, gloo)
    families = spec.families() if args.trace else {}
    ctx = loops.LOOPS[mix["loop"]](env, cfg, mix, args.seed, args.seconds, bool(args.trace),
                                   families, program)
    if not env.lead:
        return {}
    metrics = {}
    for m in spec.metrics(cell["name"], per_layer=bool(args.trace)):
        value = spec.read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    where = ctx.checks.pop("_where", {})
    checks = {k: {"value": v, "limit": limits[k]} for k, v in ctx.checks.items() if k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(checks)
    dev = {"platform": "gpu" if env.device.type == "cuda" else env.device.type,
           "kind": (torch.cuda.get_device_name(env.device) if env.device.type == "cuda"
                    else "cpu"),
           "count": ctx.chips, "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": correct, "attempted": ctx.attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        from portbench import trace

        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(ctx.trace),
                               "idle_gaps": trace.idle_gaps(ctx.host_trace)}
    say("set-up: " + ", ".join(f"{stage} {t:.2f} s" for stage, t in ctx.marks))
    say("window: units a second, by 2 s: " + " ".join(
        str(sum(1 for t in ctx.marks_s if lo <= t < lo + 2) / 2)
        for lo in range(0, int(ctx.window_s), 2)))
    for k, w in where.items():
        say(f"check {k} worst at {w}")
    for k, v in ctx.checks.items():
        if k not in limits:
            say(f"reading {k}: {v!r} (not compared: it has no upper reading)")
    result["checks"] = checks
    return result


def _finish(result: dict, chips: int) -> int:
    """Print the toolchain, the checks and the result line, or refuse."""
    bad = forbidden_modules()
    if bad:
        say(f"refused: modules of {', '.join(bad)} are loaded")
        return EXIT_FORBIDDEN
    print(toolchain(chips), flush=True)
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def _card_count(need: int) -> bool:
    import torch

    if not torch.cuda.is_available():
        say("refused: no CUDA device (torch.cuda.is_available() is false)")
        return False
    if torch.cuda.device_count() < need:
        say(f"refused: the cell needs {need} cards, {torch.cuda.device_count()} are visible")
        return False
    return True


def _rank_main(spec: Spec, args) -> int:
    """One rank of a data-parallel cell: rank 0 prints the result line."""
    import torch

    from pointnet12_tpu_torch.parallel.mesh import make_mesh

    chips = spec.cell(args.workload)["chips"]
    mesh = make_mesh(f"cuda:{args.rank}", init_method=args.init_method, rank=args.rank,
                     world_size=chips)
    gloo = torch.distributed.new_group(backend="gloo")
    try:
        result = run_cell(spec, args, args.start, mesh=mesh, gloo=gloo)
        torch.distributed.barrier(group=gloo)
    finally:
        torch.distributed.destroy_process_group()
    if args.rank == 0:
        bad = forbidden_modules()  # the ranks run the program: look in rank 0 too
        if bad:
            say(f"refused: modules of {', '.join(bad)} are loaded")
            return EXIT_FORBIDDEN
        print(json.dumps(result), flush=True)
    return 0


def launch_ranks(argv, chips: int, start: float, command=None, timeout=RANKS_TIMEOUT_S):
    """Start one rank a card and wait for every one; rank 0's last line of
    output, or None where any rank failed (then every rank is stopped)."""
    command = command or [sys.executable, str(Path(__file__).with_name("run.py"))]
    rdzv = tempfile.mkdtemp(prefix="portbench-rdzv-")
    init = f"file://{rdzv}/store"
    procs = []
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                [*command, *argv, "--rank", str(r), "--init-method", init, "--start", repr(start)],
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL, text=True))
        out = []
        reader = threading.Thread(target=lambda: out.append(procs[0].stdout.read()), daemon=True)
        reader.start()
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.2)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            say(f"ranks {failed} failed or did not end; stopping every rank")
            return None
        reader.join(timeout=30)
        lines = (out[0] if out else "").strip().splitlines()
        return lines[-1] if lines else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(rdzv, ignore_errors=True)


def main(argv, start: float) -> int:
    args = parse(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    chips = cell["chips"]
    if args.rank is not None:
        return _rank_main(spec, args)
    if not _card_count(chips):
        return EXIT_NO_CARD
    if chips == 1:
        result = run_cell(spec, args, start)
        return _finish(result, chips)
    from pointnet12_tpu_torch.kernels import build

    build.build()  # once, before the ranks start
    line = launch_ranks(argv, chips, start)
    if line is None:
        return EXIT_RANKS
    return _finish(json.loads(line), chips)
