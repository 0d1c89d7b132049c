"""The readings the cells' limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [--control <n>]
        [--faults half_batch,...] [--fault-seeds <n>] [--first-seed <s>]

For ``--seeds`` seeds from ``--first-seed`` it runs the cell's loop as a
run does (its set-up and checked steps, a short window at the cell's own
load, the check) and keeps the program's compared numbers; for the first
``--control`` of them, the control's numbers (the reference in TF32 in the
program's place, ``check.py``); for the first ``--fault-seeds``, each
fault of ``--faults`` (``faults.py``) planted in the program. All in one
process (one a card, for a cell of several cards). Prints one JSON object
of every reading, the lower reading (the largest of the program's), and
the upper (the smallest of the control's and of each fault's) of each
number.
"""

import argparse
import contextlib
import json
import random
import sys
import time
from pathlib import Path

START = time.time()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, faults, harness, loops  # noqa: E402
from portbench.data import make_pool  # noqa: E402
from portbench.seeds import streams  # noqa: E402
from portbench.spec import Spec  # noqa: E402

WINDOW_S = 1.0


def control(cfg, mix, seed, device, ranks) -> dict:
    s = streams(seed)
    if mix["loop"] == "train":
        pool = make_pool(cfg, cfg["data"]["pool"], s["data"])
        return check.train_control(cfg, s, pool, cfg["batch"] * ranks, device)
    requests = loops.serve_requests(cfg, mix, s)
    picked = random.Random(s["sample"]).sample(range(len(requests)), mix["sample"])
    return check.serve_control(cfg, s, [requests[r] for r in picked], device)


def readings(spec, workload, seeds, n_control, fault_names, n_fault, device, mesh=None,
             gloo=None) -> dict:
    """Every reading of the cell, on this rank (rank 0's are kept)."""
    import torch

    cell = spec.cell(workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    env = loops.Env(device, time.time(), mesh, gloo)
    loop = loops.LOOPS[mix["loop"]]
    out = {"program": {}, "control": {}, "faults": {}}

    def one(seed, program=None):
        env.start, env.marks = time.time(), []
        ctx = loop(env, cfg, mix, seed, WINDOW_S, False, {}, program)
        ctx.checks.pop("_where", None)
        return ctx.checks

    for seed in seeds:
        out["program"][seed] = one(seed)
    for name in fault_names:
        out["faults"][name] = {}
        for seed in seeds[:n_fault]:
            planted = faults.no_exchange() if name == "no_exchange" else contextlib.nullcontext()
            with planted:
                out["faults"][name][seed] = one(seed, faults.PROGRAMS.get(name, lambda: None)())
    if env.lead:
        ranks = 1 if mesh is None else mesh.size
        for seed in seeds[:n_control]:
            out["control"][seed] = control(cfg, mix, seed, env.device, ranks)
    return out


def summary(out: dict) -> dict:
    """The lower reading (the program's largest) and the upper ones (the
    control's smallest, each fault's smallest) of every number."""
    numbers = sorted({k for r in out["program"].values() for k in r})
    res = {}
    for k in numbers:
        res[k] = {"lower": max(r[k] for r in out["program"].values())}
        if out["control"]:
            res[k]["control"] = min(r[k] for r in out["control"].values())
        for name, runs in out["faults"].items():
            if runs:
                res[k][name] = min(r[k] for r in runs.values())
    return res


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--init-method", default=None)
    p.add_argument("--start", type=float, default=None)
    args = p.parse_args(argv)
    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    names = [f for f in args.faults.split(",") if f]
    if chips > 1 and args.rank is None:
        from pointnet12_tpu_torch.kernels import build

        build.build()
        line = harness.launch_ranks(argv, chips, START, timeout=3000,
                                    command=[sys.executable, str(Path(__file__).resolve())])
        if line is None:
            return harness.EXIT_RANKS
        print(line, flush=True)
        return 0
    mesh = gloo = None
    device = "cuda:0"
    if args.rank is not None:
        import torch

        from pointnet12_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(f"cuda:{args.rank}", init_method=args.init_method, rank=args.rank,
                         world_size=chips)
        gloo = torch.distributed.new_group(backend="gloo")
        device = f"cuda:{args.rank}"
    out = readings(spec, args.workload, seeds, args.control, names, args.fault_seeds, device,
                   mesh, gloo)
    if mesh is not None:
        import torch

        torch.distributed.barrier(group=gloo)
        torch.distributed.destroy_process_group()
    if args.rank in (None, 0):
        out["summary"] = summary(out)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
