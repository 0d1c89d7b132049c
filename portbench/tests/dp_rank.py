"""One rank of a data-parallel cell on the CPU (gloo), at the sizes of
``small.py``, for the tests: ``python dp_rank.py <fault or -> <run.py's
arguments>``. Rank 0 prints the result line."""

import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.spec import Spec  # noqa: E402
from portbench.tests import small  # noqa: E402
from pointnet12_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def main(argv):
    fault, args = argv[0], harness.parse(argv[1:])
    spec = Spec()
    torch.set_num_threads(1)
    cfg, mix = small.cell(spec, args.workload)
    mesh = make_mesh("cpu", init_method=args.init_method, rank=args.rank,
                     world_size=spec.cell(args.workload)["chips"])
    planted = faults.no_exchange() if fault == "no_exchange" else contextlib.nullcontext()
    program = faults.PROGRAMS[fault]() if fault in faults.PROGRAMS else None
    try:
        with planted:
            result = harness.run_cell(spec, args, args.start, device="cpu", mesh=mesh,
                                      gloo=mesh.group, config=cfg, traffic=mix, program=program)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    if args.rank == 0:
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
