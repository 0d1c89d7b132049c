"""A rehearsal of every cell on the CPU at the sizes of ``small.py``,
through the plain path, each printed as a run prints it; then the names of
the forbidden modules loaded (JAX's, Flax's, the JAX package's), as a
JSON list, on the last line. ``python rehearse.py [cell ...]``."""

import contextlib
import io
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402
from portbench.spec import Spec  # noqa: E402
from portbench.tests import small  # noqa: E402

RANK = Path(__file__).with_name("dp_rank.py")


def run(spec, name, seed, trace, fault="-", seconds=1.0):
    """The result line of one CPU run of cell ``name`` (None where a rank
    of a data-parallel cell failed), with the fault ``fault`` planted."""
    from portbench import faults

    argv = ["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    chips = spec.cell(name)["chips"]
    if chips > 1:
        line = harness.launch_ranks(argv, chips, time.time(), timeout=900,
                                    command=[sys.executable, str(RANK), fault])
        return None if line is None else json.loads(line)
    cfg, mix = small.cell(spec, name)
    program = faults.PROGRAMS[fault]() if fault in faults.PROGRAMS else None
    return harness.run_cell(spec, harness.parse(argv), time.time(), device="cpu", config=cfg,
                            traffic=mix, program=program)


def main(names):
    spec = Spec()
    for i, name in enumerate(names or [c["name"] for c in spec.bench["workloads"]]):
        result = run(spec, name, 2 ** 31 + 97 * i, trace=i % 2)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            harness._finish(result, spec.cell(name)["chips"])
        print(json.dumps({"cell": name, "printed": out.getvalue().splitlines()}), flush=True)
    print(json.dumps(harness.forbidden_modules()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
