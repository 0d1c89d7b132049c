"""The benchmark's command; see ``harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

START = time.time()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one thread for numpy's and torch's host maths: the host paces these
# cells, and pools of threads spinning beside the launching thread make
# runs spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
