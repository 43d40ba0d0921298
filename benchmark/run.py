"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device (and with --trace 1 the breakdown), and
last the numbers the check compared, each with its limit.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
