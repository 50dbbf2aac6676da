#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It prints the result as one JSON line, last on standard output (see
``portbench/harness.py``).
"""

import sys
from pathlib import Path

# the checkout's root, in place of this script's folder
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
