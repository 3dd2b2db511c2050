"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout; see ``portbench/harness.py``.
"""
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    # the checkout's root, in place of this folder: its modules are
    # imported as ``portbench.*`` and shadow nothing of the library
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench.harness import main

    sys.exit(main(t0=T0))
