"""Run one benchmark cell once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks for.
See ``harness/main.py``.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.append(os.path.dirname(here))  # the program, at the root
    from harness.core import set_cache_dirs

    set_cache_dirs()
    from harness.main import main

    sys.exit(main(sys.argv[1:], T_PROCESS))
