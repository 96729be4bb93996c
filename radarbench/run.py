"""Run one cell of the radar odometry benchmark once, from the root of a
checkout:

    python3 radarbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); each compared
number and its limit are the last lines of standard error. See
`radarbench/README.md`.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if sys.path[1:2] == [os.path.dirname(os.path.abspath(__file__))]:
        del sys.path[1]            # the script's own folder: no top-level shadows
    from radarbench.harness import main

    raise SystemExit(main(sys.argv[1:], T_START))
