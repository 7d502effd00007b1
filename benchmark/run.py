"""Run one cell of the port's benchmark once (see benchlib/cli.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.getcwd())          # the checkout: pcd_tpu_torch

from benchlib import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], t_start=T_START))
