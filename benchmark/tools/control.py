"""One run of a cell with the control judged in the program's place (see
PERF.md, "How correct is decided"): the same set-up and window, then the
check on the control's output, which has to come out not correct.

    python3 benchmark/tools/control.py --workload <cell> --seed <n> \
        --seconds <s> --trace 0

Chains: each sampled proof judged against msg + 1, a statement the chain
never proved.  MSMs: the reference's MSMs of the same scalars with their
top 12-bit window left out.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.getcwd()]

from benchlib import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], t_start=T_START, control=True))
