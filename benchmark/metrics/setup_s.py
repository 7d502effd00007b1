"""setup_s (s, host clock): from the process's start to the first timed
request: imports, the kernels' build on a checkout's first run, the keys
or tables made from the seed, and the warm-up."""


def read(run):
    return run.setup_s
