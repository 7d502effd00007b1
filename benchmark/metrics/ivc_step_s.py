"""ivc_step_s (s, host clock): the window's length over the warm IVC steps
completed in it, each a main prove and a help prove."""


def read(run):
    return run.window_s / len(run.records)
