"""msm_mpoints_per_s (Mpoints/s, host clock): all the points of the
batches completed in the window, over the window's length."""


def read(run):
    return len(run.records) * run.gen.points() / run.window_s / 1e6
