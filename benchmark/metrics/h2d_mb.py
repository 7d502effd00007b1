"""h2d_mb (MB a batch, program counter): the bytes the schedule copies
to the card, counter h2d_bytes of the program's profiling (the host
schedule's arrays, or the device scheduler's scalars), over the traced
window's batches.  Nothing where the program keeps no such counter."""


def read(run):
    from pcd_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    n = counters().get("h2d_bytes") if counters else None
    return n / 1e6 / len(run.records) if n else None
