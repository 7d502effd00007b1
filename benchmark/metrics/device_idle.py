"""device_idle (%, device trace): the share of the traced window in which
no operation ran on the card, from the benchmark's torch.profiler
capture.  Nothing without a trace of the card.  Every metric named
device_idle.<cells> reads it (registry.metric)."""

from benchlib.trace import busy_s


def read(run):
    if not run.events or not run.events["device"]:
        return None
    return 100.0 * (1.0 - busy_s(run.events) / run.window_s)
