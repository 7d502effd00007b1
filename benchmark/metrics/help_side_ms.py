"""help_side_ms (ms a batch, program span records): the help side of each
IVC step's commitment phase, from the first span record of its request
to the end of its last, over the traced window's batches that have one.
The generator keeps each help side's request (`help_requests`, traffic
kind step_msm); the records are the program's (`profiling.records()`).
Nothing where the generator keeps no such request or the program keeps
no records."""


def read(run):
    from pcd_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    rids = set(getattr(run.gen, "help_requests", ()))
    if records is None or not rids:
        return None
    span = {}
    for r in records():
        if r.request in rids and r.end_ns is not None:
            a, b = span.get(r.request, (r.start_ns, r.end_ns))
            span[r.request] = (min(a, r.start_ns), max(b, r.end_ns))
    if not span:
        return None
    return sum(b - a for a, b in span.values()) / 1e6 / len(span)
