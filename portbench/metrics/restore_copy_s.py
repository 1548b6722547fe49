"""The memcpy of the landed extents out of the read buffers on the
restore's consumer thread (the aggregated engine's ``read.copy`` spans
inside ``read.stall``, summed into ``RestoreMetrics.read_copy_seconds``),
mean over the window's resumes."""

LAYER = "engines"


def read(run):
    r = [e["restore_metrics"] for e in run["resumes"]
         if e["restore_metrics"] is not None]
    t = sum(getattr(m, "read_copy_seconds", 0.0) for m in r)
    if t <= 0:                 # no such span: an older program, or none
        return None
    return t / len(r)
