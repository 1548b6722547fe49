"""Mean ``RestoreMetrics.read_stall_seconds`` over the window's resumes:
the time the restore waited for extents."""

LAYER = "checkpoint pipeline"


def read(run):
    r = [e["restore_metrics"] for e in run["resumes"]
         if e["restore_metrics"] is not None]
    if not r:
        return None
    return sum(m.read_stall_seconds for m in r) / len(r)
