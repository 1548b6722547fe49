"""The restore's host-to-device copies (the ``h2d`` spans around the
pageable copy in ``WindowAssembler.feed``, summed into
``RestoreMetrics.h2d_seconds`` beside their ``h2d_bytes``), mean over the
window's resumes. A program without ``h2d_bytes`` timed the placement of
the windows instead, which is no copy: nothing is read there."""

LAYER = "checkpoint pipeline"


def read(run):
    r = [e["restore_metrics"] for e in run["resumes"]
         if e["restore_metrics"] is not None]
    if sum(getattr(m, "h2d_bytes", 0) for m in r) <= 0:
        return None            # no h2d span: the CPU, or an older program
    return sum(m.h2d_seconds for m in r) / len(r)
