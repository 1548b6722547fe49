"""The save's memcpy into the pooled aligned buffers (the aggregated
engine's ``stage.copy`` spans, summed into
``SaveMetrics.stage_copy_seconds``), per save of the window."""

LAYER = "engines"


def read(run):
    saves = run["saves"]
    t = sum(getattr(s, "stage_copy_seconds", 0.0) for s in saves)
    if t <= 0:                 # no such span: an older program, or none
        return None
    return t / len(saves)
