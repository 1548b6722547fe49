"""Mean ``SaveMetrics.end_to_end_seconds`` of the window's saves: from the
save call to its commit."""

LAYER = "checkpoint pipeline"


def read(run):
    saves = run["saves"]
    if not saves:
        return None
    return sum(s.end_to_end_seconds for s in saves) / len(saves)
