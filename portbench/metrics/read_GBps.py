"""The window's restores: all ``read_bytes`` over all ``read_seconds``
(the read stage's wall), in 1e9 bytes a second."""

LAYER = "engines"


def read(run):
    r = [e["restore_metrics"] for e in run["resumes"]
         if e["restore_metrics"] is not None]
    t = sum(m.read_seconds for m in r)
    if not r or t <= 0:
        return None
    return sum(m.read_bytes for m in r) / t / 1e9
