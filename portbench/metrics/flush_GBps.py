"""The window's saves: all ``written_bytes`` over all ``flush_seconds``
(the engine's write and fsync), in 1e9 bytes a second."""

LAYER = "engines"


def read(run):
    saves = run["saves"]
    t = sum(s.flush_seconds for s in saves)
    if not saves or t <= 0:
        return None
    return sum(s.written_bytes for s in saves) / t / 1e9
