"""The CRC32 of the save's payloads as the stream stages them (the
aggregated engine's ``stage.crc`` spans, summed into
``SaveMetrics.stage_crc_seconds``), per save of the window."""

LAYER = "engines"


def read(run):
    saves = run["saves"]
    t = sum(getattr(s, "stage_crc_seconds", 0.0) for s in saves)
    if t <= 0:                 # no such span: an older program, or none
        return None
    return t / len(saves)
