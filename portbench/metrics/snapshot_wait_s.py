"""The part of the stall spent in ``wait_snapshotted()`` (the trainer's
``ckpt_snapshot_wait_seconds``), per save of the window."""

LAYER = "trainer"


def read(run):
    saves = run["saves"]
    if not saves:
        return None
    return run["snapshot_wait_s"] / len(saves)
