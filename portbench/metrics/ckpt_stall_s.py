"""The checkpoint stall the training loop saw in the window (the
trainer's ``ckpt_blocking_seconds``: each save's blocking call and every
``wait_snapshotted()`` before a step), per save of the window."""

LAYER = "trainer"


def read(run):
    saves = run["saves"]
    if not saves:
        return None
    return run["ckpt_blocking_s"] / len(saves)
