"""Median host wall of the window's steps, each ended by reading its
loss (the trainer's ``metrics_log`` "seconds", logged every step)."""

import statistics

LAYER = "model step"


def read(run):
    s = run["step_seconds"]
    if not s:
        return None
    return 1e3 * statistics.median(s)
