"""100 x (1 - the union of the device's operations / the stretch) over
the profiled stretch of the traced resume window: the middle resume,
its fresh trainer, restore and steps (``devtrace``)."""

LAYER = "device"


def read(run):
    d = run.get("devtrace")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
