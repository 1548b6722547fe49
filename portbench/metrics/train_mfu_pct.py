"""Model FLOPs of the window's steps (``flops.train_step_flops``, no
recomputation) over the window's wall times the card's dense bf16 peak."""


def read(run):
    return 100.0 * run["flops"] / (run["window_s"] * run["peak_flops"])
