"""Seconds from the process's start to the window's: imports, the
card's start, the state made from the seed, the first steps, the warm
steps and the warm save or resume."""


def read(run):
    return run["setup_s"]
