"""Tokens trained in the window over its whole wall (saves, stalls,
resumes and the last save's drain inside it)."""


def read(run):
    return run["tokens"] / run["window_s"]
