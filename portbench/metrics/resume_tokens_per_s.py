"""Tokens trained in the resume window over its whole wall: every fresh
trainer, restore and step of the window's resumes inside it."""


def read(run):
    return run["tokens"] / run["window_s"]
