"""Mean seconds from building a fresh trainer to the end of the first
synchronised step after ``initial_state()``, over the window's resumes."""


def read(run):
    r = run["resumes"]
    if not r:
        return None
    return sum(e["resume_s"] for e in r) / len(r)
