"""Mean of the trainer's ``restore_attr["restore_seconds"]`` (the restore
call, synchronised) over the window's resumes."""

LAYER = "trainer"


def read(run):
    r = run["resumes"]
    if not r:
        return None
    return sum(e["restore_seconds"] for e in r) / len(r)
