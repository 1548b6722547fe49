"""The readers of the save's and the restore's span metrics on hand-made
run contexts: the expected value where the program summed its spans into
``SaveMetrics`` / ``RestoreMetrics``, and None where a cell has no such
span (checksums off, a CPU restore) or the program has no such field."""

from types import SimpleNamespace

import pytest

from portbench import bench

SAVE = {"snapshot_crc_s": "stage_crc_seconds",
        "snapshot_copy_s": "stage_copy_seconds"}
RESTORE = {"restore_crc_s": "read_crc_seconds",
           "restore_copy_s": "read_copy_seconds",
           "restore_h2d_s": "h2d_seconds"}


def _resumes(**fields):
    """Two resumes and one whose trainer found no checkpoint."""
    ms = [SimpleNamespace(read_stall_seconds=1.0, **{
        k: v[i] for k, v in fields.items()}) for i in range(2)]
    return [{"restore_metrics": m} for m in ms] + [{"restore_metrics": None}]


@pytest.mark.parametrize("name", sorted(SAVE))
def test_save_readers(name):
    read = bench.load_reader(name)
    saves = [SimpleNamespace(**{SAVE[name]: v}) for v in (0.25, 0.75, 0.5)]
    assert read({"saves": saves}) == pytest.approx(0.5)
    zero = [SimpleNamespace(**{SAVE[name]: 0.0})] * 2
    assert read({"saves": zero}) is None            # no span recorded
    older = [SimpleNamespace(end_to_end_seconds=1.0)] * 2
    assert read({"saves": older}) is None           # no such field
    assert read({"saves": []}) is None


@pytest.mark.parametrize("name", sorted(RESTORE))
def test_restore_readers(name):
    read = bench.load_reader(name)
    field = RESTORE[name]
    run = {"resumes": _resumes(**{field: (0.25, 0.75)},
                               h2d_bytes=(100, 100))}
    assert read(run) == pytest.approx(0.5)
    none = {"resumes": _resumes(**{field: (0.0, 0.0)}, h2d_bytes=(0, 0))}
    assert read(none) is None                       # no span recorded
    assert read({"resumes": _resumes(read_seconds=(1.0, 1.0))}) is None
    assert read({"resumes": []}) is None


def test_the_parents_h2d_seconds_alone_reads_nothing():
    """A program whose ``h2d_seconds`` timed the windows' placement, with
    no ``h2d_bytes``, reports no ``restore_h2d_s``."""
    run = {"resumes": _resumes(h2d_seconds=(1e-5, 2e-5))}
    assert bench.load_reader("restore_h2d_s")(run) is None
