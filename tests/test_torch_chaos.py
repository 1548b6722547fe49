"""The port's seeded chaos campaign on the CPU (the cases of
``tests/chaos/test_chaos.py``'s campaign section): every cell runs with
zero invariant violations, and a trial's schedule is a function of
``(seed, trial, cell)`` alone. Restores land on the CPU here; on the card
``chip_smoke.py`` runs the gate seeds with ``device="cuda"``."""

from repro_torch.core import chaos


def test_campaign_smoke_all_cells():
    stats = chaos.run_campaign(1234, min_faults=36, device="cpu")
    assert stats.faults >= 36
    assert set(stats.by_cell) == set(chaos.CELLS)


def test_campaign_is_deterministic_per_trial(tmp_path):
    a = chaos.run_campaign(9, min_faults=6, max_trials=6,
                           base_dir=str(tmp_path / "a"), device="cpu")
    b = chaos.run_campaign(9, min_faults=6, max_trials=6,
                           base_dir=str(tmp_path / "b"), device="cpu")
    assert a.by_kind == b.by_kind and a.trials == b.trials


def test_cells_and_schedule_are_the_references():
    """Same cells, and the same fault drawn for the same trial RNG."""
    import random
    from repro.core import chaos as ref
    assert chaos.CELLS == ref.CELLS
    for i, cell in enumerate(chaos.CELLS):
        key = f"0:{i}:{cell}"
        for restore in (False, True):
            assert chaos._pick_fault(random.Random(key), restore).describe() \
                == ref._pick_fault(random.Random(key), restore).describe()
        assert chaos._pick_gather_fault(random.Random(key)).describe() == \
            ref._pick_gather_fault(random.Random(key)).describe()
