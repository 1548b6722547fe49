"""The paper's baseline engines in the port (``datastates``, ``snapshot``,
``torchsave``) beside ``aggregated``: for the same state both packages write
the same files (data byte-identical, manifests equal but for
``_torch_port.VOLATILE_FIELDS``), each package restores the other's steps
to identical leaf bytes, and the engines' ``IOStats`` file and request
counts are the reference's."""

import pytest

from repro.core.engines import ENGINES as REF_ENGINES
from repro_torch.core.engines import ENGINES

from _torch_port import (QUANT, STRATEGIES, VOLATILE_FIELDS, dir_files,
                         leaves_bytes, normalize_manifest, np_state,
                         port_manager, ref_manager, to_jax, to_port)

STEP_DIR = "step_00000003"
BASELINES = ("datastates", "snapshot", "torchsave")
# (engine, strategy): the baselines fix their own layout, so the strategy
# is the aggregated engine's axis only
CASES = [("aggregated", s) for s in STRATEGIES] + \
        [(e, "single_file") for e in BASELINES]


def _ids(case):
    return "-".join(case)


def _save_both(tmp_path, engine, strategy, quantize):
    """Save one state through both packages; returns the engines' save
    stats (reference, port) and the manager keywords."""
    kw = dict(engine=engine, quantize_prefixes=QUANT if quantize else (),
              quantize_min_bytes=1024)
    tree = np_state(0)
    with ref_manager(tmp_path / "ref", strategy, **kw) as r:
        r.save(3, to_jax(tree))
        ref_stats = r.engine.last_save_stats
    with port_manager(tmp_path / "port", strategy, **kw) as p:
        p.save(3, to_port(tree))
        port_stats = p.engine.last_save_stats
    return (ref_stats, port_stats), kw


def test_every_engine_is_registered():
    assert sorted(ENGINES) == sorted(REF_ENGINES) == [
        "aggregated", "datastates", "snapshot", "torchsave"]
    assert "remote" not in ENGINES


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_both_packages_write_identical_steps(tmp_path, case, quantize):
    _save_both(tmp_path, *case, quantize)
    fa = dir_files(str(tmp_path / "ref" / STEP_DIR))
    fb = dir_files(str(tmp_path / "port" / STEP_DIR))
    ma, mb = fa.pop("manifest.json"), fb.pop("manifest.json")
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    assert normalize_manifest(ma) == normalize_manifest(mb), VOLATILE_FIELDS


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_cross_package_restore(tmp_path, engine, direction, quantize):
    """A step written by one package restores through the other (on the
    same engine) to the bytes its own package restores."""
    _stats, kw = _save_both(tmp_path, engine, "single_file", quantize)
    writer = "port" if direction == "port_to_ref" else "ref"
    with ref_manager(tmp_path / writer, **kw) as r:
        by_ref = leaves_bytes(r.restore(step=3))
    with port_manager(tmp_path / writer, **kw) as p:
        by_port = leaves_bytes(p.restore(step=3))
    assert by_port == by_ref
    if not quantize:      # the saved state itself, bit for bit
        assert by_port == leaves_bytes(np_state(0))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_io_stats_match_the_reference(tmp_path, case):
    """Files and I/O requests of the save and of the restore (the paper's
    Fig 18 counts) are the reference engine's for the same state."""
    (ref_save, port_save), kw = _save_both(tmp_path, *case, True)
    assert (port_save.files, port_save.io_requests, port_save.logical_bytes) \
        == (ref_save.files, ref_save.io_requests, ref_save.logical_bytes)
    assert port_save.files > 0 and port_save.io_requests > 0
    with ref_manager(tmp_path / "ref", case[1], **kw) as r:
        r.restore(step=3)
        ref_read = r.engine.last_restore_stats
    with port_manager(tmp_path / "port", case[1], **kw) as p:
        p.restore(step=3)
        port_read = p.engine.last_restore_stats
    assert (port_read.files, port_read.io_requests) == \
        (ref_read.files, ref_read.io_requests)
