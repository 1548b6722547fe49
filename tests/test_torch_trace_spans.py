"""The port's spans where the checkpoint stall and the read stall happen,
on the CPU: the trainer's step, batch, save and post-save wait; the save
stream's staging memcpy and CRC; the restore stream's landing memcpy and
CRC inside the pipeline's ``read.stall``; and no ``h2d`` on a CPU restore.
The device-tier ``train.step`` and the card's ``h2d`` are held on the
card (``tests/test_torch_cuda.py``)."""

import collections

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import CheckpointManager, EngineConfig, trace
from repro_torch.data import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

RUN_KEYS = {"state", "wall_seconds", "ckpt_blocking_seconds",
            "ckpt_blocking_reported_s", "ckpt_snapshot_wait_seconds",
            "start_step", "metrics"}


@pytest.fixture
def tracer():
    tr = trace.enable()
    yield tr
    trace.disable()


def _spans(name=None):
    return [e for e in trace.drain()
            if e.kind == "span" and (name is None or e.name == name)]


def _engine(checksum=True):
    # 64 KiB chunks: the 256 KiB leaf streams in chunks, the rest coalesce
    return EngineConfig(backend="posix", direct=False, checksum=checksum,
                        chunk_bytes=64 << 10)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 1024, generator=g),
            "b": torch.randn(300, generator=g).to(torch.bfloat16),
            "s": torch.randn(7, generator=g),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _trainer(tmp_path, steps):
    cfg = get_config("qwen2.5-3b").scaled_down(
        layers=1, width_div=32, vocab=256).replace(dtype="float32")
    return Trainer(cfg, TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path), async_ckpt=True,
        log_every=1), data_cfg=DataConfig(cfg.vocab_size, 32, 2, seed=0),
        engine_config=_engine(), device="cpu")


def test_trainer_spans_each_step_and_the_wait_after_each_save(tmp_path,
                                                              tracer):
    t = _trainer(tmp_path, 5)
    try:
        out = t.run()
    finally:
        t.close()
    assert set(out) == RUN_KEYS | {"stall_report", "stall_wall_seconds"}
    by = collections.defaultdict(list)
    for e in _spans():
        if e.name.startswith("train."):
            assert e.tier == "host"          # no device spans on the CPU
            by[e.name].append(e.attrs["step"])
    assert by["train.step"] == by["train.batch"] == [0, 1, 2, 3, 4]
    assert by["train.save"] == [1, 3]        # saves of steps 2 and 4
    assert by["train.snapshot_wait"] == [2, 4]
    steps = {e.attrs["step"]: e for e in _spans("train.step")}
    for e in _spans("train.snapshot_wait"):  # before its step, not in it
        assert e.t1 <= steps[e.attrs["step"]].t0
    assert len(t.save_log) == 2
    for sm in t.save_log:
        assert sm.stage_copy_seconds > 0 and sm.stage_crc_seconds > 0


def test_trainer_with_the_tracer_off_records_nothing(tmp_path):
    assert not trace.is_enabled()
    t = _trainer(tmp_path, 3)
    try:
        out = t.run()
    finally:
        t.close()
    assert set(out) == RUN_KEYS
    assert trace.drain() == [] and not trace.is_enabled()
    assert not hasattr(t, "registry")


@pytest.mark.parametrize("checksum", [True, False], ids=["crc", "no_crc"])
def test_save_stages_its_bytes_under_copy_and_crc_spans(tmp_path, tracer,
                                                        checksum):
    with CheckpointManager(str(tmp_path), config=_engine(checksum),
                           device="cpu", verify_crc=checksum) as m:
        sm = m.save(1, _state())
    copies, crcs = _spans("stage.copy"), _spans("stage.crc")
    assert sum(e.nbytes for e in copies) == sm.total_bytes
    assert sm.stage_copy_seconds == pytest.approx(
        sum(e.dur for e in copies), rel=1e-9, abs=1e-12)
    assert len(copies) > 4                   # chunks of the 256 KiB leaf
    if checksum:
        assert sum(e.nbytes for e in crcs) == sm.total_bytes
        assert sm.stage_crc_seconds == pytest.approx(
            sum(e.dur for e in crcs), rel=1e-9, abs=1e-12)
    else:
        assert crcs == [] and sm.stage_crc_seconds == 0.0
    (save,) = _spans("save")
    for e in copies + crcs:                  # on the save's thread, inside
        assert e.thread == save.thread and save.t0 <= e.t0 <= e.t1 <= save.t1


def test_restore_copies_and_crcs_lie_inside_read_stalls(tmp_path):
    state = _state(3)
    with CheckpointManager(str(tmp_path), config=_engine(),
                           device="cpu") as m:
        m.save(1, state)
    trace.enable()
    try:
        with CheckpointManager(str(tmp_path), config=_engine(),
                               device="cpu") as m:
            got = m.restore(step=1)
            rm = m.last_restore_metrics
        spans = _spans()
    finally:
        trace.disable()
    assert all(torch.equal(got[k], state[k]) for k in state)
    stalls = [e for e in spans if e.name == "read.stall"]
    assert stalls and rm.read_bytes > 0

    def inside(e):
        return any(s.thread == e.thread and s.t0 <= e.t0 <= e.t1 <= s.t1
                   for s in stalls)
    for name, seconds in (("read.copy", rm.read_copy_seconds),
                          ("read.crc", rm.read_crc_seconds)):
        mine = [e for e in spans if e.name == name and inside(e)]
        assert sum(e.nbytes for e in mine) == rm.read_bytes, name
        assert seconds == pytest.approx(sum(e.dur for e in mine),
                                        rel=1e-9, abs=1e-12)
    # outside every read.stall: the lean blob's one read, before the stream
    outside = [e for e in spans
               if e.name in ("read.copy", "read.crc") and not inside(e)]
    assert [e.name for e in outside] == ["read.copy"]
    assert not [e for e in spans if e.name == "h2d"]
    assert rm.h2d_bytes == 0 and rm.h2d_seconds == 0.0
