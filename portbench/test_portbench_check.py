"""The check that decides ``correct``, driven through a whole run of a
CPU-sized cell (the look for a card skipped): sound runs pass, and each
fault a one-card training cell can have, planted in the program's timed
path, turns ``correct`` false; so does the control."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import bench
from portbench.tiny import tiny_tree

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the tiny steps are far slower on many where the
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(tmp_path, kind, seed=2 ** 31 + 11, trace_metrics=False):
    spec = tiny_tree(tmp_path, kind)
    spec["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in SPEC["end_to_end"]]
    return bench.run_cell(spec, "c", seed, 0.5, False, time.perf_counter(),
                          log=lambda *a: None, device="cpu", base=tmp_path,
                          root=tmp_path)


def broken_step(monkeypatch, fault):
    """The trainer's step factory with ``fault`` planted underneath."""
    import repro_torch.train.trainer as trainer_mod
    real = trainer_mod.make_train_step

    def factory(*a, **k):
        step = real(*a, **k)

        def fn(state, batch):
            if fault == "unchanged":
                copy = _clone(state)
                _, metrics = step(copy, batch)
                return state, metrics
            if fault == "half_batch":
                n = next(iter(batch.values())).shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            keep = state["params"]["head"].clone()
            out = step(state, batch)
            state["params"]["head"].copy_(keep)
            return out
        return fn
    monkeypatch.setattr(trainer_mod, "make_train_step", factory)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("kind", ["save", "train", "resume"])
def test_sound_runs_are_correct(tmp_path, kind):
    out = run(tmp_path, kind)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    assert {"train_tokens_per_s", "train_mfu_pct", "setup_s"} \
        <= set(out["metrics"])
    if kind == "save":
        assert out["checks"]["saved_leaves_differing"]["value"] == 0
    if kind == "resume":
        assert "resume_s" in out["metrics"] and out["attempted"] >= 1
    assert not (tmp_path / ".portbench_run").exists()


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "leaf_unmoved"])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    broken_step(monkeypatch, fault)
    out = run(tmp_path, "train" if fault == "half_batch" else "save")
    assert not out["correct"], out["checks"]


def test_altered_checkpoint_bytes_are_not_correct(tmp_path, monkeypatch):
    import repro_torch.core.checkpoint as ck
    real = ck.extract_tensors

    def altered(state):
        tensors, lean = real(state)
        key = next(k for k in tensors if k.endswith("params/head"))
        tensors[key] = tensors[key] + 1
        return tensors, lean
    monkeypatch.setattr(ck, "extract_tensors", altered)
    out = run(tmp_path, "save")
    assert not out["correct"]
    assert out["checks"]["saved_leaves_differing"]["value"] > 0


def test_an_altered_restore_is_not_correct(tmp_path, monkeypatch):
    import repro_torch.core.checkpoint as ck
    real = ck.CheckpointManager.restore

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        out["train"]["params"]["head"].add_(1)
        return out
    monkeypatch.setattr(ck.CheckpointManager, "restore", altered)
    out = run(tmp_path, "resume")
    assert not out["correct"]
    assert out["checks"]["restored_leaves_differing"]["value"] > 0
    assert out["failed"] == out["attempted"]


@pytest.mark.parametrize("seed", [77, 2 ** 31 + 5])
def test_the_control_is_not_correct(tmp_path, seed):
    """The reference in the program's place, its matmuls in TF32."""
    from repro_torch.train.steps import init_train_state
    spec = tiny_tree(tmp_path, "train")
    r = bench.Run(spec, "c", seed, 0.0, False, 0.0, "cpu", tmp_path,
                  tmp_path)
    r.layout = init_train_state(bench.model_config(r.m), device="meta")
    nums = r.compare(r.reference(), r.reference(precision="tf32"))
    limits = r.work["limits"]
    assert any(nums[k] > limits[k] for k in nums), nums
    torch.set_float32_matmul_precision("highest")
