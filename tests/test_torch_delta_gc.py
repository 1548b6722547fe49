"""The port's store GC against an in-flight async delta save.

The twin of ``tests/test_delta.py::test_gc_never_reaps_chunks_referenced_by_inflight_save``
(a GC hammering the store while three async delta saves run), and the
interleaving that breaks it, made deterministic with two delay hooks: the
save has published its pack (the files are in the chunk store, the
rewritten manifest in its pidfile-owned ``.tmp-`` dir) and is about to
rename that dir to ``step_N``; a GC pass starts there, so the new pack is
among its candidates, lists the root while the ``.tmp-`` dir still stands,
and is held at the dir's liveness check until the rename has landed. The
dir it looks at is gone, and ``step_N``, which now holds the references,
was never listed. A pass that took the vanished dir as dead would count no
reference to the new pack and delete it, and the restore of step N would
find a pack file missing; the scan instead reports the listing stale and
rescans.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointManager, EngineConfig
from repro_torch.core import checkpoint as ckpt_mod
from repro_torch.core import delta as delta_mod
from repro_torch.core import faults

CHUNK = 16 << 10   # small grid so small test tensors span many chunks
WAIT_S = 30


def _state(seed: int, n: int = 2, rows: int = 2048, cols: int = 128):
    rng = np.random.default_rng(seed)
    return {"params": {f"w{i}": torch.from_numpy(
        rng.standard_normal((rows, cols)).astype(np.float32))
        for i in range(n)}, "step": 0}


def _manager(path, **kw) -> CheckpointManager:
    return CheckpointManager(str(path), config=EngineConfig(
        backend="posix", direct=False), device="cpu", delta=True,
        delta_chunk_bytes=CHUNK, **kw)


def _assert_equal(tree, state):
    for k, v in state["params"].items():
        assert torch.equal(tree["params"][k], v), k


def _pack_files(root) -> list[str]:
    store = os.path.join(str(root), delta_mod.CHUNKSTORE_DIR)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(store)
                  for f in fs)


def test_gc_never_reaps_chunks_referenced_by_inflight_save(tmp_path):
    """The reference's case on the port: a refcount GC pass racing
    in-flight async delta saves deletes no chunk a kept (or about to
    commit) step references — restores stay bit-exact."""
    state = _state(0)
    with _manager(tmp_path, keep=2, async_save=True) as mgr:
        mgr.delta_gc_grace_s = 0.0
        mgr.save(0, state)
        mgr.wait()
        stop = threading.Event()
        errs: list = []

        def hammer():
            while not stop.is_set():
                try:
                    delta_mod.gc_store(str(tmp_path), grace_s=0.0)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
                time.sleep(0.001)

        th = threading.Thread(target=hammer)
        th.start()
        try:
            for s in range(1, 4):
                state["params"]["w1"][s:s + 2] += 1.0
                mgr.save(s, state)
                mgr.wait()
        finally:
            stop.set()
            th.join()
        assert not errs
        _assert_equal(mgr.restore(step=3), state)
        mgr.restore(step=2)


@pytest.mark.parametrize("async_save", [True, False],
                         ids=["async", "sync"])
def test_gc_pass_that_listed_a_save_before_its_commit_keeps_its_pack(
        tmp_path, monkeypatch, async_save):
    """The deterministic interleaving (module docstring): the GC pass that
    runs while step 3's commit rename is held keeps step 3's fresh pack,
    and step 3 and the kept step 2 restore bit-exactly."""
    state = _state(1)
    final = os.path.join(str(tmp_path), ckpt_mod.step_dir_name(3))
    at_check, committed = threading.Event(), threading.Event()
    gc_out: dict = {}
    real_replace, real_live = faults.replace, ckpt_mod.tmp_in_flight

    def held_liveness_check(path):
        if path.startswith(final + ".tmp-") and not committed.is_set():
            at_check.set()                  # listed before the commit ...
            assert committed.wait(WAIT_S)   # ... checked after it
        return real_live(path)

    def gc_pass():
        try:
            gc_out["before"] = _pack_files(tmp_path)
            gc_out["stats"] = delta_mod.gc_store(str(tmp_path), grace_s=0.0)
        except BaseException as e:  # noqa: BLE001
            gc_out["error"] = e
            at_check.set()

    def held_commit(src, dst, *a, **kw):
        if dst != final or ".tmp-" not in src or committed.is_set():
            return real_replace(src, dst, *a, **kw)
        th = threading.Thread(target=gc_pass)
        th.start()
        assert at_check.wait(WAIT_S)
        try:
            return real_replace(src, dst, *a, **kw)
        finally:
            committed.set()
            th.join(WAIT_S)

    monkeypatch.setattr(ckpt_mod, "tmp_in_flight", held_liveness_check)
    with _manager(tmp_path, keep=2, async_save=async_save) as mgr:
        mgr.delta_gc_grace_s = 0.0
        for s in range(3):
            state["params"]["w1"][s:s + 2] += 1.0
            mgr.save(s, state)
            mgr.wait()
        kept = {k: v.clone() for k, v in state["params"].items()}
        monkeypatch.setattr(faults, "replace", held_commit)
        state["params"]["w1"][3:5] += 1.0
        mgr.save(3, state)
        mgr.wait()
        monkeypatch.setattr(faults, "replace", real_replace)
        assert committed.is_set() and "error" not in gc_out, gc_out
        pack = os.path.join(delta_mod.PACK_SUBDIR,
                            ckpt_mod.step_dir_name(3) + "-")
        fresh = [p for p in gc_out["before"] if pack in p]
        assert fresh, gc_out["before"]      # the pack was a candidate
        assert all(os.path.exists(p) for p in fresh)
        assert gc_out["stats"].deleted == 0
        _assert_equal(mgr.restore(step=3), state)
        _assert_equal(mgr.restore(step=2), {"params": kept})
