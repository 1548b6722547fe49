"""The port's multi-writer checkpointing against the JAX package: N
concurrent rank writers, the two-phase rank-0 merge commit, the crash
window, tmp-GC ownership and N→M elastic restore (the cases of
``tests/test_multiwriter.py``), plus what the port adds — the snapshot
barrier over in-place mutation, the CheckpointManager hooks, and byte
identity with the reference's 4-writer saves (data files whole; manifests
apart from ``VOLATILE_FIELDS``) with restores both ways, full and delta.

Tolerance: bit-exact everywhere (quantized leaves: equal to the
reference's decode of the same save).
"""

import copy
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import MultiWriterCheckpointer as RefMW
from repro_torch.core import (CheckpointManager, CommitCoordinator,
                              EngineConfig, InProcessGroup, LocalShard,
                              Manifest, MultiWriterAborted,
                              MultiWriterCheckpointer, shard_state)
from repro_torch.core.checkpoint import (OWNER_NAME, step_dir_name,
                                         tmp_in_flight, write_owner)

from _torch_port import (QUANT, dir_files, leaves_bytes, normalize_manifest,
                         np_state, ref_config, port_config, to_jax, to_port)


def _state(seed=0, rows=16, cols=32):
    rng = np.random.default_rng(seed)
    tree = {"params": {"w": rng.standard_normal((rows, cols))
                       .astype(np.float32),
                       "b": rng.standard_normal((3,)).astype(np.float32)},
            "step": seed, "note": f"lean-{seed}"}
    return tree, to_port(tree)


def _mw(path, n, strategy="single_file", **kw):
    return MultiWriterCheckpointer(str(path), n, config=port_config(strategy),
                                   device="cpu", **kw)


def _ref_mw(path, n, strategy="single_file", **kw):
    return RefMW(str(path), n, config=ref_config(strategy), **kw)


def _reassemble(trees, key, like):
    out = np.zeros_like(like)
    for tree in trees:
        leaf = tree["params"][key]
        if isinstance(leaf, LocalShard):
            lo, hi = leaf.index[0]
            out[lo:hi] = leaf.data.numpy()
        else:
            out[:] = leaf.numpy()
    return out


def _windows(trees) -> dict:
    """path -> {window: bytes} over every reader's leaves (either
    package's ``restore_sharded`` result)."""
    out: dict = {}
    for tree in trees:
        flat = {}
        for k, v in _leaves(tree):
            if isinstance(v, LocalShard) or type(v).__name__ == "LocalShard":
                w, data = tuple(map(tuple, v.index)), v.data
            else:
                w, data = None, v
            flat[k] = (w, data)
        for k, (w, data) in flat.items():
            b = leaves_bytes({"x": data})["['x']"]
            out.setdefault(k, {})[w] = b
    return out


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------ group shim
def test_allgather_rounds():
    group = InProcessGroup(4)
    results = [None] * 4

    def run(r):
        a = group.allgather(r * 10, r, 4)
        b = group.allgather(r + 100, r)
        results[r] = (a, b)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for r in range(4):
        assert results[r] == ([0, 10, 20, 30], [100, 101, 102, 103])


def test_allgather_rejects_wrong_world_size():
    group = InProcessGroup(1)
    with pytest.raises(ValueError):
        group.allgather(1, 0, 8)


# ----------------------------------------------------- manager hooks
def test_allgather_hook_carries_the_prefix_sum(tmp_path):
    """``CheckpointManager.allgather`` replaces the torch.distributed
    exchange of the SINGLE_FILE padded totals."""
    calls = []

    def allgather(value, rank, num_ranks):
        calls.append((value, rank, num_ranks))
        return [value]

    tree, state = _state(2)
    mgr = CheckpointManager(str(tmp_path), config=port_config(),
                            device="cpu")
    mgr.allgather = allgather
    with mgr:
        mgr.save(1, state, rank=0, num_ranks=1)
        got = mgr.restore(step=1)
    assert len(calls) == 1 and calls[0][1:] == (0, 1)
    assert calls[0][0] % 4096 == 0 and calls[0][0] > 0
    assert torch.equal(got["params"]["w"], state["params"]["w"])


def test_coordinator_hook_runs_the_two_phase_commit(tmp_path):
    """``CheckpointManager.coordinator``: the staging dir is the
    coordinator's, phase 1 writes the rank manifest, and rank 0's merge
    publishes the step once."""
    _tree, state = _state(3)
    mgr = CheckpointManager(str(tmp_path), config=port_config(),
                            device="cpu")
    coord = CommitCoordinator(InProcessGroup(1))
    made = []
    tmp_dir = coord.tmp_dir
    coord.tmp_dir = lambda d, s: made.append(tmp_dir(d, s)) or made[-1]
    mgr.coordinator = coord
    with mgr:
        mgr.save(4, state)
        step_dir = os.path.join(str(tmp_path), step_dir_name(4))
        assert len(made) == 1 and ".tmp-mw-" in made[0]
        assert not os.path.exists(made[0])
        assert Manifest.rank_manifests(step_dir) == [0]
        assert Manifest.load(step_dir).num_ranks == 1
        got = mgr.restore(step=4)
    assert torch.equal(got["params"]["w"], state["params"]["w"])


# -------------------------------------------------- concurrent save+commit
@pytest.mark.parametrize("strategy", ["single_file", "file_per_process",
                                      "file_per_tensor"])
def test_concurrent_save_one_commit(tmp_ckpt_dir, strategy):
    """N rank threads, one shared dir → exactly ONE committed step dir with
    a merged manifest; every rank's windows present."""
    tree, state = _state(1)
    with _mw(tmp_ckpt_dir, 4, strategy) as mw:
        mw.save(3, state)
        assert sorted(os.listdir(tmp_ckpt_dir)) == [step_dir_name(3)]
        step_dir = os.path.join(tmp_ckpt_dir, step_dir_name(3))
        man = Manifest.load(step_dir)
        assert man.num_ranks == 4
        assert sorted(man.extra["merged_ranks"]) == [0, 1, 2, 3]
        assert Manifest.rank_manifests(step_dir) == [0, 1, 2, 3]
        idx = sorted(tuple(s.index) for s in man.tensors["params/w"].shards)
        assert idx == [(((0, 4), (0, 32))), (((4, 8), (0, 32))),
                       (((8, 12), (0, 32))), (((12, 16), (0, 32)))]
        out = mw.restore()
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert torch.equal(out["params"]["b"], state["params"]["b"])
    assert out["note"] == "lean-1"


def test_single_file_disjoint_regions(tmp_ckpt_dir):
    """SINGLE_FILE: ranks write disjoint, aligned extents of ONE shared file
    (the prefix-sum exchange ran through the in-process allgather), also
    for quantized payloads whose packed sizes are not page multiples."""
    tree = np_state(2)
    with _mw(tmp_ckpt_dir, 4, quantize_prefixes=QUANT,
             quantize_min_bytes=1024) as mw:
        mw.save(1, to_port(tree))
        man = Manifest.load(os.path.join(tmp_ckpt_dir, step_dir_name(1)))
    assert man.extra["quantized"]
    paths = {s.path for r in man.tensors.values() for s in r.shards}
    paths |= {b.path for b in man.blobs.values()}
    assert paths == {"data/checkpoint.bin"}
    spans = sorted((s.offset, s.offset + s.nbytes)
                   for r in man.tensors.values() for s in r.shards)
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 <= b0, f"overlapping extents {a0, a1} and {b0, b1}"
    assert all(a % 4096 == 0 for a, _ in spans)


def test_elastic_restore_n_to_m(tmp_ckpt_dir):
    """A 4-rank checkpoint restores bit-identically on 1/2/3/8-rank meshes
    (windows assembled from whatever saved shards they intersect), readers
    beyond the writers on the writers' device."""
    tree, state = _state(5)
    with _mw(tmp_ckpt_dir, 4) as mw:
        mw.save(2, state)
        for m_ranks in (1, 2, 3, 8):
            trees = mw.restore_sharded(m_ranks, step=2)
            assert len(trees) == m_ranks
            assert all(t["params"]["w"].data.device.type == "cpu"
                       for t in trees)
            got = _reassemble(trees, "w", tree["params"]["w"])
            np.testing.assert_array_equal(got, tree["params"]["w"])
            got_b = _reassemble(trees, "b", tree["params"]["b"])
            np.testing.assert_array_equal(got_b, tree["params"]["b"])


def test_multiwriter_async_and_overwrite(tmp_ckpt_dir):
    """Async driver: save returns early, wait() commits; re-saving the same
    step replaces it atomically."""
    (_t1, s1), (_t2, s2) = _state(1), _state(2)
    with _mw(tmp_ckpt_dir, 2, async_save=True) as mw:
        m = mw.save(9, s1)
        assert m.mode == "async"
        mw.wait()
        assert m.total_bytes > 0 and m.end_to_end_seconds > 0
        mw.save(9, s2)
        mw.wait()
        out = mw.restore(step=9)
    assert torch.equal(out["params"]["w"], s2["params"]["w"])
    assert sorted(os.listdir(tmp_ckpt_dir)) == [step_dir_name(9)]


def test_rank_failure_aborts_group_not_hangs(tmp_ckpt_dir):
    """A failing rank breaks the barrier: peers get MultiWriterAborted
    instead of hanging, nothing is committed, and the NEXT save works."""
    _tree, state = _state(3)
    with _mw(tmp_ckpt_dir, 3) as mw:
        def boom(*a, **kw):
            raise IOError("injected rank-1 flush failure")
        mw.managers[1].engine.begin_save = boom
        with pytest.raises(RuntimeError) as ei:
            mw.save(1, state)
        assert isinstance(ei.value.__cause__, IOError)
        assert mw.latest_step() is None   # nothing committed
        del mw.managers[1].engine.begin_save   # restore class method
        mw.save(2, state)                 # barrier was repaired
        out = mw.restore()
    assert torch.equal(out["params"]["w"], state["params"]["w"])


def test_rank0_commit_failure_reclaims_staging(tmp_ckpt_dir):
    """A phase-2 (rank-0 publish) failure must leave no staging dir behind,
    fail the peers with MultiWriterAborted, and must not poison the next
    save of the same step."""
    _tree, state = _state(6)
    with _mw(tmp_ckpt_dir, 2) as mw:
        def boom(tmp, step):
            raise OSError("injected publish failure")
        mw.managers[0]._publish = boom
        with pytest.raises(RuntimeError):
            mw.save(4, state)
        assert not any(".tmp-" in n for n in os.listdir(tmp_ckpt_dir))
        del mw.managers[0]._publish
        mw.save(4, state)
        out = mw.restore(step=4)
    assert torch.equal(out["params"]["w"], state["params"]["w"])


def test_shard_state_replication_and_snapshot():
    state = {"big": torch.arange(12, dtype=torch.float32).reshape(6, 2),
             "small": torch.arange(2, dtype=torch.float32),
             "np": np.arange(6, dtype=np.float32),
             "scalar": torch.tensor(3.0), "lean": "x", "none": None}
    shards = shard_state(state, 4, snapshot=True)
    assert len(shards) == 4
    assert isinstance(shards[0]["big"], LocalShard)
    assert shards[0]["big"].global_shape == (6, 2)
    # 6 rows over 4 ranks: (2, 2, 1, 1), contiguous and covering
    spans = [s["big"].index[0] for s in shards]
    assert spans == [(0, 2), (2, 4), (4, 5), (5, 6)]
    # short tensors replicated, 0-d ones host scalars (the lean object's),
    # host snapshot copies detached from the source
    assert isinstance(shards[1]["small"], torch.Tensor)
    assert isinstance(shards[2]["scalar"], np.ndarray)
    assert shards[2]["scalar"].ndim == 0 and shards[3]["none"] is None
    state["small"][0] = 99.0
    state["np"][4] = 99.0
    state["big"][5] = 99.0
    assert shards[1]["small"][0] == 0.0 and shards[3]["np"].data[0] == 5.0
    assert shards[3]["big"].data[0, 0] == 10.0
    # without a snapshot the windows are views of the caller's tensors
    views = shard_state(state, 2)
    state["big"][0, 0] = -1.0
    assert views[0]["big"].data[0, 0] == -1.0


@pytest.mark.parametrize("mode", ["streaming", "legacy", "delta"])
def test_async_snapshot_survives_in_place_mutation(tmp_path, mode):
    """Tensors mutated in place right after ``wait_snapshotted()`` returns:
    the committed step restores to the pre-mutation bytes (quantized
    leaves: the reference's decode of the pre-mutation values)."""
    tree = np_state(4)
    state = to_port(tree)
    kw = dict(async_save=True, quantize_prefixes=QUANT,
              quantize_min_bytes=1024, streaming=mode != "legacy",
              delta=mode == "delta", delta_chunk_bytes=4096)
    with _mw(tmp_path / "port", 4, **kw) as mw:
        mw.save(1, state)
        mw.wait_snapshotted()
        for t in (state["params"]["w"], state["opt"]["mu"]["w"],
                  state["opt"]["nu"]["w"], state["step"]):
            t.add_(1)                         # optimizer.step() in place
        mw.wait()
        got = leaves_bytes(mw.restore(step=1))
    with _ref_mw(tmp_path / "ref", 4, quantize_prefixes=QUANT,
                 quantize_min_bytes=1024) as mw:
        mw.save(1, to_jax(tree))
        want = leaves_bytes(mw.restore(step=1))
    assert got == want
    assert got["['params']['w']"] != \
        leaves_bytes(state)["['params']['w']"]


def test_wait_snapshotted_waits_for_every_rank(tmp_path):
    """The async barrier is real: while one rank has not staged its shards,
    ``wait_snapshotted()`` does not return."""
    _tree, state = _state(7, rows=64)
    release = threading.Event()
    with _mw(tmp_path, 4, async_save=True) as mw:
        begin = mw.managers[2].engine.begin_save

        def held(*a, **kw):
            assert release.wait(timeout=30)
            return begin(*a, **kw)

        mw.managers[2].engine.begin_save = held
        mw.save(1, state)
        waiter = threading.Thread(target=mw.wait_snapshotted)
        waiter.start()
        assert waiter.is_alive() and not mw._staged[2].is_set()
        release.set()
        waiter.join(timeout=30)
        assert not waiter.is_alive()
        assert all(ev.is_set() for ev in mw._staged)
        mw.wait()
        got = mw.restore(step=1)
    assert torch.equal(got["params"]["w"], state["params"]["w"])


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("strategy", ["single_file", "file_per_process"])
def test_four_writer_save_is_byte_identical_to_the_reference(tmp_path,
                                                             strategy):
    """The same numpy-seeded state through both packages' 4-writer saves:
    identical data files and manifests (apart from timings); each package
    restores the other's step bit-exactly, whole and as 3 reader windows."""
    tree = np_state(11)
    kw = dict(quantize_prefixes=QUANT, quantize_min_bytes=1024)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    with _ref_mw(ref_dir, 4, strategy, **kw) as mw:
        mw.save(3, to_jax(tree))
    with _mw(port_dir, 4, strategy, **kw) as mw:
        mw.save(3, to_port(tree))
    a, b = dir_files(str(ref_dir)), dir_files(str(port_dir))
    assert sorted(a) == sorted(b)
    assert sum(1 for k in a if "/data/" in k) == (
        1 if strategy == "single_file" else 4)
    for name in a:
        if "manifest" in name.lower():
            assert normalize_manifest(a[name]) == normalize_manifest(b[name])
        else:
            assert a[name] == b[name], name
    whole, windows = {}, {}
    for reader, d in (("ref", port_dir), ("port", ref_dir)):
        make = _ref_mw if reader == "ref" else _mw
        with make(d, 4, strategy) as mw:
            whole[reader] = leaves_bytes(mw.restore(step=3))
            windows[reader] = _windows(mw.restore_sharded(3, step=3))
    for reader, d in (("ref", ref_dir), ("port", port_dir)):
        make = _ref_mw if reader == "ref" else _mw
        with make(d, 4, strategy) as mw:
            assert leaves_bytes(mw.restore(step=3)) == whole[reader]
            assert _windows(mw.restore_sharded(3, step=3)) == \
                windows[reader]
    assert whole["ref"] == whole["port"]
    assert windows["ref"] == windows["port"]
    assert len(windows["port"]["params/w"]) == 3


def _chain(seed: int) -> list[dict]:
    s0 = np_state(seed)
    s1 = copy.deepcopy(s0)
    s1["params"]["w"][3] += 1
    s1["opt"]["mu"]["w"][5, :40] += 1e-3
    s1["step"] = np.asarray(8, np.int32)
    s2 = copy.deepcopy(s1)
    s2["params"]["emb"][100:110] -= 1
    s2["opt"]["nu"]["w"][30] *= 2
    s2["step"] = np.asarray(9, np.int32)
    return [s0, s1, s2]


def test_multiwriter_delta_chain_across_packages(tmp_path):
    """A 4-writer delta chain alternating packages (port, ref, port) dirties
    exactly the chunks the reference alone does, and restores the same
    bytes through either package."""
    kw = dict(delta=True, delta_chunk_bytes=4096, keep=None,
              quantize_prefixes=QUANT, quantize_min_bytes=1024)

    def save(pkg, path, step, tree):
        make, conv = (_ref_mw, to_jax) if pkg == "ref" else (_mw, to_port)
        with make(path, 4, **kw) as mw:
            m = mw.save(step, conv(tree))
        return [(r.chunks_total, r.chunks_dirty, r.written_bytes)
                for r in m.per_rank]

    states = _chain(2)
    alone = [save("ref", tmp_path / "alone", i, s)
             for i, s in enumerate(states)]
    mixed = [save(pkg, tmp_path / "mixed", i, s)
             for i, (pkg, s) in enumerate(zip(["port", "ref", "port"],
                                               states))]
    assert mixed == alone
    dirty = sum(r[1] for r in alone[1])
    assert 0 < dirty < sum(r[0] for r in alone[1])
    for step in (1, 2):
        with _ref_mw(tmp_path / "alone", 4) as mw:
            want = leaves_bytes(mw.restore(step=step))
        with _mw(tmp_path / "mixed", 4) as mw:
            assert leaves_bytes(mw.restore(step=step)) == want
        with _ref_mw(tmp_path / "mixed", 4) as mw:
            assert leaves_bytes(mw.restore(step=step)) == want


# --------------------------------------------------- crash-window publish
def test_commit_crash_window_keeps_previous(tmp_ckpt_dir, monkeypatch):
    """Crash between displacing the old step dir and renaming the new one
    in must NOT lose the previous checkpoint: restart recovers it."""
    _crash_window(tmp_ckpt_dir, monkeypatch)


def test_commit_crash_is_reported_when_rank_1_reaches_the_barrier_last(
        tmp_ckpt_dir, monkeypatch):
    """The same crash with rank 1 reaching every barrier 50 ms after rank
    0, so it is rank 1 that releases the barrier after rank 0's failed
    publish: its ``MultiWriterAborted`` must not abort the group while
    rank 0 is still waking from that barrier, or rank 0's own error is
    replaced by a broken barrier (a thread a barrier released still
    raises ``BrokenBarrierError`` if a peer aborts before it wakes)."""
    wait = InProcessGroup.barrier

    def late_rank_1(self):
        if threading.current_thread().name == "mw-rank-51":
            time.sleep(0.05)
        return wait(self)

    monkeypatch.setattr(InProcessGroup, "barrier", late_rank_1)
    _crash_window(tmp_ckpt_dir, monkeypatch)


def _crash_window(tmp_ckpt_dir, monkeypatch):
    (_t1, s1), (_t2, s2) = _state(1), _state(2)
    with _mw(tmp_ckpt_dir, 2) as mw:
        mw.save(5, s1)
    final = os.path.join(tmp_ckpt_dir, step_dir_name(5))
    real_replace = os.replace

    def crashy(src, dst, *a, **kw):
        if dst == final and ".tmp-" in src and ".tmp-old-" not in src:
            raise RuntimeError("simulated crash mid-publish")
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr(os, "replace", crashy)
    mw2 = _mw(tmp_ckpt_dir, 2)
    with pytest.raises(RuntimeError) as ei:
        mw2.save(5, s2)
    assert "simulated crash" in repr(ei.value.__cause__)
    mw2.close()
    monkeypatch.setattr(os, "replace", real_replace)

    # "restart": a fresh manager's GC rolls the displaced version back
    with CheckpointManager(tmp_ckpt_dir, config=port_config(),
                           device="cpu") as mgr3:
        assert mgr3.all_steps() == [5]
        out = mgr3.restore(step=5)
    assert torch.equal(out["params"]["w"], s1["params"]["w"])


# ------------------------------------------------------- tmp GC ownership
def test_gc_spares_live_tmp_dirs(tmp_ckpt_dir):
    """A second manager starting up mid-flush must not reap a live save's
    tmp dir (owner pid alive) nor a young ownerless one; stale dirs go."""
    os.makedirs(tmp_ckpt_dir, exist_ok=True)
    live = os.path.join(tmp_ckpt_dir, "step_00000001.tmp-mw-live")
    os.makedirs(live)
    write_owner(live)                      # owned by THIS (alive) process
    young = os.path.join(tmp_ckpt_dir, "step_00000002.tmp-young")
    os.makedirs(young)                     # no owner, but brand new
    stale = os.path.join(tmp_ckpt_dir, "step_00000003.tmp-stale")
    os.makedirs(stale)
    old = time.time() - 3600
    os.utime(stale, (old, old))            # no owner, an hour old
    dead = os.path.join(tmp_ckpt_dir, "step_00000004.tmp-dead")
    os.makedirs(dead)
    with open(os.path.join(dead, OWNER_NAME), "w") as f:
        f.write(f"{2**30} 0")              # pid beyond pid_max: not alive
    assert tmp_in_flight(live) and tmp_in_flight(young)
    assert not tmp_in_flight(stale) and not tmp_in_flight(dead)

    _mw(tmp_ckpt_dir, 2).close()
    left = sorted(os.listdir(tmp_ckpt_dir))
    assert "step_00000001.tmp-mw-live" in left
    assert "step_00000002.tmp-young" in left
    assert "step_00000003.tmp-stale" not in left
    assert "step_00000004.tmp-dead" not in left


def test_peer_abort_is_typed():
    """A rank blocked on a barrier the group aborted gets
    ``MultiWriterAborted``, not a hang."""
    group = InProcessGroup(2)
    group.abort()
    with pytest.raises(MultiWriterAborted):
        group.barrier()
    group.reset()
    out = [None, None]
    ts = [threading.Thread(target=lambda r=r: out.__setitem__(
        r, group.allgather(r, r))) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert out == [[0, 1], [0, 1]]


def test_engine_config_is_not_shared(tmp_path):
    """Every rank's manager holds its own non-truncating copy of the
    caller's config; the caller's object is left as it was."""
    cfg = EngineConfig(backend="posix", strategy="single_file",
                       direct=False)
    with MultiWriterCheckpointer(str(tmp_path), 3, config=cfg,
                                 device="cpu") as mw:
        cfgs = [m.config for m in mw.managers]
    assert cfg.truncate and not any(c.truncate for c in cfgs)
    assert len({id(c) for c in cfgs}) == 3
