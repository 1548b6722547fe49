"""The port's storage tiers beyond level 0, against the JAX package.

Level 1 (``MultiLevelCheckpointer``: a shared directory reached through
hedged extent transfers) and level 2 (``RemoteCheckpointer`` over
``SimObjectStore``: dedup upload, hedged range reads streamed into the
restore pipeline). For the same state both packages publish the same files
at each tier (data byte-identical, manifests equal but for
``_torch_port.VOLATILE_FIELDS``); after level-0 loss either package
restores the other's step to identical leaf bytes, through the prefetcher
(promoting the step to level 0) or the remote stream.
"""

import errno
import os
import shutil
import subprocess
import sys
import threading

import pytest
import torch

from repro.core import MultiLevelCheckpointer as RefMultiLevel
from repro.core import RemoteCheckpointer as RefRemote
from repro.core import SimObjectStore as RefStore
from repro_torch.core import (ChecksumError, Manifest, MultiLevelCheckpointer,
                              RemoteCheckpointer, RemoteConfig,
                              RemotePrefetcher, RestorePrefetcher,
                              SimObjectStore, faults)
from repro_torch.core.aggregation import Extent
from repro_torch.core.io_engine import OP_WRITE, ThreadPoolEngine
from repro_torch.core.pipeline import RestorePipeline, RestoreTask
from repro_torch.core.remote import join_key
from repro_torch.core.tiered import TieredTransferEngine

from _torch_port import (QUANT, VOLATILE_FIELDS, dir_files, leaves_bytes,
                         normalize_manifest, np_state, port_config,
                         ref_config, to_jax, to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 3
STEP_DIR = "step_00000003"
KW = dict(quantize_prefixes=QUANT, quantize_min_bytes=1024)


def _port_ml(local, remote, **kw):
    return MultiLevelCheckpointer(str(local), str(remote),
                                  config=port_config(), device="cpu",
                                  **dict(KW, **kw))


def _ref_ml(local, remote, **kw):
    return RefMultiLevel(str(local), str(remote), config=ref_config(),
                         **dict(KW, **kw))


def _port_remote(local, store, **kw):
    return RemoteCheckpointer(str(local), store, config=port_config(),
                              device="cpu", **dict(KW, **kw))


def _ref_remote(local, store, **kw):
    return RefRemote(str(local), store, config=ref_config(),
                     **dict(KW, **kw))


def _lose(level0) -> None:
    """Node loss: level 0 is gone and comes back empty."""
    shutil.rmtree(level0)
    os.makedirs(level0)


def _same_files(a: str, b: str) -> None:
    fa, fb = dir_files(a), dir_files(b)
    ma = {k: fa.pop(k) for k in list(fa) if k.endswith("manifest.json")}
    mb = {k: fb.pop(k) for k in list(fb) if k.endswith("manifest.json")}
    assert sorted(fa) == sorted(fb) and sorted(ma) == sorted(mb)
    for name in fa:
        assert fa[name] == fb[name], name
    for name in ma:
        assert normalize_manifest(ma[name]) == normalize_manifest(mb[name]), \
            VOLATILE_FIELDS


def _staging_left(level0) -> list:
    return [n for n in os.listdir(level0) if ".tmp" in n]


# ------------------------------------------------------------- level 1
@pytest.fixture
def level1(tmp_path):
    """Both packages save the same state at level 0 and flush it to their
    own level 1; returns the tmp dir."""
    tree = np_state(0)
    with _ref_ml(tmp_path / "ref0", tmp_path / "ref1") as ml:
        ml.save(STEP, to_jax(tree))
        ml.wait()
    with _port_ml(tmp_path / "port0", tmp_path / "port1") as ml:
        ml.save(STEP, to_port(tree))
        ml.wait()
        stats = ml.last_flush_stats
    assert stats.files >= 2 and stats.bytes > 0 and stats.extents >= 2
    assert stats.per_tier["destination"]["bytes_written"] == stats.bytes
    return tmp_path


def test_level1_holds_the_reference_files(level1):
    _same_files(str(level1 / "ref1" / STEP_DIR),
                str(level1 / "port1" / STEP_DIR))


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "monolithic"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_node_loss_restores_through_the_prefetcher(level1, writer,
                                                   streaming):
    """Level 0 lost: the port restores the writer's level-1 step through
    ``RestorePrefetcher`` to the bytes the reference restores from it, and
    the full pull is promoted to a committed level-0 step."""
    remote = level1 / f"{writer}1"
    with _ref_ml(level1 / "r0", remote) as ml:
        want = leaves_bytes(ml.restore(step=STEP))
    local = level1 / "p0"
    with _port_ml(local, remote, streaming=streaming) as ml:
        got = ml.restore(step=STEP)
        assert ml.last_restore_metrics.prefetch_seconds > 0
        assert ml.local.all_steps() == [STEP]          # promoted
        assert not _staging_left(local)
        gets_from_level0 = leaves_bytes(ml.restore(step=STEP))
    assert leaves_bytes(got) == want == gets_from_level0
    _same_files(str(local / STEP_DIR), str(remote / STEP_DIR))


def test_trainer_style_resume_onto_a_template(level1):
    """Node loss, then a restore onto a ``meta`` template: tensors land on
    the manager's device."""
    tmpl = to_port(np_state(0))
    meta = {k: v for k, v in tmpl.items()}
    meta["params"] = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                          else v) for k, v in tmpl["params"].items()}
    _lose(level1 / "port0")
    with _port_ml(level1 / "port0", level1 / "port1") as ml:
        got = ml.restore(state_template=meta)
    assert got["params"]["w"].device.type == "cpu"
    assert leaves_bytes(got)["['params']['w']"] == \
        leaves_bytes(np_state(0))["['params']['w']"]


def test_failed_prefetch_restore_is_discarded(level1):
    """A restore that fails mid-prefetch (a flipped byte at level 1) leaves
    no staged directory and no committed step at level 0."""
    step = level1 / "port1" / STEP_DIR
    sh = Manifest.load(str(step)).tensors["params/w"].shards[0]
    raw = bytearray((step / sh.path).read_bytes())
    raw[sh.offset + 1] ^= 0xFF
    (step / sh.path).write_bytes(bytes(raw))
    local = level1 / "p0"
    with _port_ml(local, level1 / "port1") as ml:
        with pytest.raises(ChecksumError):
            ml.restore(step=STEP)
        assert ml.local.all_steps() == []
        assert not _staging_left(local)


def test_partial_prefetch_stays_staged(level1):
    remote = str(level1 / "port1")
    scratch = str(level1 / "scratch")
    os.makedirs(scratch)
    pf = RestorePrefetcher(remote)
    staged = pf.begin(STEP, scratch)
    m = Manifest.load(os.path.join(remote, STEP_DIR))
    rec = next(iter(m.tensors.values()))
    sh = rec.shards[0]
    n = min(4096, sh.nbytes)
    pf.fetch_extents(staged, [Extent(rec.key, sh.path, sh.offset, n)])
    with open(os.path.join(staged, sh.path), "rb") as f, \
            open(os.path.join(remote, STEP_DIR, sh.path), "rb") as g:
        f.seek(sh.offset)
        g.seek(sh.offset)
        assert f.read(n) == g.read(n)
    final = os.path.join(scratch, STEP_DIR)
    assert pf.finish(staged, final) is False
    assert not os.path.exists(staged) and not os.path.exists(final)
    pf.close()


class _StallUntilHedged(ThreadPoolEngine):
    """The first large write of a flush waits until its hedged duplicate
    has landed, then fails with an injected EIO: an extent-level straggler
    that loses deterministically (released with a success, it could still
    be recorded before the hedge), with no sleep."""

    def __init__(self, shared):
        super().__init__(workers=4)
        self.shared = shared

    def _do(self, r):
        sh = self.shared
        if r.op == OP_WRITE and r.nbytes >= 4096:
            with sh["lock"]:
                first = sh["armed"]
                sh["armed"] = False
                hedge = not first and sh["offset"] == r.offset \
                    and not sh["landed"].is_set()
                if first:
                    sh["offset"] = r.offset
            if first:
                assert sh["landed"].wait(timeout=30)
                raise OSError(errno.EIO, "injected EIO on the straggling "
                                         "primary")
            elif hedge:
                out = ThreadPoolEngine._do(r)
                sh["landed"].set()
                return out
        return ThreadPoolEngine._do(r)


def test_straggling_extent_is_hedged(tmp_path):
    shared = {"lock": threading.Lock(), "armed": True, "offset": None,
              "landed": threading.Event()}

    def factory(role):
        return _StallUntilHedged(shared) if role == "write" \
            else ThreadPoolEngine(workers=4)

    transfer = TieredTransferEngine(engine_factory=factory,
                                    chunk_bytes=16 << 10, hedge_after_s=0.02,
                                    min_bw_bytes_s=1e15)
    local, remote = tmp_path / "l0", tmp_path / "l1"
    tree = np_state(0)
    with _port_ml(local, remote, transfer=transfer) as ml:
        ml.save(STEP, to_port(tree))
        ml.wait()
        stats = ml.last_flush_stats
        assert stats.hedged >= 1 and stats.hedge_wins >= 1
        _lose(local)
        got = ml.restore(step=STEP)
    assert shared["landed"].is_set()
    with _port_ml(tmp_path / "x0", tmp_path / "x1") as plain:
        plain.save(STEP, to_port(tree))
        want = leaves_bytes(plain.restore(step=STEP))
    assert leaves_bytes(got) == want


def test_restore_pipeline_reports_its_planned_reads(tmp_path):
    """``RestorePipeline.run(on_reqs=)`` sees every planned extent read
    before the stream opens."""
    with _port_ml(tmp_path / "l0", tmp_path / "l1") as ml:
        ml.save(STEP, to_port(np_state(0)))
        ml.wait()
        mgr = ml.local
        ckpt = str(tmp_path / "l0" / STEP_DIR)
        m = Manifest.load(ckpt)
        tasks = [RestoreTask(k, r, [(tuple((0, s) for s in r.global_shape),
                                     torch.device("cpu"))],
                             quantized=k in m.extra.get("quantized", ()))
                 for k, r in m.tensors.items()]
        seen = []
        out = RestorePipeline(mgr.engine).run(ckpt, tasks,
                                              on_reqs=seen.extend)
    assert sorted(out) == sorted(m.tensors)
    assert {rq.obj for rq in seen} == set(m.tensors)
    assert sum(rq.nbytes for rq in seen) == sum(
        s.nbytes for r in m.tensors.values() for s in r.shards)


# ------------------------------------------------------------- level 2
def _upload_both(tmp_path, **kw):
    tree = np_state(0)
    with _ref_remote(tmp_path / "ref0", RefStore(str(tmp_path / "refb")),
                     upload_async=False, **kw) as rc:
        rc.save(STEP, to_jax(tree))
    with _port_remote(tmp_path / "port0",
                      SimObjectStore(str(tmp_path / "portb")),
                      upload_async=False, **kw) as rc:
        rc.save(STEP, to_port(tree))
        up = rc.last_upload_stats
    assert up.objects >= 2 and up.bytes > 0
    return tree


def test_bucket_holds_the_reference_objects(tmp_path):
    _upload_both(tmp_path)
    _same_files(str(tmp_path / "refb"), str(tmp_path / "portb"))


@pytest.mark.parametrize("mode", ["stream", "promote"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_step_restores_across_packages_from_one_bucket(tmp_path, writer,
                                                       mode):
    _upload_both(tmp_path)
    with _ref_remote(tmp_path / "r0", RefStore(str(tmp_path / f"{writer}b")),
                     restore_mode=mode) as rc:
        want = leaves_bytes(rc.restore(step=STEP))
    local = tmp_path / "p0"
    with _port_remote(local, SimObjectStore(str(tmp_path / f"{writer}b")),
                      restore_mode=mode) as rc:
        got = leaves_bytes(rc.restore(step=STEP))
        assert rc.local.all_steps() == ([STEP] if mode == "promote" else [])
    assert got == want
    if mode == "stream":          # nothing but the metadata manifest landed
        assert not [n for n in os.listdir(local) if n.startswith("step_")]


def test_stream_restore_without_a_template_stays_on_the_cpu(tmp_path):
    """A CPU manager's stream restore with no template returns CPU tensors
    (the stream's metadata manager takes the local manager's device)."""
    tree = _upload_both(tmp_path)
    with _port_remote(tmp_path / "p0",
                      SimObjectStore(str(tmp_path / "portb"))) as rc:
        got = rc.restore(step=STEP)
    assert got["params"]["w"].device.type == "cpu"
    assert got["opt"]["mu"]["w"].device.type == "cpu"
    assert leaves_bytes(got)["['params']['w']"] == \
        leaves_bytes(tree)["['params']['w']"]


def test_upload_dedup_skips_clean_chunks(tmp_path):
    """A 1%-dirty delta step ships only its new pack; clean packs dedup by
    HEAD; the step stream-restores bit-exactly after level-0 loss."""
    store = SimObjectStore(str(tmp_path / "bucket"))
    state = to_port(np_state(0))
    with _port_remote(tmp_path / "l0", store, upload_async=False, delta=True,
                      delta_chunk_bytes=4096, keep=None,
                      quantize_prefixes=()) as rc:
        rc.save(1, state)
        full = store.bytes_in
        assert rc.last_upload_stats.chunks_skipped == 0
        state["params"]["norm"]["scale"][:4] += 1.0
        rc.save(2, state)
        up = rc.last_upload_stats
        assert up.chunks_skipped > 0 and up.bytes_skipped > 0
        assert store.bytes_in - full < full / 2
        assert rc.tier.committed_steps() == [1, 2]
    _lose(tmp_path / "l0")
    with _port_remote(tmp_path / "l0", store) as rc:
        assert leaves_bytes(rc.restore(step=2)) == leaves_bytes(state)


def test_upload_crash_never_publishes(tmp_path):
    store = SimObjectStore(str(tmp_path / "bucket"))
    s1 = to_port(np_state(1))
    s2 = to_port(np_state(2))
    rc = _port_remote(tmp_path / "l0", store, upload_async=False, keep=None)
    rc.save(1, s1)
    with pytest.raises(faults.InjectedCrash):
        with faults.inject(faults.FaultPlan([faults.Fault(faults.OP_RPUT,
                                                          at=1)])):
            rc.save(2, s2)
    assert rc.tier.committed_steps() == [1]
    rc.tier.upload_step(rc.local.directory, 2)        # a retry converges
    assert rc.tier.committed_steps() == [1, 2]
    rc.close()
    with _port_remote(tmp_path / "fresh", store) as v:
        assert leaves_bytes(v.restore(step=2))["['params']['w']"] == \
            leaves_bytes(s2)["['params']['w']"]


def test_stalled_range_is_hedged_in_a_stream_restore(tmp_path):
    _upload_both(tmp_path)
    cfg = RemoteConfig(range_bytes=16 << 10, window=4, hedge_after_s=0.02,
                       min_bw_bytes_s=1e12)
    stall = faults.Fault(faults.OP_RGET, at=3, action=faults.A_STALL,
                         delay_s=0.5)
    with _port_remote(tmp_path / "p0",
                      SimObjectStore(str(tmp_path / "portb")),
                      remote=cfg) as rc:
        with faults.inject(faults.FaultPlan([stall])):
            got = rc.restore(step=STEP)
        rs = rc._remote_mgr().engine.last_range_stats
    assert rs.hedged >= 1
    with _ref_remote(tmp_path / "r0", RefStore(str(tmp_path / "portb"))) \
            as rc:
        assert leaves_bytes(got) == leaves_bytes(rc.restore(step=STEP))


def test_promote_partial_pull_stays_staged(tmp_path):
    _upload_both(tmp_path)
    store = SimObjectStore(str(tmp_path / "portb"))
    scratch = str(tmp_path / "scratch")
    os.makedirs(scratch)
    pf = RemotePrefetcher(store)
    staged = pf.begin(STEP, scratch)
    m = Manifest.loads(store.get(f"{STEP_DIR}/manifest.json"))
    rec = next(iter(m.tensors.values()))
    sh = rec.shards[0]
    n = min(4096, sh.nbytes)
    pf.fetch_extents(staged, [Extent(rec.key, sh.path, sh.offset, n)])
    with open(os.path.join(staged, sh.path), "rb") as f:
        f.seek(sh.offset)
        assert f.read(n) == store.get_range(join_key(STEP_DIR, sh.path),
                                            sh.offset, n)
    final = os.path.join(scratch, STEP_DIR)
    assert pf.finish(staged, final) is False
    assert not os.path.exists(staged) and not os.path.exists(final)
    pf.close()


STREAM_RESTORE = r"""
import os, sys
from repro_torch.core import EngineConfig, RemoteCheckpointer, SimObjectStore
from repro_torch.core.serialization import state_from_numpy
import numpy as np
root = sys.argv[1]
rng = np.random.default_rng(0)
state = state_from_numpy({"w": rng.standard_normal((64, 300), np.float32),
                          "b": rng.standard_normal(77)}, device="cpu")
cfg = EngineConfig(backend="posix", direct=False)
store = SimObjectStore(os.path.join(root, "bucket"))
with RemoteCheckpointer(os.path.join(root, "a"), store, config=cfg,
                        device="cpu", upload_async=False) as rc:
    rc.save(1, state)
with RemoteCheckpointer(os.path.join(root, "b"), store, config=cfg,
                        device="cpu") as rc:
    got = rc.restore(step=1)
assert all(bool((got[k] == state[k]).all()) for k in state)
print("ok")
"""


def test_stream_restore_raises_no_user_warning(tmp_path):
    """The remote stream hands over read-only bytes; assembling them must
    not trip torch's non-writable-array warning (a fresh process: torch
    warns once per process)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-W", "error::UserWarning", "-c", STREAM_RESTORE,
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
