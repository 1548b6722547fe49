"""N writer threads in each rank of a mesh: ``Trainer(mesh=,
ckpt_writers=N)`` and ``MultiWriterCheckpointer(process_group=)`` on gloo
meshes of CPU processes, held against the unsharded port and the JAX
package.

One launch of 4 worker processes (this file, run as a script) on reduced
float32 qwen2.5-3b (``test_torch_mesh.train_config``):

  · 2x2 x 2 writers: an async save of step 2 with step 3 run in place right
    after ``wait_snapshotted()``, then a fresh Trainer resumes step 2; its
    loss and every final local block must equal the uninterrupted run's bit
    for bit. The checkpoint holds 8 rank manifests and one SINGLE_FILE
    file; the same save with the file-per-process layout holds 8 files.
  · 1x4 x 3 writers: each rank's rows split unevenly over its threads and
    short leaves replicated on them (read back from the merged manifest);
    the checkpoint resumed on 1x4 x 3, restored onto 4x1 and unsharded,
    and by the JAX package, every leaf bit-exact.
  · 4x1 x 2 writers: step 2 saved, resumed on 4x1 x 2 (every leaf
    bit-exact, one more step), and restored by the JAX package; the JAX
    package restores the 2x2 x 2 checkpoint bit-exact too.
  · the JAX package's own ``Trainer(mesh=2x2, ckpt_writers=2)`` checkpoint
    (a subprocess with 4 host devices) resumed by the port's 2x2 x 2
    Trainer: every leaf bit-exact, the next loss within 1e-4 of the
    reference's own.
  · a failure injected into one writer thread of one rank: every rank's
    save raises, nothing is published or left staged, and the next save
    commits.

Beside it, in this process: a 1x1 mesh of one gloo rank with 2 writer
threads saves and resumes (the port once crashed there, reading a DTensor
leaf as a plain tensor).

    python tests/test_torch_multiwriter_mesh.py <rank> <world> <dir> <port>
"""

import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 240
WORKERS = 4


def train_config(get_config):
    return get_config("qwen2.5-3b").scaled_down(
        layers=2, width_div=8, vocab=512).replace(dtype="float32")


def data_config(cfg, DataConfig):
    return DataConfig(cfg.vocab_size, 33, 4, seed=0)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- workers
def worker(rank: int, world: int, directory: str, port: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.core import (CheckpointManager, EngineConfig,
                                  MultiWriterCheckpointer)
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path)
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    cfg = train_config(get_config)
    eng = EngineConfig(backend="posix", direct=False)
    out: dict = {}

    def trainer(mesh, d, *, steps, every, writers, async_ckpt=True,
                engine=eng):
        return Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=every, ckpt_dir=os.path.join(
                directory, d), ckpt_writers=writers, async_ckpt=async_ckpt,
            keep=None, log_every=1), data_cfg=data_config(cfg, DataConfig),
            engine_config=engine, device="cpu",
            mesh=make_host_mesh(*mesh, device="cpu"))

    def run(t, initial=None):
        try:
            return t.run(initial)
        finally:
            t.close()

    def whole(state) -> dict:
        """sha of every leaf's global value (a collective: every rank; a
        0-d leaf that rode in the lean object is a host array)."""
        return {path_str(p): sha(
            tensor_to_numpy(v.full_tensor() if isinstance(v, DTensor)
                            else v) if isinstance(v, torch.Tensor)
            else np.asarray(v)) for p, v in tree_leaves_with_path(state)}

    def local(state) -> dict:
        return {path_str(p): sha(tensor_to_numpy(
            v.to_local() if isinstance(v, DTensor) else v))
            for p, v in tree_leaves_with_path(state)}

    # 2x2 x 2 writers: async save of step 2, step 3 in place, resumed
    t = trainer((2, 2), "a", steps=3, every=2, writers=2)
    writers = t.ckpt.group.num_ranks
    res = run(t)
    out["a"] = {"writers": writers, "mode": t.save_log[0].mode,
                "save_ranks": t.save_log[0].num_ranks,
                "losses": [m["loss"] for m in res["metrics"]],
                "final": local(res["state"])}
    t = trainer((2, 2), "a", steps=3, every=2, writers=2)
    state, start = t.initial_state()
    out["a"]["restored"] = whole({"train": state})
    res = run(t, (state, start))
    out["a"]["resumed"] = {"start": res["start_step"],
                           "losses": [m["loss"] for m in res["metrics"]],
                           "final": local(res["state"])}
    run(trainer((2, 2), "a_fpp", steps=2, every=2, writers=2,
                engine=EngineConfig(backend="posix", direct=False,
                                    strategy="file_per_process")))

    # 1x4 x 3 writers (sync): resumed on 1x4 x 3, restored onto 4x1 and
    # unsharded
    res = run(trainer((1, 4), "b", steps=2, every=2, writers=3,
                      async_ckpt=False))
    out["b"] = {"saved": whole({"train": res["state"]})}
    t = trainer((1, 4), "b", steps=2, every=2, writers=3)
    try:
        state, start = t.initial_state()
    finally:
        t.close()
    out["b"]["resumed_1x4"] = {"start": start,
                               "digests": whole({"train": state})}
    t = trainer((4, 1), "b", steps=2, every=2, writers=0)
    try:
        state, start = t.initial_state()
    finally:
        t.close()
    out["b"]["restored_4x1"] = {"start": start,
                                "digests": whole({"train": state})}
    with CheckpointManager(os.path.join(directory, "b"), config=eng,
                           device="cpu") as mgr:
        got = mgr.restore(step=2)
    out["b"]["restored_unsharded"] = {
        k: v for k, v in whole(got).items() if k.startswith("train/")}

    # 4x1 x 2 writers: step 2 saved, resumed on 4x1 x 2 for one more step
    res = run(trainer((4, 1), "e", steps=2, every=2, writers=2,
                      async_ckpt=False))
    out["e"] = {"saved": whole({"train": res["state"]})}
    t = trainer((4, 1), "e", steps=3, every=2, writers=2)
    state, start = t.initial_state()
    out["e"]["resumed"] = {"start": start,
                           "digests": whole({"train": state})}
    res = run(t, (state, start))
    out["e"]["losses"] = [m["loss"] for m in res["metrics"]]

    # a failure in one writer thread of rank 1, then a save that commits
    group = dist.new_group(backend="gloo")
    t = trainer((2, 2), "unused", steps=1, every=0, writers=0)
    state = {"train": t.init_state()}
    t.close()
    mw = MultiWriterCheckpointer(os.path.join(directory, "d"), 2,
                                 process_group=group, config=eng,
                                 device="cpu")
    victim = mw.managers[1]
    if rank == 1:
        def injected(*_a, **_k):
            raise OSError("injected write failure")
        victim._commit = injected    # after its flush, before phase 1
    try:
        mw.save(1, state)
        out["d"] = {"first": "committed"}
    except RuntimeError as e:
        out["d"] = {"first": f"{type(e.__cause__).__name__}: {e.__cause__}"}
    dist.barrier()
    out["d"]["after_failure"] = sorted(os.listdir(mw.directory))
    if rank == 1:
        del victim._commit
    mw.save(2, state)
    dist.barrier()
    out["d"]["after_retry"] = sorted(os.listdir(mw.directory))
    out["d"]["saved"] = local(state)
    restored = mw.restore(
        state_template={"train": state["train"]}, step=2)
    out["d"]["restored"] = local(restored)
    mw.close()

    # the JAX package's 2x2 x 2 checkpoint, resumed on 2x2 x 2
    done = os.path.join(directory, "ref_train.json")
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError("the JAX package's run did not finish")
        time.sleep(0.2)
    t = trainer((2, 2), "ref_ckpt", steps=3, every=2, writers=2)
    state, start = t.initial_state()
    restored = whole({"train": state})
    res = run(t, (state, start))
    out["c"] = {"start": start, "digests": restored,
                "losses": [m["loss"] for m in res["metrics"]]}
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


REF_TRAIN = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_config
from repro.core import CheckpointManager, EngineConfig
from repro.data import DataConfig
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_multiwriter_mesh import data_config, sha, train_config
d = sys.argv[1]
cfg = train_config(get_config)
eng = EngineConfig(backend="posix", direct=False)
t = Trainer(cfg, TrainerConfig(steps=3, ckpt_every=2, log_every=1,
                               ckpt_writers=2, keep=None,
                               ckpt_dir=os.path.join(d, "ref_ckpt")),
            mesh=make_host_mesh(2, 2), engine_config=eng,
            data_cfg=data_config(cfg, DataConfig))
losses = [m["loss"] for m in t.run()["metrics"]]
t.close()
ckpt = os.path.join(d, "ref_ckpt")
with CheckpointManager(ckpt, config=eng) as mgr:
    got = mgr.restore(step=2)
flat = jax.tree_util.tree_flatten_with_path(got["train"])[0]
digests = {"train/" + "/".join(str(k.key) for k in p): sha(np.asarray(v))
           for p, v in flat}
ranks = sorted(n for n in os.listdir(os.path.join(ckpt, "step_00000002"))
               if n.startswith("MANIFEST.rank-"))
with open(os.path.join(d, "ref_train.tmp"), "w") as f:
    json.dump({"losses": losses, "digests": digests, "ranks": ranks}, f)
os.replace(os.path.join(d, "ref_train.tmp"), os.path.join(d, "ref_train.json"))
print("REF-TRAIN-OK")
"""

REF_RESTORE = r"""
import os, sys, json
import jax, numpy as np
from repro.core import CheckpointManager, EngineConfig
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_multiwriter_mesh import sha
d = sys.argv[1]
out = {}
for name in ("a", "b", "e"):       # 2x2 x 2, 1x4 x 3, 4x1 x 2
    with CheckpointManager(os.path.join(d, name), config=EngineConfig(
            backend="posix", direct=False)) as mgr:
        got = mgr.restore(step=2)
    flat = jax.tree_util.tree_flatten_with_path(got["train"])[0]
    out[name] = {"train/" + "/".join(str(k.key) for k in p):
                 sha(np.asarray(v)) for p, v in flat}
json.dump(out, open(os.path.join(d, "ref_restored.json"), "w"))
print("REF-RESTORE-OK")
"""


def _ref(script: str, directory, **env):
    return subprocess.Popen(
        [sys.executable, "-c", script, str(directory), __file__],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _logs(directory) -> str:
    out = []
    for r in range(WORKERS):
        with open(directory / f"worker{r}.log") as f:
            out.append(f"--- rank {r}\n" + f.read()[-3000:])
    return "\n".join(out)


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The JAX package's 2x2 x 2 run, then the 4 workers, then the JAX
    package's restore of the 1x4 x 3 checkpoint; returns (directory,
    per-rank results, the reference's run, its restore)."""
    directory = tmp_path_factory.mktemp("mw_mesh")
    ref = _ref(REF_TRAIN, directory, OMP_NUM_THREADS="2")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    workers, logs = [], []
    try:
        for r in range(WORKERS):
            logs.append(open(directory / f"worker{r}.log", "w"))
            workers.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(WORKERS),
                 str(directory), str(port)], env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        log = ref.communicate(timeout=TIMEOUT)[0]
        assert ref.returncode == 0 and "REF-TRAIN-OK" in log, log[-4000:]
        for w in workers:
            w.wait(timeout=TIMEOUT)
        assert [w.returncode for w in workers] == [0] * WORKERS, \
            _logs(directory)
        restore = _ref(REF_RESTORE, directory)
        log = restore.communicate(timeout=TIMEOUT)[0]
        assert restore.returncode == 0 and "REF-RESTORE-OK" in log, \
            log[-4000:]
    finally:
        for p in [ref] + workers:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for r in range(WORKERS):
        with open(directory / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    with open(directory / "ref_train.json") as f:
        ref_train = json.load(f)
    with open(directory / "ref_restored.json") as f:
        ref_restored = json.load(f)
    return directory, ranks, ref_train, ref_restored


def _manifest(path):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.manifest import Manifest
    return Manifest.load(str(path))


def test_async_save_on_2x2_resumes_bit_exact(launch):
    directory, ranks, _, _ = launch
    for res in ranks:
        a = res["a"]
        assert a["writers"] == a["save_ranks"] == 8 and a["mode"] == "async"
        resumed = a["resumed"]
        assert resumed["start"] == 2 and len(a["losses"]) == 3
        assert resumed["losses"] == a["losses"][2:]      # bit for bit
        assert resumed["final"] == a["final"]
    step = directory / "a" / "step_00000002"
    names = sorted(os.listdir(step))
    assert names == sorted([f"MANIFEST.rank-{r}" for r in range(8)]
                           + ["manifest.json", "data"])
    assert len(os.listdir(step / "data")) == 1                 # SINGLE_FILE
    m = _manifest(step)
    assert m.num_ranks == 8 and m.strategy == "single_file"
    fpp = directory / "a_fpp" / "step_00000002"
    assert _manifest(fpp).strategy == "file_per_process"
    assert len(os.listdir(fpp / "data")) == 8                  # one a writer


def test_uneven_rows_and_short_leaves_on_1x4_x_3(launch):
    directory, _, _, _ = launch
    m = _manifest(directory / "b" / "step_00000002")
    assert m.num_ranks == 12
    uneven = replicated = 0
    for key, rec in m.tensors.items():
        rows = {}
        for sh in rec.shards:
            rows.setdefault(tuple(sh.index[1:]), []).append(sh.index[0])
        for spans in rows.values():
            sizes = sorted(hi - lo for lo, hi in spans)
            if len(set(spans)) < len(spans):
                replicated += 1            # a short block, on 3 threads
                assert len(spans) % 3 == 0 and len(set(spans)) * 3 == \
                    len(spans), (key, spans)
            elif sizes[-1] - sizes[0] == 1:
                uneven += 1
            # the threads' rows tile the leading dim of every window
            lo = min(s[0] for s in spans)
            assert sum(hi - lo for lo, hi in set(spans)) == \
                max(s[1] for s in spans) - lo, (key, spans)
    assert uneven and replicated, (uneven, replicated)


def test_checkpoint_restores_on_4x1_unsharded_and_in_jax(launch):
    _, ranks, _, ref_restored = launch
    saved = ranks[0]["b"]["saved"]
    for res in ranks:
        b = res["b"]
        assert b["saved"] == saved
        for where in ("resumed_1x4", "restored_4x1"):
            assert b[where]["start"] == 2
            assert b[where]["digests"] == saved, where
        assert b["restored_unsharded"] == saved
    assert ref_restored["b"] == saved
    # the 2x2 x 2 async save (its resume's restored state) in JAX too
    assert ref_restored["a"] == ranks[0]["a"]["restored"]
    assert all(res["a"]["restored"] == ranks[0]["a"]["restored"]
               for res in ranks)


def test_writer_threads_on_a_4x1_mesh(launch):
    _, ranks, _, ref_restored = launch
    saved = ranks[0]["e"]["saved"]
    for res in ranks:
        e = res["e"]
        assert e["saved"] == saved
        assert e["resumed"]["start"] == 2
        assert e["resumed"]["digests"] == saved
        assert len(e["losses"]) == 1
    assert ref_restored["e"] == saved


def test_jax_two_writer_mesh_checkpoint_resumes_in_the_port(launch):
    _, ranks, ref_train, _ = launch
    # the reference's in-process writers: 2 rank manifests
    assert ref_train["ranks"] == ["MANIFEST.rank-0", "MANIFEST.rank-1"]
    for res in ranks:
        c = res["c"]
        assert c["start"] == 2
        assert c["digests"] == ref_train["digests"]
        assert len(c["losses"]) == 1
        np.testing.assert_allclose(c["losses"], ref_train["losses"][2:],
                                   rtol=1e-4)


def test_failed_writer_thread_publishes_nothing(launch):
    _, ranks, _, _ = launch
    for r, res in enumerate(ranks):
        d = res["d"]
        if r == 1:
            assert d["first"] == "OSError: injected write failure"
        else:
            assert d["first"].startswith("MultiWriterAborted"), d["first"]
        assert d["after_failure"] == []           # nothing staged or published
        assert d["after_retry"] == ["step_00000002"]
        assert d["restored"] == d["saved"]


def test_two_writer_threads_on_a_1x1_mesh(tmp_path):
    """One gloo rank, a 1x1 mesh, 2 writer threads: an async save of step
    2, step 3 in place, then a resume equal to it bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig, MultiWriterCheckpointer
    from repro_torch.core.serialization import tree_leaves_with_path
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = train_config(get_config)
    # one thread, as each worker: the CPU's threaded embedding backward
    # sums in a varying order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        def run(steps):
            t = Trainer(cfg, TrainerConfig(
                steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path),
                ckpt_writers=2, log_every=1),
                data_cfg=data_config(cfg, DataConfig),
                engine_config=EngineConfig(backend="posix", direct=False),
                device="cpu", mesh=make_host_mesh(1, 1, device="cpu"))
            assert isinstance(t.ckpt, MultiWriterCheckpointer)
            try:
                return t.run()
            finally:
                t.close()
        first = run(3)
        assert sorted(os.listdir(tmp_path / "step_00000002")) == [
            "MANIFEST.rank-0", "MANIFEST.rank-1", "data", "manifest.json"]
        again = run(3)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    assert again["start_step"] == 2
    assert [m["loss"] for m in again["metrics"]] == \
        [m["loss"] for m in first["metrics"]][2:]
    for (_, a), (_, b) in zip(tree_leaves_with_path(first["state"]),
                              tree_leaves_with_path(again["state"])):
        assert torch.equal(a.to_local(), b.to_local())


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
