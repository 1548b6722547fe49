"""Failover on a mesh: two-level checkpointing of a 2x2 gloo group of CPU
processes (``Trainer(mesh=, multilevel_remote=)``), held against an
uninterrupted run, the JAX package and a killed group.

One launch of 4 worker processes (this file, run as a script) runs, on a
reduced float32 stablelm-3b (4 heads, so
that 1x4 splits them): an uninterrupted 2x2 run of 6 steps; a
two-level 2x2 run of 4 steps (``ckpt_every=2``) whose level 0 is then
lost (renamed aside); resumes from level 1 on 2x2 and on an elastic 1x4
mesh, each reading step 4 through the group prefetcher, every rank's
local blocks CRC-equal to their windows of the saved state, and their
steps 4 and 5 equal to the uninterrupted run's (rtol 1e-6); a level-1
flush that fails on rank 0 and a level-1 restore that fails on rank 2,
each of which must raise on every rank; the JAX
package's 2x2 two-level step 2 restored onto the port's 2x2 mesh after
node loss; and the restart of a group that was SIGKILLed while the save of
step 4 was in flight (a second launch of 4 processes, held in its commit
and killed by this test), which must resume at step 2 with the torn dir
reaped. After it, the JAX package's ``MultiLevelCheckpointer`` restores
the port's level-1 step 4 after node loss, bit for bit. Beside it: the
``--mesh 2x2 --remote-dir`` CLI under torchrun, and the quickstart and
failover examples on the CPU.

    python tests/test_torch_failover.py <mode> <rank> <world> <dir> <port>
"""

import datetime
import filecmp
import json
import os
import signal
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_mesh import (TIMEOUT, _free_port, _torchrun,  # noqa: E402
                             data_config, sha, train_config)

ARCH = "stablelm-3b"
RTOL = 1e-6


def _crc(t) -> int:
    """zlib CRC-32 of a host tensor's bytes."""
    import torch
    return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _wait_for(path: str, what: str) -> None:
    """Poll for a file another process writes when its part is done."""
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {what} after {TIMEOUT} s")
        time.sleep(0.05)


# ----------------------------------------------------------------- workers
def _setup(rank: int, world: int, port: int):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT))


def _trainer(mesh, directory: str, steps: int, ckpt_every: int, l0: str,
             l1: str):
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = train_config(ARCH, get_config)
    return Trainer(cfg, TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, log_every=1,
        ckpt_dir=os.path.join(directory, l0) if l0 else "",
        multilevel_remote=os.path.join(directory, l1) if l1 else ""),
        data_cfg=data_config(cfg, DataConfig),
        engine_config=EngineConfig(backend="posix", direct=False),
        device="cpu", mesh=mesh)


def _losses(res) -> dict:
    return {m["step"]: m["loss"] for m in res["metrics"]}


def torn_victim(rank: int, world: int, directory: str, port: int) -> None:
    """A 2x2 two-level run whose save of step 4 never commits: each rank
    writes its shards, marks that it reached the commit, and waits there
    for the SIGKILL."""
    _setup(rank, world, port)
    from repro_torch.core.multiwriter import CommitCoordinator
    from repro_torch.launch.mesh import make_host_mesh
    commit = CommitCoordinator.commit

    def held(self, mgr, manifest, tmp, step, r):
        if step == 4:
            with open(os.path.join(directory, f"held{r}"), "w"):
                pass
            time.sleep(TIMEOUT)
        return commit(self, mgr, manifest, tmp, step, r)

    CommitCoordinator.commit = held
    t = _trainer(make_host_mesh(2, 2, device="cpu"), directory, 6, 2,
                 "torn_l0", "torn_l1")
    t.run()


def worker(rank: int, world: int, directory: str, port: int) -> None:
    _setup(rank, world, port)
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.core import EngineConfig, GroupMultiLevelCheckpointer
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path)
    from repro_torch.launch.mesh import make_host_mesh

    mesh22 = make_host_mesh(2, 2, device="cpu")
    mesh14 = make_host_mesh(1, 4, device="cpu")
    out: dict = {}

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def flat(state) -> dict:
        return {path_str(("train",) + tuple(p)): v
                for p, v in tree_leaves_with_path(state)}

    def node_loss(aside: str) -> None:
        """Level 0 is gone: renamed aside, for the test to read."""
        dist.barrier()
        if rank == 0:
            os.rename(os.path.join(directory, "l0"),
                      os.path.join(directory, aside))
        dist.barrier()

    # the uninterrupted run
    t = _trainer(mesh22, directory, 6, 0, "", "")
    try:
        out["straight"] = _losses(t.run())
    finally:
        t.close()

    # two-level on 2x2: steps 2 and 4 at both levels; step 4 gathered whole
    t = _trainer(mesh22, directory, 4, 2, "l0", "l1")
    saved: dict = {}
    save = t.ckpt.save

    def gathering_save(step, state):
        if step == 4:     # every rank gathers: all save together
            saved.update({k: whole(v).clone()
                          for k, v in flat(state["train"]).items()})
        return save(step, state)

    t.ckpt.save = gathering_save
    try:
        out["two_level"] = _losses(t.run())
    finally:
        t.close()
    out["saved"] = {k: sha(tensor_to_numpy(v)) for k, v in saved.items()}

    # node loss, then resumes from level 1 on 2x2 and on an elastic 1x4;
    # before the second, the first one's promote is lost in turn
    for name, mesh, aside in (("2x2", mesh22, "l0_lost"),
                              ("1x4", mesh14, "l0_promoted")):
        node_loss(aside)
        t = _trainer(mesh, directory, 6, 0, "l0", "l1")
        try:
            state, start = t.initial_state()
            lays = t.restore_shardings()
            crcs = {k: _crc(v.to_local()) == _crc(
                        lays[k].distribute(saved[k]).to_local())
                    if isinstance(v, DTensor) else torch.equal(v, saved[k])
                    for k, v in flat(state).items()}
            res = {"start": start, "data_step": t.pipeline.state.step,
                   "crcs_equal": all(crcs.values()), "leaves": len(crcs),
                   "placements": str(flat(state)[
                       "train/params/blocks/b0_attn/wq"].placements),
                   "promoted": sorted(os.listdir(
                       os.path.join(directory, "l0")))}
            res["losses"] = _losses(t.run((state, start)))
        finally:
            t.close()
        out[f"resume_{name}"] = res

    # a level-1 flush that fails on rank 0 raises on every rank
    ck = GroupMultiLevelCheckpointer(
        os.path.join(directory, "fl0"), os.path.join(directory, "fl1"),
        config=EngineConfig(backend="posix", direct=False), device="cpu")
    if rank == 0:
        def broken(pairs):
            raise OSError("injected level-1 write failure")
        ck.transfer.transfer = broken
    w = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh22,
                          [Shard(0), Replicate()])
    try:
        ck.save(1, {"w": w})
        try:
            ck.wait()
            out["flush_failure"] = "no error"
        except RuntimeError as e:
            out["flush_failure"] = str(e)
        out["flush_failure_l0"] = ck.local.all_steps()
        out["flush_failure_l1"] = ck._remote_steps()
    finally:
        ck.close()

    # a level-1 restore that fails on rank 2 raises on every rank, and
    # rank 0 deletes the shared staging dir
    ck = GroupMultiLevelCheckpointer(
        os.path.join(directory, "rl0"), os.path.join(directory, "l1"),
        config=EngineConfig(backend="posix", direct=False), device="cpu")
    if rank == 2:
        def broken(staged, reqs):
            raise OSError("injected level-1 read failure")
        ck.local.prefetcher.fetch_extents = broken
    try:
        try:
            ck.restore(step=4)
            out["restore_failure"] = "no error"
        except (OSError, RuntimeError) as e:
            out["restore_failure"] = repr(e)
        out["restore_failure_l0"] = sorted(os.listdir(
            os.path.join(directory, "rl0")))
    finally:
        ck.close()

    # the JAX package's 2x2 two-level step 2, after node loss, onto 2x2
    _wait_for(os.path.join(directory, "ref_saved.json"), "JAX save")
    t = _trainer(mesh22, directory, 2, 0, "jl0", "ref_l1")
    try:
        state, start = t.initial_state()
        out["from_jax"] = {"start": start,
                           "data_step": t.pipeline.state.step,
                           "digests": {k: sha(tensor_to_numpy(whole(v)))
                                       for k, v in flat(state).items()}}
    finally:
        t.close()

    # the restart of the killed group: step 2, the torn step 4 reaped
    _wait_for(os.path.join(directory, "torn_killed"), "killed group")
    t = _trainer(mesh22, directory, 4, 2, "torn_l0", "torn_l1")
    try:
        after_gc = sorted(os.listdir(os.path.join(directory, "torn_l0")))
        state, start = t.initial_state()
        out["torn"] = {"start": start, "data_step": t.pipeline.state.step,
                       "after_gc": after_gc,
                       "losses": _losses(t.run((state, start)))}
    finally:
        t.close()
    for level in ("torn_l0", "torn_l1"):
        out["torn"][level] = sorted(os.listdir(os.path.join(directory,
                                                            level)))
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


REF_TWO_LEVEL = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_config
from repro.data import DataConfig
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_failover import ARCH
from test_torch_mesh import data_config, sha, train_config
d = sys.argv[1]
cfg = train_config(ARCH, get_config)
t = Trainer(cfg, TrainerConfig(steps=2, ckpt_every=2, log_every=1,
                               ckpt_dir=os.path.join(d, "ref_l0"),
                               multilevel_remote=os.path.join(d, "ref_l1")),
            mesh=make_host_mesh(2, 2), data_cfg=data_config(cfg, DataConfig))
state = t.run()["state"]
t.close()
flat = jax.tree_util.tree_flatten_with_path(state)[0]
digests = {"train/" + "/".join(str(k.key) for k in p): sha(np.asarray(v))
           for p, v in flat}
with open(os.path.join(d, "ref_saved.tmp"), "w") as f:
    json.dump(digests, f)
os.replace(os.path.join(d, "ref_saved.tmp"), os.path.join(d, "ref_saved.json"))
print("REF-TWO-LEVEL-OK")
"""


def _spawn(mode: str, world: int, directory, port: int) -> list:
    """The ranks of a launch, each logging to ``<mode><rank>.log`` (a file,
    not a pipe nobody reads while the test waits on another launch)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(directory / f"{mode}{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, mode, str(r), str(world),
                 str(directory), str(port)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _logs(mode: str, world: int, directory) -> list:
    return [(directory / f"{mode}{r}.log").read_text()[-3000:]
            for r in range(world)]


def _kill_when_held(victims: list, directory) -> list:
    """SIGKILL the group once every rank holds step 4's commit (its shards
    written) and step 2 is at level 1; returns both levels as the kill
    left them."""
    deadline = time.monotonic() + TIMEOUT
    held = [directory / f"held{r}" for r in range(len(victims))]
    flushed = directory / "torn_l1" / "step_00000002" / "manifest.json"
    while not (all(p.exists() for p in held) and flushed.exists()):
        if time.monotonic() > deadline or any(
                v.poll() is not None for v in victims):
            for v in victims:
                v.kill()
                v.wait()
            raise AssertionError(_logs("torn", len(victims), directory))
        time.sleep(0.02)
    for v in victims:
        v.send_signal(signal.SIGKILL)
    for v in victims:
        v.wait()
    return [sorted(os.listdir(directory / level))
            for level in ("torn_l0", "torn_l1")]


@pytest.fixture(scope="module")
def failover_run(tmp_path_factory):
    """The whole launch: the JAX package's two-level run, the killed group
    and the 4 workers; returns (directory, per-rank results, both levels
    of the killed group as the kill left them)."""
    directory = tmp_path_factory.mktemp("failover")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_TWO_LEVEL, str(directory), __file__],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    victims = _spawn("torn", 4, directory, _free_port())
    workers = _spawn("worker", 4, directory, _free_port())
    procs = [ref] + victims + workers
    try:
        killed = _kill_when_held(victims, directory)
        (directory / "torn_killed").touch()
        log = ref.communicate(timeout=TIMEOUT)[0]
        assert ref.returncode == 0 and "REF-TWO-LEVEL-OK" in log, log[-4000:]
        for w in workers:
            w.wait(timeout=TIMEOUT)
        assert [w.returncode for w in workers] == [0] * 4, \
            _logs("worker", 4, directory)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(4):
        with open(directory / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return directory, ranks, killed


def _step_files(path) -> dict:
    return {os.path.relpath(os.path.join(d, n), path): os.path.join(d, n)
            for d, _dirs, names in os.walk(path) for n in names}


def test_two_level_training_on_a_2x2_mesh(failover_run):
    directory, ranks, _ = failover_run
    l0, l1 = directory / "l0_lost", directory / "l1"
    for level in (l0, l1):
        assert sorted(os.listdir(level)) == ["step_00000002",
                                             "step_00000004"], level
    for step in ("step_00000002", "step_00000004"):
        a, b = _step_files(l0 / step), _step_files(l1 / step)
        assert sorted(a) == sorted(b) and "manifest.json" in a
        assert all(filecmp.cmp(a[k], b[k], shallow=False) for k in a), step
    for res in ranks:
        np.testing.assert_allclose(
            [res["two_level"][str(s)] for s in range(4)],
            [res["straight"][str(s)] for s in range(4)], rtol=RTOL)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_node_loss_resumes_from_level_1(failover_run, mesh):
    directory, ranks, _ = failover_run
    for res in ranks:
        got = res[f"resume_{mesh}"]
        assert got["start"] == 4 and got["data_step"] == 4
        assert got["crcs_equal"] and got["leaves"] == len(res["saved"])
        # the union of the ranks' windows promoted step 4 into level 0
        assert got["promoted"] == ["step_00000004"]
        np.testing.assert_allclose(
            [got["losses"][str(s)] for s in (4, 5)],
            [res["straight"][str(s)] for s in (4, 5)], rtol=RTOL)
    # wq's heads split over "model" on either mesh
    assert "Shard(dim=2)" in ranks[0][f"resume_{mesh}"]["placements"]


def test_level_1_flush_failure_raises_on_every_rank(failover_run):
    _, ranks, _ = failover_run
    for rank, res in enumerate(ranks):
        want = ("level-1 flush failed" if rank == 0
                else "level-1 flush failed on rank 0: OSError")
        assert res["flush_failure"].startswith(want), res["flush_failure"]
        assert res["flush_failure_l0"] == [1]
        assert res["flush_failure_l1"] == []


def test_level_1_restore_failure_raises_on_every_rank(failover_run):
    _, ranks, _ = failover_run
    for rank, res in enumerate(ranks):
        want = ("OSError('injected level-1 read failure')" if rank == 2 else
                "RuntimeError('the level-1 restore failed on rank(s) [2]')")
        assert res["restore_failure"] == want
        assert res["restore_failure_l0"] == []


def test_killed_group_resumes_from_the_last_committed_step(failover_run):
    directory, ranks, (torn_l0, torn_l1) = failover_run
    # the kill left step 4's shared staging dir beside the good step 2
    assert torn_l0[0] == "step_00000002" and len(torn_l0) == 2
    assert torn_l0[1].startswith("step_00000004.tmp-mw-"), torn_l0
    assert torn_l1 == ["step_00000002"]
    for res in ranks:
        torn = res["torn"]
        assert torn["after_gc"] == ["step_00000002"]
        assert torn["start"] == 2 and torn["data_step"] == 2
        np.testing.assert_allclose(
            [torn["losses"][str(s)] for s in (2, 3)],
            [res["straight"][str(s)] for s in (2, 3)], rtol=RTOL)
        assert torn["torn_l0"] == torn["torn_l1"] == [
            "step_00000002", "step_00000004"]


def test_level_1_steps_restore_across_packages(failover_run):
    import jax
    from repro.core import EngineConfig as RefConfig
    from repro.core import MultiLevelCheckpointer as RefMultiLevel
    directory, ranks, _ = failover_run
    # the port's level-1 step 4, after node loss, through the JAX package
    with RefMultiLevel(str(directory / "ref_lost_l0"), str(directory / "l1"),
                       config=RefConfig(backend="posix",
                                        direct=False)) as ml:
        got = ml.restore(step=4)
    flat = {"train/" + "/".join(str(k.key) for k in p): sha(np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(
                got["train"])[0]}
    assert flat == ranks[0]["saved"]
    assert int(np.asarray(got["data"]["data_step"])) == 4
    # the JAX package's 2x2 level-1 step 2, after node loss, on the port's
    # 2x2 mesh
    with open(directory / "ref_saved.json") as f:
        ref_saved = json.load(f)
    for res in ranks:
        assert res["from_jax"]["start"] == 2
        assert res["from_jax"]["data_step"] == 2
        assert res["from_jax"]["digests"] == ref_saved


def test_train_cli_on_a_mesh_with_a_remote_dir(tmp_path):
    run = _torchrun(["--mesh", "2x2", "--ckpt-every", "2", "--remote-dir",
                     str(tmp_path / "l1")], tmp_path / "l0")
    try:
        out, err = run.communicate(timeout=TIMEOUT)
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    assert run.returncode == 0, err[-3000:]
    assert [ln for ln in out.splitlines() if ln.startswith("step ")] \
        and "mesh=2x2" in out
    for level in ("l0", "l1"):
        assert sorted(os.listdir(tmp_path / level)) == ["step_00000002"]


def _example(name: str, *args, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 **(env or {})),
        capture_output=True, text=True, timeout=TIMEOUT)


def test_quickstart_example_on_the_cpu(tmp_path):
    run = _example("torch_quickstart.py", "--device", "cpu", "--steps", "4",
                   "--ckpt-every", "2", "--root", str(tmp_path))
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    assert "restored state is bit-exact" in run.stdout
    # the card is the default device
    refused = _example("torch_quickstart.py", "--root", str(tmp_path),
                       env={"CUDA_VISIBLE_DEVICES": ""})
    assert refused.returncode != 0 and "--device cpu" in refused.stderr


def test_failover_example_on_the_cpu(tmp_path):
    run = _example("torch_failover.py", "--device", "cpu", "--root",
                   str(tmp_path))
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    for phase in ("killed at step", "resumed from step",
                  "recovered from level 1"):
        assert phase in run.stdout, run.stdout


if __name__ == "__main__":
    mode = sys.argv[1]
    rank, world, port = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[5])
    {"worker": worker, "torn": torn_victim}[mode](rank, world, sys.argv[4],
                                                  port)
