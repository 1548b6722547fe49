"""The port's mesh paths on 2x2 gloo meshes of CPU processes, held against
the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) checks that
a 2x2 ``Trainer`` accepts ``ckpt_writers > 1`` (N writer threads in each
of its ranks: 8 writers) and that with ``multilevel_remote`` it commits
its step at both levels, then trains reduced float32
recurrentgemma (two groups of its two block kinds), qwen2.5-3b, olmoe and
xlstm-350m 2 steps each under ``Trainer(mesh=)`` on a 2x2 ("data",
"model") mesh — olmoe
saving step 2 through every rank — runs each trained model's prefill on
the mesh, and restores a checkpoint the JAX package saved on a 2x4 mesh
onto the 2x2 mesh through ``restore(shardings=)``. Beside it, the JAX
package's Trainer runs the same configs on a 2x2 host mesh (two archs to a
process) from the
port's initial states (saved as step 0), and the port's unsharded Trainer
runs in this process; after it, the JAX package restores the port's 2x2
checkpoint onto 4x2 and 1x8 meshes. Tolerances: losses rtol 1e-5 against
the unsharded port, 1e-4 against the JAX package; final params rtol 1e-4,
atol 1e-5 of the unsharded port's; the mesh prefill's logits within 1e-5
of the largest of the whole params' prefill; checkpoints bit-exact both
ways.

    python tests/test_torch_mesh.py <rank> <world> <dir> <port>  # a worker
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("recurrentgemma-2b", "qwen2.5-3b", "olmoe-1b-7b", "xlstm-350m")
SAVER = "olmoe-1b-7b"          # its mesh run checkpoints step 2
STEPS = 2
TIMEOUT = 240


def train_config(arch: str, get_config):
    cfg = get_config(arch).scaled_down(layers=2, width_div=8, vocab=512) \
        .replace(dtype="float32")
    if arch == "recurrentgemma-2b":
        # two groups of its two block kinds (a stacked group axis of 2),
        # not one group of its 13-block period: the JAX package's mesh
        # step on 13 blocks compiles for ~40 s on the CPU
        cfg = cfg.replace(block_pattern=("rglru", "attn_local"),
                          num_layers=4)
    return cfg


def data_config(cfg, DataConfig):
    return DataConfig(cfg.vocab_size, 33, 4, seed=0,
                      frontend_len=cfg.frontend_len,
                      frontend_dim=cfg.frontend_dim)


def elastic_config(get_config):
    """The elastic examples' reduced olmoe (bf16)."""
    return get_config("olmoe-1b-7b").scaled_down(layers=2, width_div=16,
                                                 vocab=512)


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
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointManager, EngineConfig
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path,
                                                tree_map_with_path)
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import Layout, Partitioner
    from repro_torch.train.steps import init_train_state, make_prefill_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_host_mesh(2, 2, device="cpu")
    eng = EngineConfig(backend="posix", direct=False)
    out: dict = {"losses": {}, "batches": {}, "prefill": {}}

    def whole(t):
        return tensor_to_numpy(t.full_tensor() if isinstance(t, DTensor)
                               else t)

    # a mesh of more than one rank saves through one group checkpoint: its
    # ranks' writer threads (2 in each of 4 ranks: 8 writers), and a
    # two-level one with a remote dir
    t = Trainer(train_config(ARCHS[0], get_config), TrainerConfig(
        ckpt_every=1, ckpt_dir=os.path.join(directory, "writers"),
        ckpt_writers=2), device="cpu", mesh=mesh)
    out["writers"] = [type(t.ckpt).__name__, t.ckpt.group.num_ranks]
    t.close()
    cfg = train_config(ARCHS[0], get_config)
    levels = [os.path.join(directory, f"two_level_l{i}") for i in (0, 1)]
    t = Trainer(cfg, TrainerConfig(
        steps=1, ckpt_every=1, ckpt_dir=levels[0],
        multilevel_remote=levels[1]), data_cfg=data_config(cfg, DataConfig),
        engine_config=eng, device="cpu", mesh=mesh)
    try:
        t.run()
    finally:
        t.close()
    out["two_level"] = [sorted(os.listdir(d)) for d in levels]

    for arch in ARCHS:
        cfg = train_config(arch, get_config)
        t = Trainer(cfg, TrainerConfig(
            steps=STEPS, ckpt_every=STEPS if arch == SAVER else 0,
            ckpt_dir=os.path.join(directory, "port_ckpt"), log_every=1,
            async_ckpt=False), data_cfg=data_config(cfg, DataConfig),
            engine_config=eng, device="cpu", mesh=mesh)
        seen = out["batches"][arch] = []
        batch_at = t.pipeline.batch_at
        t.pipeline.batch_at = lambda s: (
            lambda b: seen.append({k: sha(v) for k, v in b.items()}) or b)(
                batch_at(s))
        try:
            res = t.run()
        finally:
            t.close()
        out["losses"][arch] = [m["loss"] for m in res["metrics"]]
        params = {path_str(p): whole(v)
                  for p, v in tree_leaves_with_path(res["state"]["params"])}
        # the prefill on the mesh against the same on the whole params
        batch = {k: torch.as_tensor(v) for k, v in batch_at(0).items()
                 if k != "labels"}
        got = make_prefill_step(cfg, act_sharding=t.act_sharding)(
            res["state"]["params"],
            {k: t.batch_layouts[k].distribute(v) for k, v in batch.items()})
        want = make_prefill_step(cfg)(tree_map_with_path(
            lambda _p, v: v.full_tensor(), res["state"]["params"]), batch)
        out["prefill"][arch] = [float((got.full_tensor() - want).abs().max()),
                                float(want.abs().max())]
        if arch == SAVER:    # whole() gathers: every rank takes part
            out["saved"] = {path_str(("train",) + tuple(p)): sha(whole(v))
                            for p, v in tree_leaves_with_path(res["state"])}
        if rank == 0:
            np.savez(os.path.join(directory, f"params_{arch}.npz"), **params)

    # the JAX package's 2x4 checkpoint onto this 2x2 mesh
    with open(os.path.join(directory, "ref_saved.json")) as f:
        ref_saved = json.load(f)
    cfg = elastic_config(get_config)
    meta = init_train_state(cfg, device="meta")
    part = Partitioner(cfg, mesh)
    flat = {path_str(p): lay for p, lay in tree_leaves_with_path(
        part.state_shardings(meta), is_leaf=lambda x: isinstance(x, Layout))}
    copies = {k: (mesh, (Replicate(),) * 2) for k in flat}
    with CheckpointManager(os.path.join(directory, "ref_ckpt"), config=eng,
                           device="cpu") as mgr:
        got = dict(tree_leaves_with_path(mgr.restore(meta, step=1,
                                                     shardings=flat)))
        # ``shardings`` over a DTensor template's own layout (all copies)
        tmpl = tree_map_with_path(
            lambda p, v: DTensor.from_local(
                torch.zeros(v.shape, dtype=v.dtype), *copies[path_str(p)],
                run_check=False), meta)
        over = dict(tree_leaves_with_path(mgr.restore(tmpl, step=1,
                                                      shardings=flat)))
    checks = {}
    for path, v in got.items():
        key, lay = path_str(path), flat[path_str(path)]
        full = v.full_tensor()
        checks[key] = bool(
            sha(tensor_to_numpy(full)) == ref_saved[key]
            and tuple(v.placements) == lay.placements
            and torch.equal(v.to_local(), lay.distribute(full).to_local())
            and tuple(over[path].placements) == lay.placements
            and torch.equal(over[path].to_local(), v.to_local()))
    out["ref_restore"] = checks
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


REF_SAVE = r"""
import os, sys, json, hashlib
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_config
from repro.core import CheckpointManager, EngineConfig
from repro.launch.mesh import make_host_mesh
from repro.sharding.partition import Partitioner
from repro.train.steps import init_train_state
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_mesh import elastic_config, sha
d = sys.argv[1]
cfg = elastic_config(get_config)
mesh = make_host_mesh(2, 4)
part = Partitioner(cfg, mesh)
key = jax.random.key(0)
shape = jax.eval_shape(lambda: init_train_state(key, cfg))
sh = {"params": part.param_shardings(shape["params"]),
      "opt": part.opt_shardings(shape["opt"]["mu"]),
      "step": part.replicated()}
sh["opt"]["count"] = part.replicated()
with mesh:
    state = jax.jit(lambda: init_train_state(key, cfg), out_shardings=sh)()
with CheckpointManager(os.path.join(d, "ref_ckpt"), config=EngineConfig(
        backend="posix", direct=False)) as mgr:
    mgr.save(1, state)
flat = jax.tree_util.tree_flatten_with_path(state)[0]
json.dump({"/".join(str(k.key) for k in p): sha(np.asarray(v))
           for p, v in flat}, open(os.path.join(d, "ref_saved.json"), "w"))
print("REF-SAVE-OK")
"""

REF_TRAIN = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.data import DataConfig
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_mesh import STEPS, data_config, train_config
mesh = make_host_mesh(2, 2)
losses = {}
for arch in sys.argv[3:]:
    cfg = train_config(arch, get_config)
    # resumes the port's initial state (step 0) onto the mesh
    t = Trainer(cfg, TrainerConfig(steps=STEPS, log_every=1, ckpt_every=100,
                                   ckpt_dir=os.path.join(sys.argv[1],
                                                         "init_" + arch)),
                mesh=mesh, data_cfg=data_config(cfg, DataConfig))
    losses[arch] = [m["loss"] for m in t.run()["metrics"]]
    t.close()
json.dump(losses, open(os.path.join(sys.argv[1],
                                   f"ref_losses_{sys.argv[3]}.json"), "w"))
print("REF-TRAIN-OK")
"""

REF_RESTORE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_config
from repro.core import CheckpointManager, EngineConfig
from repro.launch.mesh import make_host_mesh
from repro.sharding.partition import Partitioner
from repro.train.steps import init_train_state
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_mesh import SAVER, sha, train_config
d = sys.argv[1]
cfg = train_config(SAVER, get_config)
shape = jax.eval_shape(lambda: init_train_state(jax.random.key(1), cfg))
out = {}
with CheckpointManager(os.path.join(d, "port_ckpt"), config=EngineConfig(
        backend="posix", direct=False)) as mgr:
    for dm, mm in [(4, 2), (1, 8)]:
        mesh = make_host_mesh(dm, mm)
        part = Partitioner(cfg, mesh)
        sh = {"params": part.param_shardings(shape["params"]),
              "opt": part.opt_shardings(shape["opt"]["mu"]),
              "step": part.replicated()}
        sh["opt"]["count"] = part.replicated()
        tmpl = jax.tree.map(lambda x, s: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=s), shape, sh)
        got = mgr.restore(state_template={"train": tmpl, "data": None})
        flat = jax.tree_util.tree_flatten_with_path(got["train"])[0]
        wq = got["train"]["params"]["blocks"]["b0_attn"]["wq"]
        out[f"{dm}x{mm}"] = {
            "digests": {"train/" + "/".join(str(k.key) for k in p):
                        sha(np.asarray(v)) for p, v in flat},
            "wq_spec": str(wq.sharding.spec),
            "data_step": int(got["data"]["data_step"])}
json.dump(out, open(os.path.join(d, "ref_restored.json"), "w"))
print("REF-RESTORE-OK")
"""


def _start_ref(script: str, directory, *args, **env):
    return subprocess.Popen(
        [sys.executable, "-c", script, str(directory), __file__, *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _run_ref(script: str, directory, marker: str, proc=None):
    p = proc or _start_ref(script, directory)
    log = p.communicate(timeout=TIMEOUT)[0]
    assert p.returncode == 0 and marker in log, log[-4000:]


def _unsharded_run(arch: str):
    """The port's unsharded Trainer on the same data: (losses, final
    params, batch digests by step)."""
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path)
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = train_config(arch, get_config)
    t = Trainer(cfg, TrainerConfig(steps=STEPS, log_every=1),
                data_cfg=data_config(cfg, DataConfig), device="cpu")
    batches = [{k: sha(v) for k, v in t.pipeline.batch_at(s).items()}
               for s in range(STEPS)]
    try:
        res = t.run()
    finally:
        t.close()
    params = {path_str(p): tensor_to_numpy(v)
              for p, v in tree_leaves_with_path(res["state"]["params"])}
    return [m["loss"] for m in res["metrics"]], params, batches


def _save_initial_states(directory) -> None:
    """Each arch's initial port state as step 0 of a Trainer checkpoint, for
    the JAX package's Trainer to start from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointManager, EngineConfig
    from repro_torch.train.steps import init_train_state
    for arch in ARCHS:
        state = init_train_state(train_config(arch, get_config), seed=0,
                                 device="cpu")
        with CheckpointManager(str(directory / f"init_{arch}"), config=(
                EngineConfig(backend="posix", direct=False)),
                device="cpu") as mgr:
            mgr.save(0, {"train": state, "data": {"data_step": 0}})


def test_mesh_training_and_cross_package_reshards(tmp_path):
    import torch
    # this process runs one thread beside the others, as each worker does
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ref_save = _start_ref(REF_SAVE, tmp_path)
    procs = [ref_save]
    try:
        _save_initial_states(tmp_path)
        # the JAX package's 2x2 Trainer, two archs to a process
        ref_trains = [_start_ref(REF_TRAIN, tmp_path, *ARCHS[i:i + 2],
                                 OMP_NUM_THREADS="2")
                      for i in range(0, len(ARCHS), 2)]
        procs += ref_trains
        _run_ref(REF_SAVE, tmp_path, "REF-SAVE-OK", proc=ref_save)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        port = _free_port()
        workers = [subprocess.Popen(
            [sys.executable, __file__, str(r), "4", str(tmp_path),
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(4)]
        procs += workers
        plain = {arch: _unsharded_run(arch) for arch in ARCHS}
        logs = [w.communicate(timeout=TIMEOUT)[0] for w in workers]
        assert [w.returncode for w in workers] == [0] * 4, \
            [log[-3000:] for log in logs]
        for p in ref_trains:
            _run_ref(REF_TRAIN, tmp_path, "REF-TRAIN-OK", proc=p)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    ref_losses = {}
    for arch in ARCHS[::2]:
        with open(tmp_path / f"ref_losses_{arch}.json") as f:
            ref_losses.update(json.load(f))
    for arch in ARCHS:
        losses, params, batches = plain[arch]
        for res in ranks:
            # every rank saw the unsharded run's global batch (host 0 of 1)
            assert res["batches"][arch] == batches, arch
            np.testing.assert_allclose(res["losses"][arch], losses,
                                       rtol=1e-5, err_msg=arch)
            diff, largest = res["prefill"][arch]
            assert diff <= 1e-5 * largest, (arch, diff, largest)
        np.testing.assert_allclose(ranks[0]["losses"][arch],
                                   ref_losses[arch], rtol=1e-4,
                                   err_msg=arch)
        got = np.load(tmp_path / f"params_{arch}.npz")
        assert sorted(got.files) == sorted(params)
        for k, want in params.items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{arch} {k}")
    # the JAX package's 2x4 checkpoint, restored onto 2x2 by every rank
    for res in ranks:
        assert res["writers"] == ["MultiWriterCheckpointer", 8]
        assert res["two_level"] == [["step_00000001"]] * 2
        assert res["ref_restore"] and all(res["ref_restore"].values()), \
            [k for k, ok in res["ref_restore"].items() if not ok]
    # the port's 2x2 checkpoint, restored onto 4x2 and 1x8 by the JAX package
    _run_ref(REF_RESTORE, tmp_path, "REF-RESTORE-OK")
    with open(tmp_path / "ref_restored.json") as f:
        restored = json.load(f)
    saved = ranks[0]["saved"]
    for mesh, got in restored.items():
        assert got["digests"] == saved, mesh
        assert got["data_step"] == STEPS
    assert restored["4x2"]["wq_spec"] == "PartitionSpec(None, None, 'model')"


def _torchrun(args, ckpt_dir):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--device", "cpu", "--steps", "2",
         "--seq-len", "32", "--batch", "4", "--ckpt-dir", str(ckpt_dir),
         *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_train_cli_runs_on_a_mesh_and_refuses_a_mismatched_one(tmp_path):
    # both launches at once
    good = _torchrun(["--mesh", "2x2", "--ckpt-every", "2"], tmp_path / "cli")
    bad = _torchrun(["--mesh", "2x4"], tmp_path / "bad")
    try:
        out, err = good.communicate(timeout=TIMEOUT)
        bad_err = bad.communicate(timeout=TIMEOUT)[1]
    finally:
        for p in (good, bad):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert good.returncode == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("arch=")]
    assert len(lines) == 1 and "mesh=2x2" in lines[0], out
    assert sorted(os.listdir(tmp_path / "cli")) == ["step_00000002"]
    assert bad.returncode != 0
    assert "a 2x4 mesh needs 8 ranks, the process group has 4" in bad_err


def test_elastic_reshard_example_on_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_elastic_reshard.py"),
         "--device", "cpu", "--save", "2x2", "--restore", "4x1", "1x4",
         "--root", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    assert "restored onto 4x1 mesh; wq placements=(Replicate(), " \
        "Shard(dim=2))" in run.stdout
    assert "restored onto 1x4 mesh" in run.stdout
    assert "elastic resharding onto 4x1, 1x4" in run.stdout
    # the card is the default device: more ranks than cards is refused
    env["CUDA_VISIBLE_DEVICES"] = ""
    refused = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_elastic_reshard.py")],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert refused.returncode != 0 and "--device cpu" in refused.stderr


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
