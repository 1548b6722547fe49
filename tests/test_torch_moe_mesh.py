"""Expert-parallel MoE on 2x2, 1x4 and 4x1 gloo meshes of CPU processes,
held against the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) takes a
reduced float32 olmoe-1b-7b (2 layers, width / 4: d_model 512, 4 heads, 8
experts of 512 x 256, top-2) through each mesh (4x1: a model axis of size
1, as the card's 1x1 mesh; every rank holds every expert). Each worker
checks, on every rank:

- ``moe_apply`` on one block's params at the Partitioner's layouts (the
  expert stacks split over ``model``) and a (4, 8, 512) input at the
  residual stream's layout: the routing (``e_flat``, ``pos``, ``keep``)
  identical to the unsharded port's, the output, the aux loss and the
  grads of the input, the router and the three stacks within rtol 1e-4
  (atol 1e-5 of the tensor's largest value: float32 sums split over ranks
  round in another order);
- inside ``moe_apply`` each rank's stacks hold E / tp experts, and no
  collective of the forward or backward gathers an expert stack's bytes
  (``launch.dryrun.CostMode``'s all-gathers);
- ``Trainer(mesh=)`` for 2 steps: the losses, held here to the unsharded
  port's Trainer and to the JAX package's (jitted; started from the
  port's initial state, saved as step 0), rtol 1e-4;
- ``generate`` on the mesh: the unsharded tokens.

    python tests/test_torch_moe_mesh.py <rank> <world> <dir> <port>
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH = "olmoe-1b-7b"
MESHES = ((2, 2), (1, 4), (4, 1))
B, S = 4, 8                 # moe_apply's input
PROMPT, NEW = 4, 4          # generate's prompt and new tokens
STEPS = 2
TOL = dict(rtol=1e-4, atol=1e-5)    # atol: of the largest |value|
TIMEOUT = 240


def moe_config(get_config):
    return get_config(ARCH).scaled_down(layers=2, width_div=4, vocab=512) \
        .replace(dtype="float32")


def data_config(cfg, DataConfig):
    return DataConfig(cfg.vocab_size, 33, 4, seed=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- workers
def worker(rank: int, world: int, directory: str, port: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import serve_cache_layouts
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.dtensor import like
    from repro_torch.sharding.partition import Layout, Partitioner, shard_tree
    from repro_torch.train.steps import generate
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    torch.set_num_threads(1)
    cfg = moe_config(get_config)
    E = cfg.num_experts
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))
                              .astype(np.int32))
    names = ("router", "wg", "wu", "wd")

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def close(got, want) -> bool:
        top = float(want.abs().max()) if want.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * top))

    seen: dict = {}
    route, moe = L.moe_route, L._moe

    def recording_route(*a, **kw):
        out = route(*a, **kw)
        seen.setdefault("route", []).append([t.clone() for t in out[1:]])
        return out

    def recording_moe(p, *a, **kw):
        seen.setdefault("local_experts", []).append(int(p["wg"].shape[0]))
        return moe(p, *a, **kw)

    def moe_fwd_bwd(p, xin):
        """(y, aux, grads of x and the four weights) of one MoE call."""
        leaves = [xin.detach().requires_grad_(True)] + \
            [p[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            y, aux = L.moe_apply(dict(zip(names, leaves[1:])), leaves[0],
                                 cfg)
            loss = (y * like(w, y)).sum() + 3.0 * aux
            grads = torch.autograd.grad(loss, leaves)
        return y, aux, grads

    L.moe_route, L._moe = recording_route, recording_moe
    try:
        plain_moe = {k: v[0] for k, v in
                     params["blocks"]["b0_attn"]["moe"].items()}
        seen.clear()
        want = moe_fwd_bwd(plain_moe, x)
        want_route = seen.pop("route")
        out: dict = {}
        for dm, mm in MESHES:
            mesh = make_host_mesh(dm, mm, device="cpu")
            name = f"{dm}x{mm}"
            part = Partitioner(cfg, mesh)
            dparams = shard_tree(params, part.param_shardings(params))
            dmoe = {k: v.unbind(0)[0] for k, v in
                    dparams["blocks"]["b0_attn"]["moe"].items()}
            act = Layout(mesh, part.activation_spec(B))
            seen.clear()
            with CostMode() as cost:
                got = moe_fwd_bwd(dmoe, act.distribute(x))
            stack = E * cfg.d_model * cfg.moe_d_ff * 4
            res = {
                "route": [all(torch.equal(g, h) for g, h in zip(a, b))
                          for a, b in zip(seen["route"], want_route)]
                == [True] * len(want_route) and len(seen["route"]) == 1,
                "local_experts": list(seen["local_experts"]),
                "want_local": E // mm,
                "stack_gathers": [list(s) for s, b in cost.gathers
                                  if b >= stack // mm and mm > 1],
                "outputs": [close(whole(g).detach(), h.detach())
                            for g, h in zip(got[:2], want[:2])],
                "grads": {n: close(whole(g), h) for n, g, h in zip(
                    ("x",) + names, got[2], want[2])},
            }
            # 2 steps of Trainer(mesh=)
            t = Trainer(cfg, TrainerConfig(steps=STEPS, log_every=1),
                        data_cfg=data_config(cfg, DataConfig), device="cpu",
                        mesh=mesh)
            try:
                res["losses"] = [m["loss"] for m in t.run()["metrics"]]
            finally:
                t.close()
            # generate on the mesh against the unsharded generate
            tok = part.tokens_sharding(B)
            gm = generate(cfg, dparams, tok.distribute(prompt), NEW,
                          act_sharding=act, cache_layouts=serve_cache_layouts(
                              cfg, mesh, T.init_cache(cfg, B, PROMPT + NEW,
                                                      device="meta")))
            gp = generate(cfg, params, prompt, NEW)
            res["generate"] = bool(torch.equal(gm, gp))
            out[name] = res
    finally:
        L.moe_route, L._moe = route, moe
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------- the JAX package
REF_TRAIN = r"""
import os, sys, json
import jax
from repro.configs import get_config
from repro.data import DataConfig
from repro.train.trainer import Trainer, TrainerConfig
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_moe_mesh import STEPS, data_config, moe_config
cfg = moe_config(get_config)
# resumes the port's initial state (step 0)
t = Trainer(cfg, TrainerConfig(steps=STEPS, log_every=1, ckpt_every=100,
                               ckpt_dir=os.path.join(sys.argv[1], "init")),
            data_cfg=data_config(cfg, DataConfig))
losses = [m["loss"] for m in t.run()["metrics"]]
t.close()
json.dump(losses, open(os.path.join(sys.argv[1], "ref_losses.json"), "w"))
print("REF-TRAIN-OK")
"""


def _unsharded_losses(directory) -> list[float]:
    """The port's unsharded Trainer; its initial state saved first as step
    0 for the JAX package's Trainer."""
    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointManager, EngineConfig
    from repro_torch.data import DataConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = moe_config(get_config)
    with CheckpointManager(str(directory / "init"), config=EngineConfig(
            backend="posix", direct=False), device="cpu") as mgr:
        mgr.save(0, {"train": init_train_state(cfg, seed=0, device="cpu"),
                     "data": {"data_step": 0}})
    t = Trainer(cfg, TrainerConfig(steps=STEPS, log_every=1),
                data_cfg=data_config(cfg, DataConfig), device="cpu")
    try:
        return [m["loss"] for m in t.run()["metrics"]]
    finally:
        t.close()


def test_expert_parallel_moe_on_2x2_1x4_and_4x1_meshes(tmp_path):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "4", str(tmp_path), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        plain = _unsharded_losses(tmp_path)
        ref = subprocess.Popen(
            [sys.executable, "-c", REF_TRAIN, str(tmp_path), __file__],
            env=dict(env, OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(ref)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        assert [p.returncode for p in procs] == [0] * 5, \
            [log[-3000:] for log in logs]
        assert "REF-TRAIN-OK" in logs[-1], logs[-1][-3000:]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(tmp_path / "ref_losses.json") as f:
        ref_losses = json.load(f)
    np.testing.assert_allclose(plain, ref_losses, rtol=1e-4)
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        for mesh, got in res.items():
            where = f"rank {r} {mesh}"
            assert got["route"], where
            # each rank ran its own E / tp experts, once per call
            assert got["local_experts"] == [got["want_local"]], (where, got)
            assert got["stack_gathers"] == [], (where, got["stack_gathers"])
            assert all(got["outputs"]), (where, got["outputs"])
            assert all(got["grads"].values()), (where, got["grads"])
            np.testing.assert_allclose(got["losses"], plain, rtol=1e-4,
                                       err_msg=where)
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4,
                                       err_msg=where)
            assert got["generate"], where


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
