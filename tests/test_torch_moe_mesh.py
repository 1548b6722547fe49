"""Expert-parallel MoE on 2x2, 1x4, 4x1 and 2x1x2 gloo meshes of CPU
processes, held against the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) takes a
reduced float32 olmoe-1b-7b (2 layers, width / 4: d_model 512, 4 heads, 8
experts of 512 x 256, top-2) through each mesh (4x1: a model axis of size
1, as the card's 1x1 mesh, every rank holding every expert; 2x1x2: a
("pod", "data", "model") mesh built with ``init_device_mesh``, as
``launch.dryrun.fake_mesh`` builds 2x16x16, the batch split pod-major).
Each worker checks, on every rank, ``moe_apply`` on one block's params at
the Partitioner's layouts (the expert stacks split over ``model``) in four
cases (``CASES``): a (4, 8, 512) input at the residual stream's layout at
the config's capacity factor and at one that drops across the data shards,
a (3, 8, 512) batch that does not split over the data axes (every rank
holds it whole), and the ``seq_parallel`` layout (the sequence split over
``model``):

- the routing (``e_flat``, ``pos``, ``keep``) of the rows of this rank's
  data shard identical to the unsharded port's rows there (a rank routes
  its own tokens only); the output, the aux loss and the grads of the
  input, the router and the three stacks within rtol 1e-4 (atol 1e-5 of
  the tensor's largest value: float32 sums split over ranks round in
  another order);
- inside ``moe_apply`` each rank's experts run on E / tp stacks over
  C' / dp of the capacity slots (C' = C rounded up to a multiple of dp), no
  collective of the forward or backward gathers an expert stack's bytes,
  and, where the data axes have more than one rank, none gathers an
  activation of the whole batch (``launch.dryrun.CostMode``'s
  all-gathers);
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
MESHES = ((2, 2), (1, 4), (4, 1), (2, 1, 2))
B, S = 4, 8                 # moe_apply's input
DROPS = 0.5                 # a capacity factor that drops (C = 8 of 32·2/8)
# (name, batch, capacity factor (None: the config's), seq_parallel)
CASES = (("config", B, None, False), ("drops", B, DROPS, False),
         ("replicated", B - 1, None, False), ("seq_parallel", B, DROPS, True))
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


def make_mesh(shape, device="cpu"):
    """A (data, model) mesh, or a (pod, data, model) one of three sizes."""
    if len(shape) == 2:
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(*shape, device=device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, shape,
                            mesh_dim_names=("pod", "data", "model"))


# ----------------------------------------------------------------- workers
def worker(rank: int, world: int, directory: str, port: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.dryrun import CostMode, act_layout
    from repro_torch.launch.specs import serve_cache_layouts
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.dtensor import like
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import generate
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    torch.set_num_threads(1)
    cfg = moe_config(get_config)
    E, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
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
    route, experts = L.moe_route, L._moe_experts

    def recording_route(*a, **kw):
        out = route(*a, **kw)
        seen.setdefault("route", []).append([t.clone() for t in out[1:]])
        return out

    def recording_experts(buf, wg, *a, **kw):
        seen.setdefault("local_experts", []).append(
            [int(wg.shape[0]), int(buf.shape[1])])
        return experts(buf, wg, *a, **kw)

    def moe_fwd_bwd(p, xin, wts, factor):
        """(y, aux, grads of x and the four weights) of one MoE call."""
        leaves = [xin.detach().requires_grad_(True)] + \
            [p[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            y, aux = L.moe_apply(dict(zip(names, leaves[1:])), leaves[0],
                                 cfg, factor)
            loss = (y * like(wts, y)).sum() + 3.0 * aux
            grads = torch.autograd.grad(loss, leaves)
        return y, aux, grads

    L.moe_route, L._moe_experts = recording_route, recording_experts
    try:
        plain_moe = {n: v[0] for n, v in
                     params["blocks"]["b0_attn"]["moe"].items()}
        want = {}
        for case, rows, factor, _ in CASES:
            seen.clear()
            want[case] = (moe_fwd_bwd(plain_moe, x[:rows], w[:rows], factor),
                          seen.pop("route")[0])
        out: dict = {}
        for shape in MESHES:
            mesh = make_mesh(shape)
            name = "x".join(map(str, shape))
            part = Partitioner(cfg, mesh)
            dp = part.dp_size
            dparams = shard_tree(params, part.param_shardings(params))
            dmoe = {n: v.unbind(0)[0] for n, v in
                    dparams["blocks"]["b0_attn"]["moe"].items()}
            stack = E * d * cfg.moe_d_ff * 4
            tp = shape[-1]
            res: dict = {}
            for case, rows, factor, seq in CASES:
                act = act_layout(cfg, mesh, rows, seq)
                xd = act.distribute(x[:rows].contiguous())
                split = part.batch_spec(rows)[0] is not None
                # this rank's data shard: pod-major over the DP axes
                shard = 0
                for ax in part.dp:
                    i = mesh.mesh_dim_names.index(ax)
                    shard = shard * mesh.size(i) + mesh.get_local_rank(i)
                n = rows * S * k // (dp if split else 1)
                lo = shard * n if split else 0
                C = L.moe_capacity(rows * S, cfg,
                                   factor or cfg.moe_capacity_factor)
                whole_batch = {(rows, S, d), (rows * S, d), (rows * S, E),
                               (rows * S * k,)}
                seen.clear()
                with CostMode() as cost:
                    got = moe_fwd_bwd(dmoe, xd, w[:rows], factor)
                (y, aux, grads), want_route = want[case]
                res[case] = {
                    "route": len(seen["route"]) == 1 and all(
                        torch.equal(g, h[lo:lo + n]) for g, h in
                        zip(seen["route"][0], want_route)),
                    "local_experts": list(seen["local_experts"]),
                    # E / tp experts over C' / dp slots
                    "want_local": [E // tp, -(-C // dp)],
                    "stack_gathers": [list(s) for s, b in cost.gathers
                                      if b >= stack // tp and tp > 1],
                    "batch_gathers": [list(s) for s, _ in cost.gathers
                                      if dp > 1 and s in whole_batch],
                    "outputs": [close(whole(g).detach(), h.detach())
                                for g, h in zip(got[:2], (y, aux))],
                    "grads": {n: close(whole(g), h) for n, g, h in zip(
                        ("x",) + names, got[2], grads)},
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
            act = act_layout(cfg, mesh, B)
            gm = generate(cfg, dparams,
                          part.tokens_sharding(B).distribute(prompt), NEW,
                          act_sharding=act, cache_layouts=serve_cache_layouts(
                              cfg, mesh, T.init_cache(cfg, B, PROMPT + NEW,
                                                      device="meta")))
            gp = generate(cfg, params, prompt, NEW)
            res["generate"] = bool(torch.equal(gm, gp))
            out[name] = res
    finally:
        L.moe_route, L._moe_experts = route, experts
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
        assert sorted(res) == sorted("x".join(map(str, m)) for m in MESHES)
        for mesh, got in res.items():
            where = f"rank {r} {mesh}"
            for case, *_ in CASES:
                c = got[case]
                assert c["route"], (where, case)
                # each rank ran its own E / tp experts over its C' / dp
                # slots, once per call
                assert c["local_experts"] == [c["want_local"]], \
                    (where, case, c)
                assert c["stack_gathers"] == [], (where, case, c)
                assert c["batch_gathers"] == [], (where, case, c)
                assert all(c["outputs"]), (where, case, c["outputs"])
                assert all(c["grads"].values()), (where, case, c["grads"])
            np.testing.assert_allclose(got["losses"], plain, rtol=1e-4,
                                       err_msg=where)
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4,
                                       err_msg=where)
            assert got["generate"], where


def test_the_dropping_case_drops_across_the_data_shards():
    """``CASES``' dropping factor on the test's input: the unsharded
    routing drops assignments, and an expert's slots run out in the second
    half of the batch (shard 1 of the 2x2's two) only because of the
    first half's assignments: a shard that counted its own tokens alone
    would keep them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L, transformer as T
    cfg = moe_config(get_config)
    p = T.init_params(cfg, seed=0, device="cpu")["blocks"]["b0_attn"][
        "moe"]
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model))
    probs = torch.softmax(torch.from_numpy(x.astype(np.float32)).reshape(
        -1, cfg.d_model) @ p["router"][0], dim=-1)
    C = L.moe_capacity(B * S, cfg, DROPS)
    _, _, _, keep = L.moe_route(probs, cfg, C)
    half = B * S // 2
    _, _, _, alone = L.moe_route(probs[half:], cfg, C)
    assert not keep.all()
    assert bool((alone & ~keep[half * cfg.experts_per_token:]).any())


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
