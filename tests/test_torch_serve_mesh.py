"""The port's serving path on 2x2, 1x4 and 4x1 gloo meshes of CPU
processes, held against the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) serves
reduced float32 qwen2.5-3b (2 KV heads: split over heads on 2x2, the cache
TIMELINE split on 1x4), gemma2-9b (a local ring, softcaps, the float32
residual), recurrentgemma (the RG-LRU state and a local ring), xlstm-350m
(mLSTM and sLSTM caches; 4 heads, so the mLSTM state splits over heads)
and olmoe (the MoE on one token) on each mesh (4x1: a model axis of size
1, whose rule splits size-1 dims, as on the card's 1x1 mesh; the batch of
2 whole over 4 data ranks): ``make_serve_step`` with
``act_sharding`` over a DTensor cache from ``init_cache(layouts=)`` laid
out by ``serve_cache_layouts``, 12 steps with an 8-token window, so the
ring wraps and the slot written moves across the ranks. qwen's params are
swapped in params-only, at the serve layouts, from a train-state
checkpoint the JAX package saved on a 2x4 mesh. Each worker checks, on
every rank:

- every step's logits and every cache leaf's ``full_tensor()`` against
  the port's unsharded ``decode_step`` on the same params (rtol 1e-5, and
  atol 1e-5 of the tensor's largest value: float32 sums split over ranks
  and a combine round in another order, which moves values near zero by
  the rounding of the tensor's scale);
- every cache leaf's local shape against ``serve_specs``' for that mesh;
  on 1x4 no rank holds the whole K/V timeline of qwen;
- every cache leaf's local storage the one ``init_cache`` allocated (the
  update in place);
- ``generate`` on the mesh: the tokens equal the unsharded ``generate``'s,
  the logits at the last prompt position within rtol 1e-5;
- the swap-in: every local block equal to its window of the saved params,
  ``RestoreMetrics.read_bytes`` equal to the bytes of the param extents
  that meet the rank's windows (and the 0-d leaves), so no moment byte is
  read, and every moment leaf empty.

Against the JAX package, in this process: rank 0's logits of every step
and final cache leaves against the reference's ``decode_step`` on the
same params and tokens (rtol 1e-4, atol 1e-5, ``tests/test_torch_serve.py``
's); and qwen's 1x4 run against the reference's own sharded decode — its
``make_serve_step`` jitted with ``serve_specs``' shardings on a 1x4 host
mesh, in a subprocess (``--xla_force_host_platform_device_count``, as
``tests/test_dryrun.py`` does) — within the same tolerance.

    python tests/test_torch_serve_mesh.py <rank> <world> <dir> <port>
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("qwen2.5-3b", "gemma2-9b", "recurrentgemma-2b", "xlstm-350m",
         "olmoe-1b-7b")
SWAP = "qwen2.5-3b"          # swapped in from the JAX package's checkpoint
MESHES = ((2, 2), (1, 4), (4, 1))
B, STEPS, WINDOW = 2, 12, 8
PROMPT, NEW = 4, 4           # generate's prompt and new tokens
MESH_TOL = dict(rtol=1e-5, atol=1e-5)   # atol: of the largest |value|
REF_TOL = dict(rtol=1e-4, atol=1e-5)
TIMEOUT = 240


def serve_config(arch: str, get_config):
    cfg = get_config(arch).scaled_down(layers=2, width_div=8, vocab=512) \
        .replace(dtype="float32")
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=WINDOW)
    if arch == "recurrentgemma-2b":     # two groups of its two block kinds
        cfg = cfg.replace(block_pattern=("rglru", "attn_local"),
                          num_layers=4)
    if arch == "xlstm-350m":            # 4 mLSTM heads split over model
        cfg = cfg.replace(num_heads=4, num_kv_heads=4)
    return cfg


def decode_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, STEPS)).astype(np.int32)


def unflat(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dicts."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


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
    from repro_torch.core import CheckpointManager
    from repro_torch.core.manifest import Manifest
    from repro_torch.core.pipeline import dtensor_window
    from repro_torch.core.resharding import dedupe_shards, plan_window
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path,
                                                tree_map_with_path)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import (arg_leaves, serve_cache_layouts,
                                          serve_specs)
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.partition import Layout, Partitioner, shard_tree
    from repro_torch.train.steps import generate, make_serve_step

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    torch.set_num_threads(1)
    out: dict = {}
    saved = dict(np.load(os.path.join(directory, "ref_params.npz")))
    ckpt = os.path.join(directory, "ref_ckpt")

    def leaves(tree) -> dict:
        return {path_str(p): t for p, t in tree_leaves_with_path(tree)}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def close(got, want) -> bool:
        """Within rtol, and atol relative to the tensor's largest value."""
        top = float(want.abs().max()) if want.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=MESH_TOL["rtol"],
                                   atol=MESH_TOL["atol"] * top))

    def params_only(rec):
        """The windows of every leaf ``shardings`` does not name: empty
        (no rows) for the moments, whole for the 0-d counters."""
        whole = tuple((0, s) for s in rec.global_shape)
        return [(((0, 0),) + whole[1:] if whole else (), None)]

    def swap_in(mesh, param_lay) -> tuple[dict, dict]:
        """qwen's params at the serve layouts, the moments unread."""
        lay = {"train/params/" + k: v for k, v in leaves(param_lay).items()}
        with CheckpointManager(ckpt, device="cpu") as mgr:
            got = mgr.restore(step=1, shardings=lay, window_fn=params_only)
            read = mgr.last_restore_metrics.read_bytes
        manifest = Manifest.load(os.path.join(ckpt, "step_00000001"))
        want = 0
        for key, rec in manifest.tensors.items():
            rec.shards = dedupe_shards(rec)
            if key in lay:
                win = dtensor_window(mesh, lay[key].placements,
                                     tuple(rec.global_shape))[0]
            elif rec.global_shape:
                continue                            # a moment: no window
            else:
                win = ()
            want += sum({(p.shard.path, p.shard.offset): p.shard.nbytes
                         for p in plan_window(rec, win)}.values())
        params = got["train"]["params"]
        blocks = {k: bool(np.array_equal(
            tensor_to_numpy(t.to_local()), tensor_to_numpy(
                lay["train/params/" + k].distribute(
                    torch.from_numpy(saved[k])).to_local())))
                  for k, t in leaves(params).items()}
        moments = [k for k, t in leaves(got["train"]["opt"]).items()
                   if t.ndim and t.numel()]
        return params, dict(read_bytes=read, want_bytes=want,
                            blocks_equal=all(blocks.values()),
                            blocks=len(blocks), moments_read=moments)

    for dm, mm in MESHES:
        mesh = make_host_mesh(dm, mm, device="cpu")
        name = f"{dm}x{mm}"
        for arch in ARCHS:
            cfg = serve_config(arch, get_config)
            part = Partitioner(cfg, mesh)
            meta = T.init_params(cfg, device="meta")
            param_lay = part.param_shardings(meta)
            res: dict = {}
            if arch == SWAP:
                dparams, res["swap"] = swap_in(mesh, param_lay)
                params = tree_map_with_path(lambda _p, t: t.full_tensor(),
                                            dparams)
            else:
                flat = dict(np.load(os.path.join(directory,
                                                 f"params_{arch}.npz")))
                params = tree_map_with_path(lambda _p, a: torch.from_numpy(a),
                                            unflat(flat))
                dparams = shard_tree(params, param_lay)
            act = Layout(mesh, part.activation_spec(B))
            tok_lay = part.tokens_sharding(B)
            cache_lay = serve_cache_layouts(
                cfg, mesh, T.init_cache(cfg, B, STEPS, device="meta"))
            cache = T.init_cache(cfg, B, STEPS, device="cpu",
                                 layouts=cache_lay)
            plain = T.init_cache(cfg, B, STEPS, device="cpu")
            specs = dict(arg_leaves(serve_specs(
                cfg, ShapeConfig("d", STEPS, B, "decode"), mesh)[1]))
            res["local_shapes"] = all(
                tuple(t.to_local().shape) == specs[k].local_shape
                for k, t in leaves(cache).items())
            res["local_kv"] = {k: [list(t.to_local().shape), list(t.shape)]
                               for k, t in leaves(cache).items()
                               if k.endswith(("/k", "/v"))}
            ptrs = {k: t.to_local().data_ptr()
                    for k, t in leaves(cache).items()}
            serve, serve_plain = make_serve_step(cfg, act), \
                make_serve_step(cfg)
            toks = torch.from_numpy(decode_tokens(cfg))
            logits, worst = [], 0.0
            ok = True
            for t in range(STEPS):
                tk, pos = toks[:, t:t + 1], torch.full((B, 1), t,
                                                        dtype=torch.int32)
                got, back = serve(dparams, cache, tok_lay.distribute(tk),
                                  tok_lay.distribute(pos))
                want, _ = serve_plain(params, plain, tk, pos)
                ok &= back is cache
                pairs = [(got.full_tensor(), want)] + [
                    (whole(g), leaves(plain)[k])
                    for k, g in leaves(cache).items()]
                for g, w in pairs:
                    ok &= close(g.float(), w.float())
                    worst = max(worst, float((g.float() - w.float())
                                             .abs().max()) / max(
                        float(w.float().abs().max()), 1e-30))
                logits.append(tensor_to_numpy(got.full_tensor()))
            res["vs_unsharded"] = ok
            res["max_rel_err"] = worst
            res["in_place"] = ptrs == {k: t.to_local().data_ptr()
                                       for k, t in leaves(cache).items()}
            final = {k: tensor_to_numpy(whole(v))
                     for k, v in leaves(cache).items()}
            # generate on the mesh against the unsharded generate
            prompt = toks[:, :PROMPT]
            rec_m, rec_p = {}, {}
            gm = generate(cfg, dparams, tok_lay.distribute(prompt), NEW,
                          record=rec_m, act_sharding=act,
                          cache_layouts=serve_cache_layouts(
                              cfg, mesh, T.init_cache(
                                  cfg, B, PROMPT + NEW, device="meta")))
            gp = generate(cfg, params, prompt, NEW, record=rec_p)
            res["generate"] = bool(
                not hasattr(gm, "full_tensor") and torch.equal(gm, gp)
                and close(rec_m["prompt_logits"].full_tensor(),
                          rec_p["prompt_logits"]))
            out[f"{name}/{arch}"] = res
            if rank == 0:
                np.savez(os.path.join(directory, f"port_{name}_{arch}.npz"),
                         logits=np.stack(logits),
                         **{"cache/" + k: v for k, v in final.items()})
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------- the JAX package
REF_SAVE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_config
from repro.core import CheckpointManager, EngineConfig
from repro.core.serialization import path_str
from repro.launch.mesh import make_host_mesh
from repro.sharding.partition import Partitioner
from repro.train.steps import init_train_state
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_serve_mesh import SWAP, serve_config
d = sys.argv[1]
cfg = serve_config(SWAP, get_config)
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
    mgr.save(1, {"train": state})
flat = jax.tree_util.tree_flatten_with_path(state["params"])[0]
np.savez(os.path.join(d, "ref_params.npz"),
         **{path_str(p): np.asarray(v) for p, v in flat})
print("REF-SAVE-OK")
"""

REF_SERVE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.serialization import path_str
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import serve_specs
from repro.models import transformer as JT
from repro.models.config import ShapeConfig
from repro.train.steps import init_train_state, make_serve_step
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_serve_mesh import B, STEPS, SWAP, decode_tokens, serve_config
d = sys.argv[1]
cfg = serve_config(SWAP, get_config)
mesh = make_host_mesh(1, 4)
_, _, tok, _, param_sh, cache_sh = serve_specs(
    cfg, ShapeConfig("d", STEPS, B, "decode"), mesh)
params = jax.jit(lambda: init_train_state(jax.random.key(0), cfg))()[
    "params"]
params = jax.device_put(params, param_sh)
cache = jax.device_put(JT.init_cache(cfg, B, STEPS), cache_sh)
step = jax.jit(make_serve_step(cfg), donate_argnums=(1,),
               out_shardings=(None, cache_sh))
toks = decode_tokens(cfg)
logits = []
with mesh:
    for t in range(STEPS):
        put = lambda a: jax.device_put(jnp.asarray(a), tok.sharding)
        out, cache = step(params, cache, put(toks[:, t:t + 1]),
                          put(np.full((B, 1), t, np.int32)))
        logits.append(np.asarray(out))
k = cache["b0_attn"]["k"]
assert k.sharding.spec[2] == "model", k.sharding.spec
flat = jax.tree_util.tree_flatten_with_path(cache)[0]
np.savez(os.path.join(d, "ref_sharded.npz"), logits=np.stack(logits),
         **{"cache/" + path_str(p): np.asarray(v) for p, v in flat})
print("REF-SERVE-OK")
"""


def _start_ref(script: str, directory):
    return subprocess.Popen(
        [sys.executable, "-c", script, str(directory), __file__],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc, marker: str) -> None:
    log = proc.communicate(timeout=TIMEOUT)[0]
    assert proc.returncode == 0 and marker in log, log[-4000:]


def _reference_decode(arch: str, params: dict) -> dict:
    """The JAX package's unsharded decode_step: every step's logits and
    the final cache leaves, keyed as the port's npz."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.serialization import path_str
    from repro.models import transformer as JT
    cfg = serve_config(arch, get_config)
    jparams = jax.tree.map(jnp.asarray, unflat(params))
    cache = JT.init_cache(cfg, B, STEPS)
    dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    toks = decode_tokens(cfg)
    logits = []
    for t in range(STEPS):
        out, cache = dec(jparams, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(np.full((B, 1), t, np.int32)))
        logits.append(np.asarray(out))
    flat = jax.tree_util.tree_flatten_with_path(cache)[0]
    return {"logits": np.stack(logits),
            **{"cache/" + path_str(p): np.asarray(v) for p, v in flat}}


def _port_params(directory) -> None:
    """Each arch but ``SWAP``'s port init (seed 0), for the workers and
    the reference."""
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                                tree_leaves_with_path)
    from repro_torch.models import transformer as T
    for arch in ARCHS:
        if arch != SWAP:
            params = T.init_params(serve_config(arch, get_config), seed=0,
                                   device="cpu")
            np.savez(directory / f"params_{arch}.npz",
                     **{path_str(p): tensor_to_numpy(v)
                        for p, v in tree_leaves_with_path(params)})


def _assert_close(got: dict, want: dict, tol: dict, what: str) -> None:
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        if k.endswith("/pos"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                       **tol)


def test_decode_and_swap_in_on_2x2_1x4_and_4x1_meshes(tmp_path):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    ref_save = _start_ref(REF_SAVE, tmp_path)
    ref_serve = _start_ref(REF_SERVE, tmp_path)
    procs = [ref_save, ref_serve]
    try:
        _port_params(tmp_path)
        _wait(ref_save, "REF-SAVE-OK")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        port = _free_port()
        workers = [subprocess.Popen(
            [sys.executable, __file__, str(r), "4", str(tmp_path),
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(4)]
        procs += workers
        refs = {arch: _reference_decode(arch, dict(np.load(
            tmp_path / ("ref_params.npz" if arch == SWAP
                        else f"params_{arch}.npz")))) for arch in ARCHS}
        logs = [w.communicate(timeout=TIMEOUT)[0] for w in workers]
        assert [w.returncode for w in workers] == [0] * 4, \
            [log[-3000:] for log in logs]
        _wait(ref_serve, "REF-SERVE-OK")
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
    for r, res in enumerate(ranks):
        for cell, got in res.items():
            where = f"rank {r} {cell}"
            assert got["vs_unsharded"], (where, got["max_rel_err"])
            assert got["local_shapes"] and got["in_place"], where
            assert got["generate"], where
        for mesh in ("2x2", "1x4", "4x1"):
            swap = res[f"{mesh}/{SWAP}"]["swap"]
            assert swap["blocks_equal"] and swap["blocks"] > 0, (r, mesh)
            assert swap["read_bytes"] == swap["want_bytes"] > 0, (r, mesh,
                                                                   swap)
            assert swap["moments_read"] == [], (r, mesh, swap)
        # 1x4: each rank holds a quarter of qwen's K/V timeline
        for k, (local, full) in res[f"1x4/{SWAP}"]["local_kv"].items():
            assert local[2] * 4 == full[2] and local[3] == full[3], (k, local)
        for k, (local, full) in res[f"2x2/{SWAP}"]["local_kv"].items():
            assert local[2] == full[2] and local[3] * 2 == full[3], (k, local)
    # each rank reads its windows' extents, never all of the params
    total = sum(v.nbytes for v in np.load(tmp_path / "ref_params.npz")
                .values())
    assert all(res[f"{m}/{SWAP}"]["swap"]["read_bytes"] < total
               for res in ranks for m in ("2x2", "1x4"))
    for mesh in ("2x2", "1x4", "4x1"):
        for arch in ARCHS:
            got = dict(np.load(tmp_path / f"port_{mesh}_{arch}.npz"))
            _assert_close(got, refs[arch], REF_TOL, f"{mesh} {arch}")
    # the reference's own 1x4 sharded decode (timeline split over model)
    _assert_close(dict(np.load(tmp_path / f"port_1x4_{SWAP}.npz")),
                  dict(np.load(tmp_path / "ref_sharded.npz")), REF_TOL,
                  "1x4 qwen against the reference's sharded decode")


@pytest.mark.parametrize("streaming", [True, False])
def test_params_only_restore_reads_no_moment_bytes(tmp_path, streaming):
    """One process: ``RestoreMetrics.read_bytes`` counts the extents a
    restore reads — every tensor's for a whole restore; with ``window_fn``
    giving the moments empty windows, only the params' and the 0-d
    leaves', the moments coming back empty."""
    import torch
    from repro_torch.core import CheckpointManager, EngineConfig
    state = {"params": {"w": torch.arange(4096, dtype=torch.float32)
                        .reshape(64, 64), "b": torch.ones(64)},
             "opt": {"mu": {"w": torch.zeros(64, 64), "b": torch.zeros(64)},
                     "count": torch.tensor(3)}}
    cfg = EngineConfig(backend="posix", direct=False)
    with CheckpointManager(str(tmp_path), config=cfg, streaming=streaming,
                           device="cpu") as mgr:
        mgr.save(1, state)
        mgr.restore(step=1)
        assert mgr.last_restore_metrics.read_bytes == \
            (2 * 4096 + 2 * 64) * 4 + 8
        got = mgr.restore(step=1, window_fn=lambda rec: [(
            ((0, 0),) + tuple((0, n) for n in rec.global_shape[1:])
            if rec.global_shape and not rec.key.startswith("params/")
            else tuple((0, n) for n in rec.global_shape), None)])
        assert mgr.last_restore_metrics.read_bytes == (4096 + 64) * 4 + 8
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["opt"]["mu"]["w"].shape == (0, 64)
    assert int(got["opt"]["count"]) == 3


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
