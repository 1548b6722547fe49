"""Attention and the embedding lookup split over ``model`` on 2x2, 1x4 and
4x1 gloo meshes of CPU processes, held against the unsharded port and the
JAX package.

One launch of 4 worker processes (this file, run as a script) beside one
JAX process takes four reduced float32 configs (``config``; d_ff 128, a
vocab of 384: no weight has the table's shape) through each mesh (4x1: a
model axis of size 1, as the card's 1x1 mesh):

- qwen2.5-3b (4 query heads over 2 KV heads, qkv-bias; over 4: one query
  head a rank, two ranks to a KV head);
- internvl2-26b with 12 query heads over 2 KV heads (3 a rank over 4,
  internvl2's grouping; qwen3's qk-norm switched on), its vision prefix of
  8 positions, and a vocab of 510 that splits over 2 but not over 4 (the
  lookup's d split, as the production vocab of 92553);
- gemma2-9b (4 over 4 KV heads: K/V split on whole heads; softcaps, a
  local layer of window 64);
- recurrentgemma-2b (one RG-LRU and one local-attention block, 2 heads
  over 1 KV head: over 4 the heads do not split and each rank attends its
  S/4 query rows).

Each worker checks, on every rank, a batch of 4 x 128 positions:

- the forward logits, the loss and every grad against the unsharded port
  (logits and grads rtol 1e-4 and atol 1e-5 of the largest value, the
  loss rtol 1e-5: ``tests/test_torch_mesh.py``'s) and against the JAX
  package's (computed by the JAX process from the same weights; the loss
  rtol 1e-4);
- one train step with ``seq_parallel`` (the sequence split over
  ``model``), 2 microbatches and per-group remat: the loss and the grads
  (AdamW's first moment after the step) against the unsharded port's same
  step;
- the prefill's logits (rtol 1e-5, atol 1e-5 of the largest) and greedy
  tokens, and ``generate``'s tokens, equal to the unsharded port's;
- inside the attention core (``layers._attention_local``) each rank's
  query block holds H/tp heads, or S/tp rows where the heads do not
  split, and no all-gather there has the bytes of q with every head; no
  all-gather of the step has the bytes of the whole (V, d) table;
- the prefill's FLOPs per rank are the unsharded prefill's over the
  ranks (2%, counted on ``meta``), and a mutant core that makes the heads
  whole where the KV heads do not split (the parent's ``_heads_local`` call)
  fails that wherever they do not;
- ``transformer._lookup`` alone: the embeddings of a vocab-split table
  and of a d-split one bit-equal to the unsharded lookup, and the table's
  grad under an integer-valued upstream grad (its sums exact in any
  order) bit-equal too.

    python tests/test_torch_attn_mesh.py <rank> <world> <dir> <port>
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("qwen2.5-3b", "internvl2-26b", "gemma2-9b", "recurrentgemma-2b")
MESHES = ((2, 2), (1, 4), (4, 1))
B, S = 4, 128               # S > the local layers' window of 64
PROMPT, NEW = 8, 4          # generate's prompt and new tokens
MESH_TOL = dict(rtol=1e-4, atol=1e-5)   # atol: of the largest |value|
PREFILL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL, REF_LOSS_RTOL = 1e-5, 1e-4
FLOPS_RTOL = 0.02
TIMEOUT = 600


def config(get_config, arch: str):
    """The reduced float32 config of ``arch`` (either package's
    ``get_config``)."""
    cfg = get_config(arch).scaled_down(layers=2, width_div=4, vocab=384) \
        .replace(dtype="float32", d_ff=128)
    if arch == "internvl2-26b":
        cfg = cfg.replace(num_heads=12, num_kv_heads=2, head_dim=64,
                          d_model=512, vocab_size=510, qk_norm=True)
    elif arch == "gemma2-9b":
        cfg = cfg.replace(d_model=512, head_dim=128)
    elif arch == "recurrentgemma-2b":
        cfg = cfg.replace(block_pattern=("rglru", "attn_local"),
                          num_layers=2)
    return cfg


def batch_arrays(cfg) -> dict:
    """Seeded tokens and labels (the frontend prefix counted in S) and the
    frontend's embeddings, as numpy arrays."""
    rng = np.random.default_rng(3)
    n = S - cfg.frontend_len
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)}
    if cfg.frontend:
        out["frontend_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
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
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import path_str, \
        tree_leaves_with_path
    from repro_torch.launch.dryrun import CostMode, act_layout
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import serve_cache_layouts
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.dtensor import keep_dims, like, on_local
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import (_unflat, generate, init_train_state,
                                         make_loss_fn, make_prefill_step,
                                         make_train_step)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    torch.set_num_threads(1)
    meshes = {"x".join(map(str, s)): (s, make_host_mesh(*s, device="cpu"))
              for s in MESHES}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def close(got, want, tol) -> bool:
        got, want = whole(got).detach(), torch.as_tensor(want)
        top = float(want.abs().max()) if want.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=tol["rtol"],
                                   atol=tol["atol"] * top))

    def loss_and_grads(cfg, params, batch, act=None):
        flat = tree_leaves_with_path(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        with torch.enable_grad():
            loss, _ = make_loss_fn(cfg, act)(
                _unflat(zip((k for k, _ in flat), leaves)), batch)
            grads = torch.autograd.grad(loss, leaves)
        return whole(loss.detach()), {path_str(k): g for (k, _), g in
                                      zip(flat, grads)}

    def table_gathers(cost, n: int) -> list:
        """The all-gathers of a whole table of n elements: 2-d results of
        n elements (a logit or activation gather is 3-d)."""
        return [list(s) for s, _ in cost.gathers
                if len(s) == 2 and int(np.prod(s)) == n]

    def forward(cfg, params, batch, act=None):
        with torch.no_grad():
            return T.forward(params, cfg, batch["tokens"],
                             batch.get("frontend_embeds"),
                             act_sharding=act)[0]

    # the attention core, recorded: each call's gathers and query blocks
    core, chunked = L._attention_local, L.chunked_attention
    seen: dict = {"cost": None, "q": [], "gathers": []}

    def recording_core(*a):
        cost = seen["cost"]
        n = len(cost.gathers) if cost else 0
        out = seen.get("core", core)(*a)
        if cost:
            seen["gathers"] += [b for _, b in cost.gathers[n:]]
        return out

    def recording_chunked(q, *a, **kw):
        seen["q"].append(list(q.shape))
        return chunked(q, *a, **kw)

    def whole_heads(q, k, v, cfg, window):
        """The parent's core (its ``layers._heads_local`` call): every
        input split as q over batch and heads where all split them alike,
        else whole over the heads."""
        lay = keep_dims(q, (0, 2))
        if any(keep_dims(t, (0, 2)) != lay for t in (k, v)):
            lay = keep_dims(q, (0,))
        return on_local(lambda *ts: L.chunked_attention(*ts, cfg, window),
                        (q, k, v), (lay,) * 3, lay)

    L._attention_local, L.chunked_attention = recording_core, recording_chunked
    out: dict = {}
    try:
        for arch in ARCHS:
            cfg = config(get_config, arch)
            V, d = cfg.vocab_size, cfg.d_model
            params = T.init_params(cfg, seed=0, device="cpu")
            arrays = batch_arrays(cfg)
            batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
            prompt = batch["tokens"][:, :PROMPT]
            logits0 = forward(cfg, params, batch)
            loss0, grads0 = loss_and_grads(cfg, params, batch)
            rcfg = cfg.replace(remat=True)
            state0 = init_train_state(rcfg, seed=0, device="cpu")
            step0 = make_train_step(rcfg, microbatches=2)(state0, batch)[1]
            prefill0 = make_prefill_step(cfg)(params, batch)
            gen0 = generate(cfg, params, prompt, NEW)
            with FlopCounterMode(display=False) as fc:
                make_prefill_step(cfg)(
                    T.init_params(cfg, device="meta"),
                    {k: v.to("meta") for k, v in batch.items()})
            flops0 = fc.get_total_flops()
            res = out[arch] = {}
            for name, (shape, mesh) in meshes.items():
                dp, tp = shape
                part = Partitioner(cfg, mesh)
                dparams = shard_tree(params, part.param_shardings(params))
                tok = part.tokens_sharding(B)
                dbatch = {k: (tok if v.ndim == 2 else part.frontend_sharding(
                    B)).distribute(v) for k, v in batch.items()}
                act = act_layout(cfg, mesh, B)
                seen["q"], seen["gathers"] = [], []
                with CostMode() as cost:
                    seen["cost"] = cost
                    logits = forward(cfg, dparams, dbatch, act)
                    loss, grads = loss_and_grads(cfg, dparams, dbatch, act)
                seen["cost"] = None
                q_bytes = B // dp * S * cfg.q_dim * 4
                r = res[name] = {
                    "logits": close(logits, logits0, MESH_TOL),
                    "loss": [float(loss), float(loss0)],
                    "grads": [k for k in grads0 if not close(
                        grads[k], grads0[k], MESH_TOL)],
                    "q_blocks": sorted({tuple(s) for s in seen["q"]}),
                    "want_q": (
                        [B // dp, S, cfg.num_heads // tp, cfg.head_dim]
                        if cfg.num_heads % tp == 0 else
                        [B // dp, S // tp, cfg.num_heads, cfg.head_dim]),
                    "q_gathers": [b for b in seen["gathers"]
                                  if b == q_bytes],
                    "table_gathers": table_gathers(cost, V * d)}
                # seq_parallel, 2 microbatches, per-group remat
                state = init_train_state(rcfg, seed=0, device="cpu")
                sh = part.state_shardings(state)
                dstate = shard_tree(state, sh)
                metrics = make_train_step(
                    rcfg, microbatches=2, grad_shardings=sh["opt"]["mu"],
                    act_sharding=act_layout(cfg, mesh, B // 2, True))(
                        dstate, dbatch)[1]
                r["sp_loss"] = [float(metrics["loss"]),
                                float(step0["loss"])]
                # AdamW's first moment: a tenth of the step's mean grads
                mu0 = dict(tree_leaves_with_path(state0["opt"]["mu"]))
                r["sp_grads"] = [path_str(k) for k, m in
                                 tree_leaves_with_path(dstate["opt"]["mu"])
                                 if not close(m, mu0[k], MESH_TOL)]
                # prefill, its FLOPs and those of the mutant core
                with CostMode() as cost:
                    got = make_prefill_step(cfg, act)(dparams, dbatch)
                pre = whole(got)
                r["prefill"] = close(pre, prefill0, PREFILL_TOL) and bool(
                    torch.equal(pre.argmax(-1), prefill0.argmax(-1)))
                r["flops"] = [cost.flops, flops0 / (dp * tp)]
                if cfg.num_kv_heads % tp:   # where the parent's differed
                    seen["core"] = whole_heads
                    try:
                        with CostMode() as cost:
                            mutant = make_prefill_step(cfg, act)(dparams,
                                                                 dbatch)
                    finally:
                        seen.pop("core")
                    r["mutant_flops"] = cost.flops
                    r["mutant_prefill"] = close(mutant, prefill0,
                                                PREFILL_TOL)
                # generate on the mesh
                with CostMode() as cost:
                    gm = generate(
                        cfg, dparams, tok.distribute(prompt), NEW,
                        act_sharding=act, cache_layouts=serve_cache_layouts(
                            cfg, mesh, T.init_cache(cfg, B, PROMPT + NEW,
                                                    device="meta")))
                r["generate"] = bool(torch.equal(gm, gen0))
                r["table_gathers"] += table_gathers(cost, V * d)
                res[name + "/state"] = (loss, logits, grads)
            res["plain"] = (loss0, logits0, grads0)
        # the lookup alone, vocab split and d split
        rng = np.random.default_rng(11)
        ids = torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))
        up = torch.from_numpy(rng.integers(-4, 5, (B, S, 64)).astype(
            np.float32))
        lookups: dict = {}
        for V in (512, 510):
            cfg = config(get_config, "qwen2.5-3b").replace(vocab_size=V,
                                                           d_model=64)
            table = torch.from_numpy(rng.standard_normal((V, 64)).astype(
                np.float32))
            t0 = table.clone().requires_grad_(True)
            e0 = T._lookup(t0, ids % V)
            (e0 * up).sum().backward()
            for name, (shape, mesh) in meshes.items():
                part = Partitioner(cfg, mesh)
                spec = part.param_spec(("embed",), (V, 64))
                dt = part.layout(spec).distribute(table).requires_grad_(True)
                tok = part.tokens_sharding(B)
                e = T._lookup(dt, tok.distribute(ids % V))
                act = act_layout(cfg, mesh, B)
                ew = e.redistribute(mesh, act.placements)
                (ew * like(up, ew)).sum().backward()
                lookups[f"{V}/{name}"] = {
                    "spec": list(spec), "layout": [str(p) for p in
                                                   e.placements],
                    "embeddings": bool(torch.equal(whole(ew), e0.detach())),
                    "grad": bool(torch.equal(whole(dt.grad), t0.grad)),
                    "grad_layout": [str(p) for p in dt.grad.placements]}
    finally:
        L._attention_local, L.chunked_attention = core, chunked
    # the JAX package's results, written beside this run
    ref_path = os.path.join(directory, "ref.npz")
    deadline = time.time() + TIMEOUT
    while not os.path.exists(ref_path) and time.time() < deadline:
        if os.path.exists(os.path.join(directory, "ref.failed")):
            break
        time.sleep(0.2)
    ref = dict(np.load(ref_path)) if os.path.exists(ref_path) else {}
    for arch in ARCHS:
        for key in [k for k in out[arch] if "/" in k or k == "plain"]:
            loss, logits, grads = out[arch].pop(key)
            mesh = key.split("/")[0]
            if not ref:
                out[arch][mesh]["ref"] = "missing"
                continue
            got = {"loss": abs(float(loss) - float(ref[f"{arch}/loss"]))
                   <= REF_LOSS_RTOL * abs(float(ref[f"{arch}/loss"])),
                   "logits": close(logits, ref[f"{arch}/logits"], MESH_TOL),
                   "grads": [k for k in grads if not close(
                       grads[k], ref[f"{arch}/grad/{k}"], MESH_TOL)]}
            if key == "plain":
                out[arch]["plain_ref"] = got
            else:
                out[arch][mesh]["ref"] = got
    out["lookup"] = lookups
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------- the JAX package
REF = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_attn_mesh import ARCHS, batch_arrays, config
from repro.configs import get_config
from repro.models import transformer as JT
from repro.train.steps import make_loss_fn
import repro_torch.configs as port_configs
from repro_torch.core.serialization import path_str, state_to_numpy
from repro_torch.models import transformer as T
try:
    out = {}
    for arch in ARCHS:
        jc = config(get_config, arch)
        params = jax.tree.map(jnp.asarray, state_to_numpy(T.init_params(
            config(port_configs.get_config, arch), seed=0, device="cpu")))
        b = {k: jnp.asarray(v) for k, v in batch_arrays(jc).items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: make_loss_fn(jc)(p, b)[0]))(params)
        logits, _ = jax.jit(lambda p: JT.forward(
            p, jc, b["tokens"], b.get("frontend_embeds")))(params)
        out[f"{arch}/loss"] = np.asarray(loss)
        out[f"{arch}/logits"] = np.asarray(logits)
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{arch}/grad/" + path_str(k.key for k in p)] = np.asarray(g)
    np.savez(os.path.join(sys.argv[1], "ref.tmp.npz"), **out)
    os.replace(os.path.join(sys.argv[1], "ref.tmp.npz"),
               os.path.join(sys.argv[1], "ref.npz"))
except BaseException:
    open(os.path.join(sys.argv[1], "ref.failed"), "w").close()
    raise
print("REF-OK")
"""


def test_attention_and_lookup_split_over_model(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "4", str(tmp_path), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REF, str(tmp_path), __file__],
        env=dict(env, OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        assert [p.returncode for p in procs] == [0] * 5, \
            [log[-3000:] for log in logs]
        assert "REF-OK" in logs[-1], logs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        for arch in ARCHS:
            got = res[arch]
            plain = got["plain_ref"]
            assert plain["loss"] and plain["logits"] and not \
                plain["grads"], (r, arch, plain)
            for shape in MESHES:
                mesh = "x".join(map(str, shape))
                c, where = got[mesh], f"rank {r} {mesh} {arch}"
                assert c["logits"], where
                np.testing.assert_allclose(*c["loss"], rtol=LOSS_RTOL,
                                           err_msg=where)
                assert c["grads"] == [], (where, c["grads"])
                ref = c["ref"]
                assert ref["loss"] and ref["logits"] and not ref["grads"], \
                    (where, ref)
                np.testing.assert_allclose(*c["sp_loss"], rtol=LOSS_RTOL,
                                           err_msg=where)
                assert c["sp_grads"] == [], (where, c["sp_grads"])
                assert c["prefill"] and c["generate"], (where, c)
                assert c["q_blocks"] == [c["want_q"]], (where, c)
                assert c["q_gathers"] == [], (where, c["q_gathers"])
                assert c["table_gathers"] == [], (where, c["table_gathers"])
                flops, want = c["flops"]
                assert abs(flops - want) <= FLOPS_RTOL * want, \
                    (where, flops, want)
                if "mutant_flops" in c:
                    assert c["mutant_prefill"], where
                    assert c["mutant_flops"] > (1 + FLOPS_RTOL) * want, \
                        (where, c["mutant_flops"], want)
        for key, c in res["lookup"].items():
            where = f"rank {r} lookup {key}"
            assert c["embeddings"] and c["grad"], (where, c)
            V, mesh = key.split("/")
            tp = int(mesh.split("x")[1])
            # placements over (data, model): the vocab split's output a
            # pending sum over model, its grad split as the table; the d
            # split's output split over d
            if int(V) % tp == 0:
                assert c["spec"] == ["model", None], (where, c)
                assert c["layout"][1] == "P(sum)" and \
                    c["grad_layout"][1] == "S(0)", (where, c)
            else:
                assert c["spec"] == [None, "model"], (where, c)
                assert c["layout"][1] == "S(2)", (where, c)


def test_chunked_attention_takes_a_block_of_query_rows():
    """``chunked_attention`` of the rows [off, off + n) at ``offset`` off,
    against the whole sequence's keys (the row split's call), equals those
    rows of the whole attention, windowed or not, in query chunks or one."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = config(get_config, "gemma2-9b")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 96, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16)))
    for window in (0, 24):
        want = L.chunked_attention(q, k, v, cfg, window, chunk=1024)
        for off, n, chunk in ((0, 32, 16), (32, 32, 1024), (40, 56, 16)):
            got = L.chunked_attention(q[:, off:off + n], k, v, cfg, window,
                                      chunk=chunk, offset=off)
            torch.testing.assert_close(got, want[:, off:off + n],
                                       rtol=1e-6, atol=1e-6)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
