"""The xLSTM blocks split over ``model`` on 2x2, 1x4 and 4x1 gloo meshes of
CPU processes, held against the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) beside one
JAX process takes a reduced float32 xlstm-350m (``config``: 2 layers, one
mLSTM and one sLSTM block, d 256, up-projection 512, 2 heads of 256)
through each mesh: on 2x2 each ``model`` rank keeps one mLSTM head; on
1x4 two ranks share a head and each computes its 128 of the head's 256
value columns; on 4x1 (a model axis of size 1, as the card's 1x1 mesh)
nothing splits over ``model``. The sLSTM runs each rank's d/tp channels,
h gathered over ``model`` at every step.

Each worker checks, on every rank, a batch of 4 x 128 positions:

- the forward logits, the loss and every grad against the unsharded port
  (logits and grads rtol 1e-4 and atol 1e-5 of the largest value, the
  loss rtol 1e-5: ``tests/test_torch_mesh.py``'s) and against the JAX
  package's (computed by the JAX process from the same weights; the loss
  rtol 1e-4);
- the mLSTM block alone at ``chunk=32`` (the chunkwise form, 4 chunks):
  its output against the unsharded block and the JAX package's
  ``mlstm_apply(chunk=32)``, and the grads of its params and input under
  a seeded upstream grad against the unsharded block's;
- one train step with ``seq_parallel`` (the sequence split over
  ``model``), 2 microbatches and per-group remat: the loss and the grads
  (AdamW's first moment after the step) against the unsharded port's same
  step;
- the prefill's logits (rtol 1e-5, atol 1e-5 of the largest) and greedy
  tokens, and ``generate``'s tokens, equal to the unsharded port's;
- inside the mLSTM core each rank's v block is its heads' value columns
  (B/dp, S, H/tp, D) or its head's D/g columns (B/dp, S, 1, D/g), and
  no all-gather inside ``layers._mlstm_block`` has the bytes of v with
  every head; no all-gather of the forward and backward, the prefill or
  ``generate`` is of a whole (d, d) or (d, 4d) sLSTM gate weight, nor in
  the train step inside an xLSTM block (its loss gathers (B/2 · S, d)
  hidden rows, (256, 256) here);
- the prefill's FLOPs per rank (counted with ``FlopCounterMode`` on the
  local blocks) are the unsharded prefill's over the ranks plus the
  scores that the g ranks of a head's group each form (2%), and a mutant
  mLSTM block that makes the heads whole (the parent's path) fails that
  wherever the model axis has more than one rank.

    python tests/test_torch_xlstm_mesh.py <rank> <world> <dir> <port>
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
MESHES = ((2, 2), (1, 4), (4, 1))
B, S = 4, 128
CHUNK = 32                  # the block alone: S / CHUNK chunks
PROMPT, NEW = 8, 4          # generate's prompt and new tokens
MESH_TOL = dict(rtol=1e-4, atol=1e-5)   # atol: of the largest |value|
PREFILL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL, REF_LOSS_RTOL = 1e-5, 1e-4
# leaves whose grad is zero in exact arithmetic: a shift of every log
# input gate cancels in the mLSTM's stabilised normaliser, and its float32
# grad is noise (~1e-8 against grads of ~1e-3), so its atol is taken of
# the largest grad of the whole tree, not of its own
NOISE_GRADS = ("b_igate",)
FLOPS_RTOL = 0.02
TIMEOUT = 600


def config(get_config):
    """The reduced float32 xlstm-350m (either package's ``get_config``),
    with 2 heads (``scaled_down`` alone gives one)."""
    return get_config("xlstm-350m").scaled_down(layers=2, width_div=4) \
        .replace(dtype="float32", num_heads=2, num_kv_heads=2, head_dim=128)


def batch_arrays(cfg) -> dict:
    """Seeded tokens and labels, and the mLSTM block's input (B, S, d) and
    upstream grad, as numpy arrays."""
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
            "x": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "dy": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)}


def closed_form_flops(cfg, flops0: float, dp: int, tp: int) -> float:
    """The prefill's FLOPs a rank: the unsharded prefill's over the ranks,
    plus the part of each mLSTM head's scores (q kᵀ, 2·S·S·D a batch row,
    the quadratic form at S <= 256) that each of the g = tp/H ranks
    sharing the head forms whole, where its share would be 1/g."""
    H = cfg.num_heads
    D = int(cfg.proj_factor * cfg.d_model) // H
    g = max(tp // H, 1)
    mlstm = cfg.block_pattern.count("mlstm") * cfg.num_layers \
        // len(cfg.block_pattern)
    extra = mlstm * 2 * (B // dp) * S * S * D * (1 - 1 / g)
    return flops0 / (dp * tp) + extra


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
    from repro_torch.sharding.dtensor import keep_dims, on_local
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
    cfg = config(get_config)
    d, up, H = cfg.d_model, int(cfg.proj_factor * cfg.d_model), cfg.num_heads
    D = up // H

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def close(got, want, tol, top=None) -> bool:
        got, want = whole(got).detach(), torch.as_tensor(want)
        if top is None:
            top = float(want.abs().max()) if want.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=tol["rtol"],
                                   atol=tol["atol"] * top))

    def differ(got: dict, want: dict) -> list:
        """The names of the grads in ``got`` not close to ``want``'s."""
        top = max(float(torch.as_tensor(w).abs().max())
                  for w in want.values())
        return [k for k in got if not close(
            got[k], want[k], MESH_TOL,
            top if k.endswith(NOISE_GRADS) else None)]

    def loss_and_grads(params, batch, act=None):
        flat = tree_leaves_with_path(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        with torch.enable_grad():
            loss, _ = make_loss_fn(cfg, act)(
                _unflat(zip((k for k, _ in flat), leaves)), batch)
            grads = torch.autograd.grad(loss, leaves)
        return whole(loss.detach()), {path_str(k): g for (k, _), g in
                                      zip(flat, grads)}

    def block(bparams, x, dy):
        """The mLSTM block at ``CHUNK`` -> (output, {name: grad})."""
        flat = tree_leaves_with_path(bparams)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y, _ = L.mlstm_apply(_unflat(zip((k for k, _ in flat), leaves)),
                                 x, cfg, chunk=CHUNK)
            grads = torch.autograd.grad(y, [*leaves, x], dy)
        return y.detach(), {**{path_str(k): g for (k, _), g in
                               zip(flat, grads)}, "x": grads[-1]}

    def weight_gathers(cost) -> list:
        """All-gathers of a whole (d, d) or (d, 4d) sLSTM gate weight."""
        return [list(s) for s, _ in cost.gathers
                if tuple(s) in ((d, d), (d, 4 * d))]

    def forward(params, batch, act=None):
        with torch.no_grad():
            return T.forward(params, cfg, batch["tokens"],
                             act_sharding=act)[0]

    # the mLSTM block and core, recorded: the gathers inside the block
    # and the v block each core call is given
    mblock, seq, chunked = L._mlstm_block, L.mlstm_sequence, L._mlstm_chunked
    seen: dict = {"cost": None, "v": [], "gathers": [], "blocks": []}

    def recording_block(*a):
        cost = seen["cost"]
        n = len(cost.gathers) if cost else 0
        out = seen.get("block", mblock)(*a)
        if cost:
            seen["gathers"] += [b for _, b in cost.gathers[n:]]
        return out

    def recording_seq(q, k, v, *a):
        seen["v"].append(list(v.shape))
        return seq(q, k, v, *a)

    def recording_chunked(q, k, v, *a):
        seen["v"].append(list(v.shape))
        return chunked(q, k, v, *a)

    def heads_local(fn, q, *rest):
        """The parent's ``layers._heads_local``: every input split as q
        over batch and heads where all split them alike, else whole over
        the heads."""
        if not hasattr(q, "placements"):
            return fn(q, *rest)
        lay = keep_dims(q, (0, 2))
        if any(keep_dims(t, (0, 2)) != lay for t in rest):
            lay = keep_dims(q, (0,))
        return on_local(fn, (q, *rest), (lay,) * (1 + len(rest)), lay)

    def whole_heads(params, u1, cfg, chunk):
        """The parent's mLSTM block: its heads made whole where they do not
        split as the gates do."""
        q, k, v, logi, logf = L._mlstm_qkv(params, u1, cfg)
        core = seq if u1.shape[1] <= chunk else \
            (lambda *ts: chunked(*ts, chunk))
        out = heads_local(core, q, k, v, logi, logf)
        return L.merge_heads(L.rmsnorm(params["out_norm"], out,
                                       cfg.norm_eps))

    def in_blocks(apply):
        """``apply`` (an xLSTM block), its forward's gathers recorded."""
        def fn(*a, **kw):
            cost = seen["cost"]
            n = len(cost.gathers) if cost else 0
            res = apply(*a, **kw)
            if cost:
                seen["blocks"] += [list(s) for s, _ in cost.gathers[n:]]
            return res
        return fn

    applies = dict(T.RECURRENT_APPLY)
    L._mlstm_block, L.mlstm_sequence, L._mlstm_chunked = \
        recording_block, recording_seq, recording_chunked
    T.RECURRENT_APPLY.update({k: in_blocks(f) for k, f in applies.items()})
    out: dict = {}
    try:
        params = T.init_params(cfg, seed=0, device="cpu")
        arrays = batch_arrays(cfg)
        batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens",
                                                          "labels")}
        x, dy = (torch.from_numpy(arrays[k]) for k in ("x", "dy"))
        bparams = params["blocks"]["b0_mlstm"]
        bparams = {k: (v[0] if isinstance(v, torch.Tensor) else
                       {n: t[0] for n, t in v.items()})
                   for k, v in bparams.items()}
        prompt = batch["tokens"][:, :PROMPT]
        logits0 = forward(params, batch)
        loss0, grads0 = loss_and_grads(params, batch)
        block0, bgrads0 = block(bparams, x, dy)
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
        out["plain"] = (loss0, logits0, grads0, block0)
        for name, (shape, mesh) in meshes.items():
            dp, tp = shape
            g = max(tp // H, 1)
            part = Partitioner(cfg, mesh)
            dparams = shard_tree(params, part.param_shardings(params))
            tok = part.tokens_sharding(B)
            dbatch = {k: tok.distribute(v) for k, v in batch.items()}
            act = act_layout(cfg, mesh, B)
            seen["v"], seen["gathers"] = [], []
            with CostMode() as cost:
                seen["cost"] = cost
                logits = forward(dparams, dbatch, act)
                loss, grads = loss_and_grads(dparams, dbatch, act)
            seen["cost"] = None
            v_bytes = B // dp * S * up * 4
            r = out[name] = {
                "logits": close(logits, logits0, MESH_TOL),
                "loss": [float(loss), float(loss0)],
                "grads": differ(grads, grads0),
                "v_blocks": sorted({tuple(s) for s in seen["v"]}),
                "want_v": [B // dp, S, max(H // tp, 1), D // g],
                "v_gathers": [b for b in seen["gathers"] if b == v_bytes],
                "weight_gathers": weight_gathers(cost)}
            # the block alone, chunkwise
            dbp = shard_tree(bparams, part.param_shardings(bparams))
            seen["v"] = []
            y, bgrads = block(dbp, act.distribute(x), act.distribute(dy))
            r["block"] = close(y, block0, MESH_TOL)
            r["block_v"] = sorted({tuple(s) for s in seen["v"]})
            r["block_grads"] = differ(bgrads, bgrads0)
            # seq_parallel, 2 microbatches, per-group remat
            state = init_train_state(rcfg, seed=0, device="cpu")
            sh = part.state_shardings(state)
            dstate = shard_tree(state, sh)
            seen["blocks"] = []
            with CostMode() as cost:
                seen["cost"] = cost
                metrics = make_train_step(
                    rcfg, microbatches=2, grad_shardings=sh["opt"]["mu"],
                    act_sharding=act_layout(cfg, mesh, B // 2, True))(
                        dstate, dbatch)[1]
            seen["cost"] = None
            # (its loss gathers the microbatch's (B/2 · S, d) hidden rows,
            # (256, 256) here: only the blocks' gathers are weighed)
            r["weight_gathers"] += [s for s in seen["blocks"]
                                    if tuple(s) in ((d, d), (d, 4 * d))]
            r["sp_loss"] = [float(metrics["loss"]), float(step0["loss"])]
            r["sp_grads"] = differ(*(
                {path_str(k): m for k, m in tree_leaves_with_path(
                    st["opt"]["mu"])} for st in (dstate, state0)))
            # prefill, its FLOPs and those of the mutant block
            with CostMode() as cost:
                got = make_prefill_step(cfg, act)(dparams, dbatch)
            pre = whole(got)
            r["prefill"] = close(pre, prefill0, PREFILL_TOL) and bool(
                torch.equal(pre.argmax(-1), prefill0.argmax(-1)))
            r["flops"] = [cost.flops,
                          closed_form_flops(cfg, flops0, dp, tp)]
            r["weight_gathers"] += weight_gathers(cost)
            seen["block"] = whole_heads
            try:
                with CostMode() as cost:
                    mutant = make_prefill_step(cfg, act)(dparams, dbatch)
            finally:
                seen.pop("block")
            r["mutant_flops"] = cost.flops
            r["mutant_prefill"] = close(mutant, prefill0, PREFILL_TOL)
            # generate on the mesh
            with CostMode() as cost:
                gm = generate(
                    cfg, dparams, tok.distribute(prompt), NEW,
                    act_sharding=act, cache_layouts=serve_cache_layouts(
                        cfg, mesh, T.init_cache(cfg, B, PROMPT + NEW,
                                                device="meta")))
            r["generate"] = bool(torch.equal(gm, gen0))
            r["weight_gathers"] += weight_gathers(cost)
            out[name + "/state"] = (loss, logits, grads, y)
    finally:
        L._mlstm_block, L.mlstm_sequence, L._mlstm_chunked = \
            mblock, seq, chunked
        T.RECURRENT_APPLY.update(applies)
    # the JAX package's results, written beside this run
    ref_path = os.path.join(directory, "ref.npz")
    deadline = time.time() + TIMEOUT
    while not os.path.exists(ref_path) and time.time() < deadline:
        if os.path.exists(os.path.join(directory, "ref.failed")):
            break
        time.sleep(0.2)
    ref = dict(np.load(ref_path)) if os.path.exists(ref_path) else {}
    for key in [k for k in out if "/" in k or k == "plain"]:
        loss, logits, grads, y = out.pop(key)
        mesh = key.split("/")[0]
        if not ref:
            out.setdefault(mesh, {})["ref"] = "missing"
            continue
        got = {"loss": abs(float(loss) - float(ref["loss"]))
               <= REF_LOSS_RTOL * abs(float(ref["loss"])),
               "logits": close(logits, ref["logits"], MESH_TOL),
               "block": close(y, ref["block"], MESH_TOL),
               "grads": differ(grads, {k: ref[f"grad/{k}"]
                                       for k in grads})}
        if key == "plain":
            out["plain_ref"] = got
        else:
            out[mesh]["ref"] = got
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------- the JAX package
REF = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_xlstm_mesh import CHUNK, batch_arrays, config
from repro.configs import get_config
from repro.models import layers as JL, transformer as JT
from repro.train.steps import make_loss_fn
import repro_torch.configs as port_configs
from repro_torch.core.serialization import path_str, state_to_numpy
from repro_torch.models import transformer as T
try:
    jc = config(get_config)
    params = jax.tree.map(jnp.asarray, state_to_numpy(T.init_params(
        config(port_configs.get_config), seed=0, device="cpu")))
    arrays = batch_arrays(jc)
    b = {k: jnp.asarray(arrays[k]) for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: make_loss_fn(jc)(p, b)[0]))(params)
    logits, _ = jax.jit(lambda p: JT.forward(p, jc, b["tokens"]))(params)
    bp = jax.tree.map(lambda t: t[0], params["blocks"]["b0_mlstm"])
    block = jax.jit(lambda p, x: JL.mlstm_apply(p, x, jc, chunk=CHUNK)[0])(
        bp, jnp.asarray(arrays["x"]))
    out = {"loss": np.asarray(loss), "logits": np.asarray(logits),
           "block": np.asarray(block)}
    for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["grad/" + path_str(k.key for k in p)] = np.asarray(g)
    np.savez(os.path.join(sys.argv[1], "ref.tmp.npz"), **out)
    os.replace(os.path.join(sys.argv[1], "ref.tmp.npz"),
               os.path.join(sys.argv[1], "ref.npz"))
except BaseException:
    open(os.path.join(sys.argv[1], "ref.failed"), "w").close()
    raise
print("REF-OK")
"""


def test_xlstm_blocks_split_over_model(tmp_path):
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
        plain = res["plain_ref"]
        assert plain["loss"] and plain["logits"] and plain["block"] and \
            not plain["grads"], (r, plain)
        for shape in MESHES:
            mesh = "x".join(map(str, shape))
            c, where = res[mesh], f"rank {r} {mesh}"
            assert c["logits"], where
            np.testing.assert_allclose(*c["loss"], rtol=LOSS_RTOL,
                                       err_msg=where)
            assert c["grads"] == [], (where, c["grads"])
            ref = c["ref"]
            assert ref["loss"] and ref["logits"] and ref["block"] and \
                not ref["grads"], (where, ref)
            assert c["block"] and c["block_grads"] == [], (where, c)
            np.testing.assert_allclose(*c["sp_loss"], rtol=LOSS_RTOL,
                                       err_msg=where)
            assert c["sp_grads"] == [], (where, c["sp_grads"])
            assert c["prefill"] and c["generate"], (where, c)
            assert c["v_blocks"] == c["block_v"] == [c["want_v"]], \
                (where, c)
            assert c["v_gathers"] == [], (where, c["v_gathers"])
            assert c["weight_gathers"] == [], (where, c["weight_gathers"])
            flops, want = c["flops"]
            assert abs(flops - want) <= FLOPS_RTOL * want, \
                (where, flops, want)
            assert c["mutant_prefill"], where
            if shape[1] > 1:
                assert c["mutant_flops"] > (1 + FLOPS_RTOL) * want, \
                    (where, c["mutant_flops"], want)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
