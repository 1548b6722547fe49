"""The train step's loss split over ``model`` and each microbatch kept on its
``data`` shard, on 2x2, 1x4 and 4x1 gloo meshes of CPU processes, held
against the unsharded port and the JAX package.

One launch of 4 worker processes (this file, run as a script) beside one
JAX process takes five reduced float32 configs (``configs``) through each
mesh:

- ``qwen``: qwen2.5-3b, tied embeddings, vocab 512 (split 2 or 4 ways);
- ``gemma``: gemma2-9b, tied, with ``final_softcap``;
- ``olmoe``: olmoe-1b-7b, untied: the ``head`` (d, V) split on V;
- ``qwen510``: qwen2.5-3b at vocab 510, which a model axis of 4 does not
  divide: the Partitioner splits the tied table on d there (the rule
  internvl2-26b's 92,553 takes) and the logits are made whole over
  ``model``; on 2x2 the 255-row blocks split the vocab;
- ``internvl``: internvl2-26b at vocab 510, untied: its head is whole
  over a model axis of 4 (its guard), split over one of 2.

Each worker checks, on every rank:

- ``chunked_cross_entropy`` (2 chunks of ``CHUNK``) of seeded hidden
  states and labels, the labels including every rank's lo - 1, lo and
  hi - 1 for a vocab split 2 and 4 ways: the loss and the grads of h and
  of the table (``embed`` or ``head``) against the unsharded port and the
  JAX package's jitted ``chunked_cross_entropy`` (``TOL``: rtol 1e-5,
  atol 1e-5 of the largest value, ``tests/test_torch_mesh.py``'s);
- where the table splits the vocab over a model axis of more than one
  rank, no all-gather in that loss's forward and backward has a chunk's
  whole-vocab logits of the rank's rows (rows x chunk x V elements) or a
  last dim of V; the parent's loss (``old_chunked_cross_entropy``: the
  logits made whole over ``model``, then ``logsumexp`` and ``gather``)
  fails that check;
- ``token_nll`` of the unsharded logits laid out with the vocab split
  where it divides: the nll and its grad under a seeded upstream grad
  against the unsharded ``token_nll``, equal to the last bit where the
  vocab group is one rank (4x1), within ``TOL`` elsewhere; and unsharded,
  against the plain ``cross_entropy`` composition (rtol 1e-6);
- on 2x2, a train step of the reduced qwen (2 layers) with 2
  microbatches: its loss and AdamW's first moment (the grads) against the
  unsharded port's same step, each microbatch's tokens reaching the lookup
  as the rank's (B/2/dp, S) block, no all-gather of a microbatch's
  whole (B/2, S, d) activation or of whole-vocab logits; the parent's
  slicing (``old_microbatches``: the microbatch left whole on every rank)
  fails that.

``test_production_qwen_train_keeps_the_loss_split`` is the dry-run gate:
qwen2.5-3b at full width and vocab cut to 2 of 36 layers, ``train_4k`` on
16x16 (16 microbatches): a peak of at most ``PEAK_LIMIT`` a device (the
parent: 12,910,838,704 B) and no all-gather of a chunk's whole-vocab
logits or of a microbatch's whole activation.

    python tests/test_torch_ce_mesh.py <rank> <world> <dir> <port>
"""

import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESHES = ((2, 2), (1, 4), (4, 1))
B, S, CHUNK = 4, 64, 32
TOL = dict(rtol=1e-5, atol=1e-5)        # atol: of the largest |value|
PLAIN_RTOL = 1e-6                       # token_nll vs cross_entropy
MICROBATCHES = 2
TIMEOUT = 600
# the dry-run gate: qwen2.5-3b train_4k on 16x16 at 2 of 36 layers
GATE_LAYERS = 2
PEAK_LIMIT = 1.0e9


def configs(get_config) -> dict:
    """The five reduced float32 configs (either package's ``get_config``)."""
    def narrow(arch, vocab=512):
        return get_config(arch).scaled_down(
            layers=2, width_div=8, vocab=vocab).replace(dtype="float32")
    return {"qwen": narrow("qwen2.5-3b"), "gemma": narrow("gemma2-9b"),
            "olmoe": narrow("olmoe-1b-7b"),
            "qwen510": narrow("qwen2.5-3b", 510),
            "internvl": narrow("internvl2-26b", 510)}


def table_key(cfg) -> str:
    return "embed" if cfg.tie_embeddings else "head"


def boundaries(V: int) -> list[int]:
    """Every rank's lo - 1, lo and hi - 1 of a vocab split 2 and 4 ways
    (torch.chunk's blocks), within [0, V)."""
    out = set()
    for tp in (2, 4):
        size = -(-V // tp)
        for r in range(tp):
            lo, hi = r * size, min((r + 1) * size, V)
            out |= {lo - 1, lo, hi - 1}
    return sorted(v for v in out if 0 <= v < V)


def arrays(cfg) -> dict:
    """Seeded hidden states, labels (the vocab's split boundaries first),
    the token_nll upstream grad and the train step's tokens, as numpy."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, cfg.vocab_size, (B * S,))
    edge = boundaries(cfg.vocab_size)
    labels[:len(edge)] = edge
    return {"h": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32),
            "labels": labels.reshape(B, S).astype(np.int32),
            "dy": rng.standard_normal((B, S)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


def logits_gathers(shapes, rows: int, V: int) -> list:
    """The all-gather result shapes that hold a chunk's whole-vocab logits
    of ``rows`` rows, or whose last dim is V."""
    return [list(s) for s in shapes
            if s and (s[-1] == V or math.prod(s) == rows * CHUNK * V)]


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
    from repro_torch.core.serialization import path_str, \
        tree_leaves_with_path
    from repro_torch.launch.dryrun import CostMode, act_layout
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.dtensor import constrain
    from repro_torch.sharding.partition import Layout, Partitioner, \
        shard_tree
    from repro_torch.train import steps
    from repro_torch.train.steps import (chunked_cross_entropy,
                                         cross_entropy, init_train_state,
                                         make_train_step, token_nll)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    torch.set_num_threads(1)
    meshes = {"x".join(map(str, s)): (s, make_host_mesh(*s, device="cpu"))
              for s in MESHES}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def close(got, want, rtol=TOL["rtol"], atol=TOL["atol"]) -> bool:
        got, want = whole(got).detach(), torch.as_tensor(want)
        top = float(want.abs().max()) if want.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=rtol, atol=atol * top))

    def old_chunked_cross_entropy(params, cfg, h, labels, chunk, act):
        """The parent's loss: each chunk's logits made whole over
        ``model`` (``act``, the residual stream's layout), then
        ``logsumexp`` and ``gather``."""
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for a in range(0, h.shape[1], chunk):
            logits = constrain(T._unembed(params, cfg, h[:, a:a + chunk]),
                               act)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[:, a:a + chunk].long()
                                [..., None])[..., 0]
            total = total + torch.sum(lse - gold)
        return total / (h.shape[0] * h.shape[1])

    def old_microbatches(batch, microbatches):
        """The parent's slicing: a slice of the split batch, whole on
        every rank."""
        n = next(iter(batch.values())).shape[0] // microbatches
        return [{k: v[m * n:(m + 1) * n] for k, v in batch.items()}
                for m in range(microbatches)]

    def loss_grads(params, cfg, h, labels, loss_fn=None):
        """The loss and the grads of h and of the table."""
        key = table_key(cfg)
        h = h.detach().requires_grad_(True)
        table = params[key].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = (loss_fn or (lambda *a: chunked_cross_entropy(
                *a, chunk=CHUNK)))({**params, key: table}, cfg, h, labels)
            gh, gt = torch.autograd.grad(loss, (h, table))
        return whole(loss.detach()), gh, gt

    def nll_grad(logits, labels, dy):
        x = logits.detach().requires_grad_(True)
        with torch.enable_grad():
            nll = token_nll(x, labels)
            g, = torch.autograd.grad(nll, x, dy)
        return nll.detach(), g

    out: dict = {}
    cfgs = configs(get_config)
    for name, cfg in cfgs.items():
        a = arrays(cfg)
        full = T.init_params(cfg, seed=0, device="cpu")
        params = {k: full[k] for k in ("final_norm", "embed", "head")
                  if k in full}
        h, labels, dy = (torch.from_numpy(a[k]) for k in ("h", "labels",
                                                            "dy"))
        loss0, gh0, gt0 = loss_grads(params, cfg, h, labels)
        with torch.no_grad():
            logits0 = torch.cat([T._unembed(params, cfg, h[:, i:i + CHUNK])
                                 for i in range(0, S, CHUNK)], dim=1)
        nll0, gnll0 = nll_grad(logits0, labels, dy)
        # the Function against the plain composition
        x = logits0.clone().requires_grad_(True)
        with torch.enable_grad():
            ce = cross_entropy(x, labels)
            gce, = torch.autograd.grad(ce, x)
            mine = torch.mean(token_nll(x, labels))
            gmine, = torch.autograd.grad(mine, x)
        out[f"{name}/plain"] = {
            "composition": close(mine, ce, PLAIN_RTOL, 0.0) and close(
                gmine, gce, PLAIN_RTOL, PLAIN_RTOL),
            "loss": float(loss0)}
        out[f"{name}/unsharded"] = (loss0, gh0, gt0)
        for mname, (shape, mesh) in meshes.items():
            dp, tp = shape
            part = Partitioner(cfg, mesh)
            dparams = shard_tree(params, part.param_shardings(params))
            act = act_layout(cfg, mesh, B)
            dh = act.distribute(h)
            dlabels = part.tokens_sharding(B).distribute(labels)
            with CostMode() as cost:
                loss, gh, gt = loss_grads(dparams, cfg, dh, dlabels)
            split = cfg.vocab_size % tp == 0 and tp > 1
            r = out[f"{name}/{mname}"] = {
                "loss": [float(loss), float(loss0)],
                "gh": close(gh, gh0), "gt": close(gt, gt0),
                "vocab_split": split,
                "gathers": logits_gathers((s for s, _ in cost.gathers),
                                          B // dp, cfg.vocab_size)}
            with CostMode() as cost:
                old = loss_grads(dparams, cfg, dh, dlabels, lambda *a:
                                 old_chunked_cross_entropy(*a, CHUNK, act))
            r["old_loss"] = close(old[0], loss0)
            r["old_gathers"] = logits_gathers(
                (s for s, _ in cost.gathers), B // dp, cfg.vocab_size)
            # token_nll on the unsharded logits at the vocab's split
            spec = (("data",), None, "model" if cfg.vocab_size % tp == 0
                    else None)
            dl = Layout(mesh, spec).distribute(logits0)
            rows = part.tokens_sharding(B)
            nll, gnll = nll_grad(dl, rows.distribute(labels),
                                 rows.distribute(dy))
            nll, gnll = whole(nll), whole(gnll)
            r["nll_bits"] = bool(torch.equal(nll, nll0)) and bool(
                torch.equal(gnll, gnll0))
            r["nll_close"] = close(nll, nll0) and close(gnll, gnll0)
            out[f"{name}/{mname}/state"] = (loss, gh, gt)

    # a 2-microbatch train step of the reduced qwen on 2x2
    cfg = cfgs["qwen"]
    a = arrays(cfg)
    batch = {"tokens": torch.from_numpy(a["tokens"]),
             "labels": torch.from_numpy(a["labels"])}
    state0 = init_train_state(cfg, seed=0, device="cpu")
    step0 = make_train_step(cfg, microbatches=MICROBATCHES)(state0, batch)[1]
    (dp, tp), mesh = meshes["2x2"]
    part = Partitioner(cfg, mesh)
    lookup, seen = T._lookup, []

    def recording_lookup(table, tokens):
        seen.append(list(tokens.to_local().shape))
        return lookup(table, tokens)

    n = B // MICROBATCHES
    step = {}
    T._lookup = recording_lookup
    try:
        for tag, split in (("step", steps.microbatches_of),
                           ("old_step", old_microbatches)):
            state = init_train_state(cfg, seed=0, device="cpu")
            sh = part.state_shardings(state)
            dstate = shard_tree(state, sh)
            tok = part.tokens_sharding(B)
            dbatch = {k: tok.distribute(v) for k, v in batch.items()}
            seen.clear()
            saved, steps.microbatches_of = steps.microbatches_of, split
            try:
                with CostMode() as cost:
                    metrics = make_train_step(
                        cfg, microbatches=MICROBATCHES,
                        grad_shardings=sh["opt"]["mu"],
                        act_sharding=act_layout(cfg, mesh, n))(
                            dstate, dbatch)[1]
            finally:
                steps.microbatches_of = saved
            mu = {path_str(k): m for k, m in tree_leaves_with_path(
                dstate["opt"]["mu"])}
            want = {path_str(k): m for k, m in tree_leaves_with_path(
                state0["opt"]["mu"])}
            top = max(float(w.abs().max()) for w in want.values())
            gathers = [s for s, _ in cost.gathers]
            step[tag] = {
                "loss": [float(metrics["loss"]), float(step0["loss"])],
                "mu": [k for k in mu if not bool(torch.allclose(
                    whole(mu[k]), want[k], rtol=TOL["rtol"],
                    atol=TOL["atol"] * top))],
                "lookup": sorted({tuple(s) for s in seen}),
                "gathers": logits_gathers(gathers, n // dp, cfg.vocab_size)
                + [list(s) for s in gathers
                   if math.prod(s) == n * S * cfg.d_model]}
    finally:
        T._lookup = lookup
    out["train"] = dict(step, want_lookup=[n // dp, S])

    # the JAX package's results, written beside this run
    ref_path = os.path.join(directory, "ref.npz")
    deadline = time.time() + TIMEOUT
    while not os.path.exists(ref_path) and time.time() < deadline:
        if os.path.exists(os.path.join(directory, "ref.failed")):
            break
        time.sleep(0.2)
    ref = dict(np.load(ref_path)) if os.path.exists(ref_path) else {}
    for key in [k for k in out if k.endswith(("/unsharded", "/state"))]:
        loss, gh, gt = out.pop(key)
        name = key.split("/")[0]
        where = key.rsplit("/", 1)[0]
        if not ref:
            out[where + "/ref"] = "missing"
            continue
        out[where + "/ref"] = {
            "loss": close(loss, ref[f"{name}/loss"]),
            "gh": close(gh, ref[f"{name}/gh"]),
            "gt": close(gt, ref[f"{name}/gt"])}
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------- the JAX package
REF = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
from test_torch_ce_mesh import CHUNK, arrays, configs, table_key
from repro.configs import get_config
from repro.train.steps import chunked_cross_entropy
import repro_torch.configs as port_configs
from repro_torch.core.serialization import state_to_numpy
from repro_torch.models import transformer as T
try:
    out = {}
    ports = configs(port_configs.get_config)
    for name, jc in configs(get_config).items():
        full = state_to_numpy(T.init_params(ports[name], seed=0,
                                            device="cpu"))
        params = {k: jax.tree.map(jnp.asarray, full[k])
                  for k in ("final_norm", "embed", "head") if k in full}
        a = arrays(jc)
        key = table_key(jc)

        def loss(h, table, params=params, jc=jc, key=key, labels=jnp.asarray(
                a["labels"])):
            return chunked_cross_entropy({**params, key: table}, jc, h,
                                         labels, chunk=CHUNK)
        val, (gh, gt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            jnp.asarray(a["h"]), params[key])
        out[f"{name}/loss"] = np.asarray(val)
        out[f"{name}/gh"] = np.asarray(gh)
        out[f"{name}/gt"] = np.asarray(gt)
    np.savez(os.path.join(sys.argv[1], "ref.tmp.npz"), **out)
    os.replace(os.path.join(sys.argv[1], "ref.tmp.npz"),
               os.path.join(sys.argv[1], "ref.npz"))
except BaseException:
    open(os.path.join(sys.argv[1], "ref.failed"), "w").close()
    raise
print("REF-OK")
"""


def test_loss_split_over_model_and_microbatches_over_data(tmp_path):
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
        for name in ("qwen", "gemma", "olmoe", "qwen510", "internvl"):
            assert res[f"{name}/plain"]["composition"], (r, name)
            ref = res[f"{name}/ref"]
            assert ref["loss"] and ref["gh"] and ref["gt"], (r, name, ref)
            for shape in MESHES:
                mesh = "x".join(map(str, shape))
                c, where = res[f"{name}/{mesh}"], f"rank {r} {name} {mesh}"
                np.testing.assert_allclose(*c["loss"], rtol=TOL["rtol"],
                                           err_msg=where)
                assert c["gh"] and c["gt"], (where, c)
                ref = res[f"{name}/{mesh}/ref"]
                assert ref["loss"] and ref["gh"] and ref["gt"], (where, ref)
                assert c["nll_close"], where
                if shape[1] == 1:
                    assert c["nll_bits"], where
                assert c["old_loss"], where
                if c["vocab_split"]:
                    assert c["gathers"] == [], (where, c["gathers"])
                    assert c["old_gathers"], where     # the mutant fails
        train = res["train"]
        for tag in ("step", "old_step"):
            np.testing.assert_allclose(*train[tag]["loss"], rtol=TOL["rtol"],
                                       err_msg=f"rank {r} {tag}")
            assert train[tag]["mu"] == [], (r, tag, train[tag]["mu"])
        assert train["step"]["lookup"] == [train["want_lookup"]], \
            (r, train["step"]["lookup"])
        assert train["step"]["gathers"] == [], (r, train["step"]["gathers"])
        # the parent's slicing looks every microbatch up whole
        assert train["old_step"]["lookup"] != [train["want_lookup"]] and \
            train["old_step"]["gathers"], (r, train["old_step"])


GATE = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import measure_cell
from repro_torch.models.config import SHAPES_BY_NAME
cfg = get_config("qwen2.5-3b").replace(num_layers=int(sys.argv[2]))
rec = measure_cell(cfg, SHAPES_BY_NAME["train_4k"], (16, 16),
                   ("data", "model"))
json.dump(rec, open(sys.argv[1], "w"))
print("GATE-OK")
"""


def test_production_qwen_train_keeps_the_loss_split(tmp_path):
    """qwen2.5-3b ``train_4k`` on 16x16 at full width and vocab, 2 of 36
    layers, the reference's 16 microbatches (16 rows each, one a data
    rank): a peak of at most ``PEAK_LIMIT`` a device (the parent: 12.91 GB,
    two whole-microbatch whole-vocab (16, 512, 151936) float32 grads of
    the gold logit's gather and every chunk's logits made whole over
    ``model``), no all-gather of a chunk's whole-vocab logits of the
    rank's row, and none of a microbatch's whole (16, 4096, d)
    activation."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    path = tmp_path / "gate.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", GATE, str(path),
                        str(GATE_LAYERS)], env=env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert p.returncode == 0 and "GATE-OK" in p.stdout, \
        (p.stdout + p.stderr)[-4000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["microbatches"] == 16, \
        rec.get("traceback")
    cfg, shape = get_config("qwen2.5-3b"), SHAPES_BY_NAME["train_4k"]
    pd = rec["per_device"]
    assert pd["peak_hbm_bytes"] <= PEAK_LIMIT, pd["peak_hbm_bytes"]
    n = shape.global_batch // 16
    shapes = pd["all_gather_shapes"]
    whole_vocab = [list(s) for s in shapes if s[-1] == cfg.vocab_size
                   or math.prod(s) == n // 16 * 512 * cfg.vocab_size]
    assert whole_vocab == [], whole_vocab
    whole_rows = [list(s) for s in shapes
                  if math.prod(s) == n * shape.seq_len * cfg.d_model]
    assert whole_rows == [], whole_rows


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
