"""Step factories: training (forward, backward and AdamW on one device),
prefill and serving.

Counterpart of ``repro/train/steps.py``. ``make_train_step`` returns a
function ``train_step(state, batch) -> (state, metrics)`` that updates
``state`` IN PLACE (params, moments, counters) — the reference donates its
state buffers to the jitted step instead. Gradients come from
``torch.autograd.grad`` over detached aliases of the params, so nothing is
left attached to the state between steps; grads of bf16 params are bf16 as
in the reference. Under a mesh the state and batch are DTensors:
``act_sharding`` (a ``sharding.partition.Layout``) is the residual stream's
layout, which the forward redistributes to at the embed and after every
block; the logits keep the table's split of the vocab over ``model``
through the cross-entropy (``token_nll``), and each microbatch the batch's
split over the data axes (``microbatches_of``); ``grad_shardings`` (a
tree of layouts, the moments' under ZeRO-1) is where each grad is
redistributed to before the update (ZeRO-2; without it, to its param's
layout). The loss comes back whole on every rank.
``make_prefill_step`` and ``make_serve_step`` run under
``torch.inference_mode()`` (on a mesh under ``no_grad``: a DTensor view
made in inference mode fails, inference tensors having no version
counter): no remat, and the RG-LRU scan runs forward only.
``generate`` is the serving loop over ``make_serve_step``; on a mesh its
cache is laid out by the caller's ``cache_layouts``.
"""

from __future__ import annotations

import time

import torch

from ..core.serialization import tree_leaves_with_path
from ..models import layers as L
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import AdamWConfig, apply_updates, init_state
from ..sharding.dtensor import (axis_group, constrain, is_dtensor, keep_dims,
                                like, mapped, model_axis, on_local,
                                replicate)

CE_CHUNK = 512  # sequence chunk for the unembed + cross-entropy loop


def cross_entropy(logits, labels):
    """logits (B,S,V) float32, labels (B,S) int -> scalar mean nll: the
    plain composition that ``token_nll`` is held against."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _all_reduce(t, op: str, group):
    """``t`` reduced by ``op`` over ``group`` (a functional collective, so
    that the dry run counts it); ``t`` itself where ``group`` is None."""
    if group is None:
        return t
    import torch.distributed._functional_collectives as fc
    return fc.wait_tensor(fc.all_reduce(t, op, group))


class _VocabNLL(torch.autograd.Function):
    """Per-token nll of (..., c) float32 logits, one rank's columns [lo, lo
    + c) of a vocab split over the ranks of ``group`` (None: the whole
    vocab): the row max, the sum of exponentials and the gold logit (the
    rank's column where the label lies in its range, 0 elsewhere) are
    all-reduced over the group, lse = max + log sum. The backward is
    local: (softmax - one-hot of the rank's columns) x the nll's grad,
    which every rank of the group holds whole."""

    @staticmethod
    def forward(ctx, x, labels, lo: int, group):
        m = _all_reduce(x.amax(dim=-1), "max", group)
        s = _all_reduce(torch.exp(x - m[..., None]).sum(dim=-1), "sum",
                        group)
        local = labels.long() - lo
        hit = (local >= 0) & (local < x.shape[-1])
        idx = local.clamp(0, x.shape[-1] - 1)
        gold = torch.where(hit, torch.gather(x, -1, idx[..., None])[..., 0],
                           0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, lse, idx, hit)
        return lse - _all_reduce(gold, "sum", group)

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, hit = ctx.saved_tensors
        grad = torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -hit.to(grad.dtype)[..., None])
        return grad.mul_(g[..., None]), None, None, None


def token_nll(logits, labels):
    """Per-token nll (B, S) of (B, S, V) float32 logits and (B, S) labels.
    Under a mesh it runs on the logits' local blocks as they lie: where
    the vocab is split over ``model`` (the table's rule), each rank's
    V/tp columns with the three reductions over ``model``; elsewhere the
    vocab made whole over ``model`` and the nll of each rank's rows. The
    nll keeps the logits' split of the batch (and sequence) dims."""
    if not is_dtensor(logits):
        return _VocabNLL.apply(logits, labels, 0, None)
    from torch.distributed.tensor import Replicate, Shard
    ax = model_axis(logits)
    model = None if ax is None else ax[0]
    lay = tuple(p if p.is_shard() and (p.dim < 2 or j == model)
                else Replicate() for j, p in enumerate(logits.placements))
    lo, group = 0, None
    if model is not None and lay[model] == Shard(2):
        _, tp, r = ax
        lo = r * -(-logits.shape[-1] // tp)     # torch.chunk's blocks
        group = axis_group(logits, model)
    rows = mapped(lay, {0: 0, 1: 1})
    return on_local(lambda x, y: _VocabNLL.apply(x, y, lo, group),
                    (logits, like(labels, logits)), (lay, rows), rows)


def chunked_cross_entropy(params, cfg: ModelConfig, h, labels,
                          chunk: int = CE_CHUNK):
    """Unembed + cross-entropy a sequence chunk at a time, so only
    (B, chunk, V) float32 logits are live in the forward pass; the
    unembedding's table is gathered and cast once for all chunks. Under a
    mesh each chunk's logits keep the table's split of the vocab
    (``token_nll``)."""
    B, S, _ = h.shape
    if S > chunk and S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of {chunk}")
    step = min(S, chunk)
    table = T.unembed_table(params, cfg, h.dtype)
    total = None
    for a in range(0, S, step):
        logits = T._unembed(params, cfg, h[:, a:a + step], table)
        part = torch.sum(token_nll(logits, labels[:, a:a + step]))
        total = part if total is None else total + part
    return total / (B * S)


def make_loss_fn(cfg: ModelConfig, act_sharding=None):
    def loss_fn(params, batch):
        h, aux = T.forward(params, cfg, batch["tokens"],
                           batch.get("frontend_embeds"), return_hidden=True,
                           act_sharding=act_sharding)
        S = batch["labels"].shape[1]
        nll = chunked_cross_entropy(params, cfg, h[:, -S:, :],
                                    batch["labels"])
        loss = nll + cfg.router_aux_coef * aux
        return loss, {"nll": nll, "aux": aux}
    return loss_fn


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """{"params", "opt", "step"} laid out as the reference's train state
    (``meta`` gives the layout without allocating)."""
    params = T.init_params(cfg, seed=seed, device=device)
    params = T.cast_params(params, L.dtype_of(cfg))
    return {"params": params, "opt": init_state(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=torch.device(device))}


def _unflat(items) -> dict:
    """[(key path, leaf)] -> nested dicts."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _whole(t):
    """A DTensor's value as a plain tensor on every rank."""
    return t.full_tensor() if is_dtensor(t) else t


def _split_as(t, ref):
    """``t``, whole rows of DTensor ``ref``, laid out as ``ref`` where its
    row count splits as evenly as ``ref``'s rows (each rank chunks its own
    block out: nothing is moved), else left whole; ``t`` itself off a
    mesh."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    ways = 1
    for i, p in enumerate(ref.placements):
        if p.is_shard(0):
            ways *= mesh.size(i)
    want = ref.placements if t.shape[0] % ways == 0 else replicate(ref)
    return t.redistribute(mesh, want)


def microbatches_of(batch: dict, microbatches: int) -> list[dict]:
    """The reference's contiguous microbatches of ``batch``: rows [m·n,
    (m+1)·n) for n = B / microbatches. Under a mesh each leaf is made
    whole once (one all-gather of the ids a step) and every microbatch
    takes the batch's own layout again, so the lookup, the blocks and the
    loss run on each rank's rows only."""
    n = next(iter(batch.values())).shape[0] // microbatches
    whole = {k: v.redistribute(v.device_mesh, replicate(v))
             if is_dtensor(v) else v for k, v in batch.items()}
    return [{k: _split_as(whole[k][m * n:(m + 1) * n], batch[k])
             for k in batch} for m in range(microbatches)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    microbatches: int = 1, grad_shardings=None,
                    act_sharding=None):
    """fwd + bwd + AdamW. ``microbatches`` > 1 accumulates float32 grads
    over that many contiguous slices of the batch (``microbatches_of``),
    so live activations are O(batch / microbatches). ``grad_shardings`` /
    ``act_sharding``: the layouts under a mesh (module docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg, act_sharding=act_sharding)

    targets = {} if grad_shardings is None else dict(tree_leaves_with_path(
        grad_shardings, is_leaf=lambda x: hasattr(x, "placements")))

    def place(key, g, p):
        """Grad ``g`` of param ``p`` at its layout for the update."""
        if not is_dtensor(g):
            return g
        if key in targets:
            return constrain(g, targets[key])
        return g.redistribute(p.device_mesh, p.placements)

    def grad_fn(params, batch):
        flat = tree_leaves_with_path(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        with torch.enable_grad():
            loss, extras = loss_fn(
                _unflat(zip((k for k, _ in flat), leaves)), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [place(k, torch.zeros_like(p) if g is None else g, p)
                 for (k, _), p, g in zip(flat, leaves, grads)]
        return (_whole(loss.detach()),
                {k: _whole(v.detach()) for k, v in extras.items()}), \
            _unflat(zip((k for k, _ in flat), grads))

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            (loss, extras), grads = grad_fn(params, batch)
        else:
            g_acc = _unflat((k, place(k, torch.zeros_like(
                p, dtype=torch.float32), p))
                for k, p in tree_leaves_with_path(params))
            l_acc = a_acc = 0.0
            for mb in microbatches_of(batch, microbatches):
                (l, ex), g = grad_fn(params, mb)
                for (_, acc), (_, gm) in zip(tree_leaves_with_path(g_acc),
                                             tree_leaves_with_path(g)):
                    acc.add_(gm.to(acc.dtype))
                l_acc = l_acc + l
                a_acc = a_acc + ex["aux"]
                del g
            inv = 1.0 / microbatches
            for _, acc in tree_leaves_with_path(g_acc):
                acc.mul_(inv)
            grads = g_acc
            loss = l_acc * inv
            extras = {"nll": loss, "aux": a_acc * inv}
        om = apply_updates(opt_cfg, params, grads, state["opt"])
        del grads
        state["step"].add_(1)
        return state, {"loss": loss, **extras, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, act_sharding=None):
    """Inference prefill: returns only the LAST position's logits (B,1,V)
    float32 — what the decoder needs to emit its first token.
    ``act_sharding``: the residual stream's layout under a mesh, where the
    prefill runs under ``no_grad`` (a DTensor view made in inference mode
    fails: inference tensors have no version counter)."""
    def prefill(params, batch):
        with torch.no_grad() if act_sharding is not None \
                else torch.inference_mode():
            h, _ = T.forward(params, cfg, batch["tokens"],
                             batch.get("frontend_embeds"), return_hidden=True,
                             act_sharding=act_sharding)
            return T._unembed(params, cfg, h[:, -1:, :])
    return prefill


def make_serve_step(cfg: ModelConfig, act_sharding=None):
    """One new token against an existing decode cache (updated in place).
    ``act_sharding``: the residual stream's layout under a mesh, where the
    step runs under ``no_grad``."""
    def serve_step(params, cache, tokens, pos):
        with torch.no_grad() if act_sharding is not None \
                else torch.inference_mode():
            return T.decode_step(params, cfg, cache, tokens, pos,
                                 act_sharding=act_sharding)
    return serve_step


def _greedy(logits):
    """(B,1,V) logits -> (B,1) int32 argmax, per batch row (under a mesh on
    each rank's rows, the vocab whole)."""
    rows = keep_dims(logits, (0,))
    return on_local(lambda t: t.argmax(dim=-1).to(torch.int32), (logits,),
                    (rows,), rows)


def generate(cfg: ModelConfig, params, prompt, steps=16, record=None,
             act_sharding=None, cache_layouts=None):
    """Greedy decode ``steps`` tokens from a (B, S) int32 prompt batch: the
    prompt is teacher-forced through the decode cache, then each token is
    the argmax of the last logits. ``record`` (a dict), when given, gains
    ``prompt_logits`` (the logits at the last prompt position) and
    ``step_s`` (the wall of every decode step, each synchronised).

    Under a mesh the params and ``prompt`` are DTensors (the prompt at the
    tokens' layout, which every step's token and position keep),
    ``act_sharding`` is the residual stream's layout and ``cache_layouts``
    the layouts of ``init_cache(cfg, B, S + steps)`` (e.g.
    ``launch.specs.serve_cache_layouts``); the tokens come back whole on
    every rank."""
    B, S = prompt.shape
    cache = T.init_cache(cfg, B, max_len=S + steps, device=prompt.device,
                         layouts=cache_layouts)
    serve = make_serve_step(cfg, act_sharding)
    tok = prompt[:, :1]
    out = []
    for t in range(S + steps - 1):
        t0 = time.perf_counter()
        pos = torch.full_like(tok, t)
        logits, cache = serve(params, cache, tok, pos)
        if t + 1 < S:
            tok = prompt[:, t + 1:t + 2]        # teacher-force the prompt
        else:
            tok = _greedy(logits)
            out.append(tok)
        if record is not None:
            if t == S - 1:
                record["prompt_logits"] = logits
            if prompt.device.type == "cuda":
                torch.cuda.synchronize(prompt.device)
            record.setdefault("step_s", []).append(time.perf_counter() - t0)
    return _whole(torch.cat(out, dim=1))
