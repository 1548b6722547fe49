"""Train-step factory: forward, backward and AdamW on one device.

Counterpart of ``repro/train/steps.py``. ``make_train_step`` returns a
function ``train_step(state, batch) -> (state, metrics)`` that updates
``state`` IN PLACE (params, moments, counters) — the reference donates its
state buffers to the jitted step instead. Gradients come from
``torch.autograd.grad`` over detached aliases of the params, so nothing is
left attached to the state between steps; grads of bf16 params are bf16 as
in the reference. The sharding arguments of the reference
(``grad_shardings``, ``act_sharding``) wait for the sharding slice.
"""

from __future__ import annotations

import torch

from ..core.serialization import tree_leaves_with_path
from ..models import layers as L
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import AdamWConfig, apply_updates, init_state

CE_CHUNK = 512  # sequence chunk for the unembed + cross-entropy loop


def cross_entropy(logits, labels):
    """logits (B,S,V) float32, labels (B,S) int -> scalar mean nll."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def chunked_cross_entropy(params, cfg: ModelConfig, h, labels,
                          chunk: int = CE_CHUNK):
    """Unembed + cross-entropy a sequence chunk at a time, so only
    (B, chunk, V) float32 logits are live in the forward pass."""
    B, S, _ = h.shape
    if S <= chunk:
        return cross_entropy(T._unembed(params, cfg, h), labels)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a in range(0, S, chunk):
        logits = T._unembed(params, cfg, h[:, a:a + chunk])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, a:a + chunk].long()[..., None])[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        h, aux = T.forward(params, cfg, batch["tokens"],
                           batch.get("frontend_embeds"), return_hidden=True)
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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    microbatches: int = 1):
    """fwd + bwd + AdamW. ``microbatches`` > 1 accumulates float32 grads
    over that many slices of the batch, so live activations are
    O(batch / microbatches)."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        flat = tree_leaves_with_path(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        with torch.enable_grad():
            loss, extras = loss_fn(
                _unflat(zip((k for k, _ in flat), leaves)), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in extras.items()}), \
            _unflat(zip((k for k, _ in flat), grads))

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            (loss, extras), grads = grad_fn(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            g_acc = _unflat((k, torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device))
                            for k, p in tree_leaves_with_path(params))
            l_acc = a_acc = 0.0
            for m in range(microbatches):
                mb = {k: v[m * n:(m + 1) * n] for k, v in batch.items()}
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
