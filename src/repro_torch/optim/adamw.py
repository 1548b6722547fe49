"""AdamW, written out (no ``torch.optim``), updating the train state in place.

Counterpart of ``repro/optim/adamw.py``, with the same state layout — float32
moment trees ``mu`` and ``nu`` shaped like the params, and an int32 ``count``
— so a checkpoint of either package resumes in the other. The arithmetic is
the reference's: warmup follows ``count``, the clip uses the float32 global
norm of the grads, and weight decay applies to every leaf as
``p32 - lr * (step + wd * p32)`` before the cast back.

Unlike the reference (pure functions), ``apply_updates`` writes the new
params and moments into the tensors it is given, in flat pieces of at most
``CHUNK`` values, so its float32 temporaries stay small next to the state
(a full-width embedding's float32 gradient alone is 2.6 GB). A caller that
checkpoints asynchronously must wait for the snapshot first
(``CheckpointManager.wait_snapshotted``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.serialization import tree_leaves_with_path

CHUNK = 1 << 24          # values per in-place update piece (64 MiB of f32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _leaves(tree) -> list:
    """Leaves in the reference's flatten order (sorted keys)."""
    return [x for _, x in tree_leaves_with_path(tree)]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init_state(params):
    leaf = _leaves(params)[0]
    return {"mu": _zeros_like(params), "nu": _zeros_like(params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _pieces(t: torch.Tensor):
    flat = t.view(-1)
    for a in range(0, flat.numel(), CHUNK):
        yield flat[a:a + CHUNK]


def global_norm(tree) -> torch.Tensor:
    """float32 sqrt of the sum of squares of every leaf."""
    leaves = _leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        for piece in _pieces(leaf):
            total = total + piece.float().square().sum()
    return torch.sqrt(total)


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state) -> dict:
    """Update ``params`` and ``state`` (mu, nu, count) in place; returns the
    metrics ``{"grad_norm", "lr"}`` as float32 0-d tensors."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, cfg.grad_clip / (gnorm + 1e-9)) \
        if cfg.grad_clip else one
    lr = _schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state["mu"]), _leaves(state["nu"])):
        for pp, gp, mp, np_ in zip(_pieces(p), _pieces(g), _pieces(mu),
                                   _pieces(nu)):
            g32 = gp.float() * scale
            mp.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            np_.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
            step = (mp / b1c).div_((np_ / b2c).sqrt_().add_(cfg.eps))
            p32 = pp.float()
            step.add_(p32 * cfg.weight_decay)
            p32.sub_(step.mul_(lr))
            pp.copy_(p32)
    state["count"].copy_(count)
    return {"grad_norm": gnorm, "lr": lr}
