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

Under a mesh every leaf is a DTensor: the norm is that of the logical
tensors (each element counted once), and each leaf updates elementwise on
its local blocks of p, g, mu and nu at the moments' layout — under ZeRO-1
the moments split over data where the params hold copies, so each data rank
updates a window of the param, and the window is redistributed back to the
param's layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.serialization import tree_leaves_with_path
from ..sharding.dtensor import is_dtensor

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


def _local(t):
    """The local block of a DTensor (aliasing its storage), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


def global_norm(tree) -> torch.Tensor:
    """float32 sqrt of the sum of squares of every leaf: each leaf's sum,
    then their total in leaf order. DTensor leaves count each element of
    the logical tensor once: a leaf's local sum is summed over the mesh
    dims that split it (never over a dim that holds copies; one collective
    for the leaves split alike), so that the total adds the same leaf sums
    in the same order as off a mesh (a 1x1 mesh gives the same bits)."""
    leaves = _leaves(tree)
    device = _local(leaves[0]).device
    sums = []
    for leaf in leaves:
        total = torch.zeros((), dtype=torch.float32, device=device)
        for piece in _pieces(_local(leaf)):
            total = total + piece.float().square().sum()
        sums.append(total)
    splits = [_split_dims(leaf) for leaf in leaves]
    for key in {k for k in splits if k is not None and any(k)}:
        idx = [j for j, k in enumerate(splits) if k == key]
        summed = _sum_over(torch.stack([sums[j] for j in idx]), key,
                           leaves[0].device_mesh)
        for j, part in zip(idx, summed.unbind(0)):
            sums[j] = part
    total = torch.zeros((), dtype=torch.float32, device=device)
    for part in sums:
        total = total + part
    return torch.sqrt(total)


def _split_dims(t):
    """The mesh dims a DTensor is split over (None for a plain tensor)."""
    if not is_dtensor(t):
        return None
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"a pending sum has no norm: {t.placements}")
    return tuple(p.is_shard() for p in t.placements)


def _sum_over(part: torch.Tensor, split: tuple, mesh) -> torch.Tensor:
    """``part`` summed over the mesh dims flagged in ``split``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor.from_local(
        part, mesh, [Partial() if s else Replicate() for s in split],
        run_check=False).full_tensor()


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state) -> dict:
    """Update ``params`` and ``state`` (mu, nu, count) in place; returns the
    metrics ``{"grad_norm", "lr"}`` as float32 0-d tensors."""
    count = _local(state["count"]) + 1
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, cfg.grad_clip / (gnorm + 1e-9)) \
        if cfg.grad_clip else one
    lr = _schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state["mu"]), _leaves(state["nu"])):
        # under a mesh: the local blocks at the moments' layout (ZeRO-1:
        # the params' copies over data update a window each)
        pw, gw = _at_layout(p, mu), _at_layout(g, mu)
        for pp, gp, mp, np_ in zip(_pieces(pw), _pieces(gw),
                                   _pieces(_local(mu)), _pieces(_local(nu))):
            g32 = gp.float() * scale
            mp.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            np_.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
            step = (mp / b1c).div_((np_ / b2c).sqrt_().add_(cfg.eps))
            p32 = pp.float()
            step.add_(p32 * cfg.weight_decay)
            p32.sub_(step.mul_(lr))
            pp.copy_(p32)
        if not _same_memory(pw, _local(p)):
            _write_back(p, pw, mu)
    _local(state["count"]).copy_(count)
    return {"grad_norm": gnorm, "lr": lr}


def _at_layout(t, like):
    """``t``'s local block at DTensor ``like``'s layout, contiguous (a view
    of ``t``'s own local block where no rank's window changes: the layouts
    agree, or they differ only on mesh dims of size 1); ``t`` itself when
    it is a plain tensor."""
    if not is_dtensor(t):
        return t
    local = t.redistribute(like.device_mesh, like.placements).to_local()
    return local if local.is_contiguous() else local.contiguous()


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether contiguous ``a`` covers exactly ``b``'s memory (then an
    update of ``a`` is already one of ``b``)."""
    return (b.is_contiguous() and a.data_ptr() == b.data_ptr()
            and a.numel() == b.numel() and a.dtype == b.dtype)


def _write_back(p, window, like) -> None:
    """Redistribute the updated ``window`` (at ``like``'s layout) to
    ``p``'s layout and copy it into ``p``'s local block."""
    from torch.distributed.tensor import DTensor
    new = DTensor.from_local(window, like.device_mesh, like.placements,
                             run_check=False, shape=p.shape,
                             stride=p.stride())
    _local(p).copy_(new.redistribute(p.device_mesh, p.placements)
                    .to_local())
