"""Decoder-LM assembly: embeddings, grouped heterogeneous blocks, head.

Counterpart of ``repro/models/transformer.py``. The parameter tree is the
reference's, key for key: ``embed`` and ``final_norm`` (and ``head`` when
embeddings are untied), and ``blocks/b{j}_{kind}/...`` with every leaf of a
block-pattern position stacked on a leading axis of ``cfg.num_groups``.
Where the reference runs ``lax.scan`` over groups, ``forward`` loops over
them in Python; with ``cfg.remat`` each group runs under
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` with the
``nothing_saveable`` policy: only the group's input is kept, and its
activations are recomputed in the backward pass).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ATTN, ATTN_LOCAL, ATTENTION_KINDS, RGLRU, ModelConfig

BLOCK_INIT = {ATTN: L.transformer_block_init,
              ATTN_LOCAL: L.transformer_block_init,
              RGLRU: L.rglru_init}


def require_ported(cfg: ModelConfig) -> None:
    """Raise for the block kinds and features this package does not run."""
    missing = [k for k in cfg.block_pattern if k not in BLOCK_INIT]
    if missing or cfg.is_moe or cfg.frontend:
        what = sorted(set(missing)) + (["moe"] if cfg.is_moe else []) + \
            ([cfg.frontend] if cfg.frontend else [])
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported yet: {L.BLOCKS_SLICE}")


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cpu"):
    """Full parameter tree in float32 (``cast_params`` casts it), from a
    seeded ``torch.Generator`` on ``device`` (shapes only on ``meta``).
    Per-group block params are stacked on axis 0."""
    require_ported(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                              device=device),
        "final_norm": L.rmsnorm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                      device=device)
    groups = []
    for _ in range(cfg.num_groups):
        groups.append({f"b{j}_{kind}": BLOCK_INIT[kind](gen, cfg,
                                                        device=device)
                       for j, kind in enumerate(cfg.block_pattern)})
    params["blocks"] = _tree_map(lambda *xs: torch.stack(xs), *groups)
    return params


def keeps_f32(name: str) -> bool:
    """Leaves ``cast_params`` leaves in float32: norms, gate biases, Λ."""
    return name == "scale" or name.startswith("b_") or name == "a_param"


def cast_params(params, dtype: torch.dtype):
    """Cast matmul weights to the compute dtype; keep norms/gates float32."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict)
                else v if keeps_f32(k) else v.to(dtype)
                for k, v in tree.items()}
    return cast(params)


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------

def _apply_block(kind: str, params, x, cfg, positions):
    if kind in ATTENTION_KINDS:
        x, _, aux = L.transformer_block_apply(
            params, x, cfg, positions=positions, local=(kind == ATTN_LOCAL))
        return x, aux
    x, _ = L.rglru_apply(params, x, cfg, positions=positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _group(x, positions, gparams, cfg: ModelConfig):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.block_pattern):
        x, a = _apply_block(kind, gparams[f"b{j}_{kind}"], x, cfg, positions)
        aux = aux + a
    return x, aux


def _unstack(tree, n: int) -> list:
    """Stacked tree -> n per-group trees of views (``unbind`` backward stacks
    the group gradients into one buffer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _embed(params, cfg: ModelConfig, tokens, frontend_embeds=None):
    if frontend_embeds is not None:
        raise NotImplementedError(f"frontends are not ported yet: "
                                  f"{L.BLOCKS_SLICE}")
    x = params["embed"].to(L.dtype_of(cfg))[tokens.long()]
    if cfg.attn_softcap:
        # gemma-style embedding scaling; the reference multiplies by a numpy
        # float32 scalar, which promotes the residual stream to float32
        x = x.float() * math.sqrt(cfg.d_model)
    return x


def _unembed(params, cfg: ModelConfig, x):
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["head"].to(h.dtype)
    logits = logits.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def forward(params, cfg: ModelConfig, tokens, frontend_embeds=None,
            return_hidden: bool = False):
    """Training/prefill forward: tokens (B,S) -> (logits (B,S,V) float32,
    aux), or (hidden (B,S,d), aux) with ``return_hidden``."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens, frontend_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gparams in _unstack(params["blocks"], cfg.num_groups):
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_group, x, positions, gparams, cfg,
                              use_reentrant=False)
        else:
            x, a = _group(x, positions, gparams, cfg)
        aux = aux + a
    if return_hidden:
        return x, aux
    return _unembed(params, cfg, x), aux
