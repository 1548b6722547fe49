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

Decode caches have the reference's tree too: ``b{j}_{kind}/{k,v,pos}``,
``b{j}_{kind}/h`` (RG-LRU), ``b{j}_{kind}/{C,N,M}`` (mLSTM) or
``b{j}_{kind}/{c,n,m,h}`` (sLSTM), every leaf stacked over
``cfg.num_groups``.
``decode_step`` writes each group's new entries into those stacked buffers
in place and returns the same tree. Under a mesh (``init_cache(layouts=)``)
the leaves are DTensors, each rank holding only its blocks, and the writes
land in them (``layers``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding.dtensor import (constrain, gathered, is_dtensor,
                                keep_dims, model_axis, on_local, placed,
                                replicate, summed_over, zeros)
from . import layers as L
from .config import (ATTN, ATTN_LOCAL, ATTENTION_KINDS, MLSTM, RGLRU, SLSTM,
                     ModelConfig)

BLOCK_INIT = {ATTN: L.transformer_block_init,
              ATTN_LOCAL: L.transformer_block_init,
              MLSTM: L.mlstm_init,
              SLSTM: L.slstm_init,
              RGLRU: L.rglru_init}


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Full parameter tree in float32 (``cast_params`` casts it), from a
    seeded ``torch.Generator`` on ``device`` (the card by default; shapes
    only on ``meta``).
    Per-group block params are stacked on axis 0."""
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
    if cfg.frontend:
        params["frontend_proj"] = L.dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), device=device)
    groups = []
    for _ in range(cfg.num_groups):
        groups.append({f"b{j}_{kind}": BLOCK_INIT[kind](gen, cfg,
                                                        device=device)
                       for j, kind in enumerate(cfg.block_pattern)})
    params["blocks"] = _tree_map(lambda *xs: torch.stack(xs), *groups)
    return params


def keeps_f32(name: str) -> bool:
    """Leaves ``cast_params`` leaves in float32: norms, gate biases
    (RG-LRU's ``b_*_gate``, mLSTM's ``b_igate``/``b_fgate``, sLSTM's
    ``b_{i,f,z,o}``), Λ."""
    return name == "scale" or name.startswith("b_") or name == "a_param"


def cast_params(params, dtype: torch.dtype):
    """Cast matmul weights to the compute dtype; keep norms/gates float32."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict)
                else v if keeps_f32(k) else v.to(dtype)
                for k, v in tree.items()}
    return cast(params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

CACHE_INIT = {
    ATTN: lambda cfg, b, m, device: L.attention_cache_init(
        cfg, b, m, local=False, device=device),
    ATTN_LOCAL: lambda cfg, b, m, device: L.attention_cache_init(
        cfg, b, m, local=True, device=device),
    MLSTM: lambda cfg, b, m, device: L.mlstm_cache_init(cfg, b,
                                                        device=device),
    SLSTM: lambda cfg, b, m, device: L.slstm_cache_init(cfg, b,
                                                        device=device),
    RGLRU: lambda cfg, b, m, device: L.rglru_cache_init(cfg, b,
                                                        device=device),
}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", layouts=None):
    """Stacked (per-group) decode caches, laid out as the reference's: on
    ``device`` (the card by default). ``layouts`` (a tree of layouts of
    this cache, e.g. ``launch.specs.serve_cache_layouts``) makes every leaf
    a DTensor of its layout, each rank allocating only its own block."""
    if layouts is not None:
        shapes = init_cache(cfg, batch, max_len, device="meta")
        return _tree_map(lambda t, lay: zeros(t.shape, t.dtype, device, lay),
                         shapes, layouts)
    groups = [{f"b{j}_{kind}": CACHE_INIT[kind](cfg, batch, max_len, device)
               for j, kind in enumerate(cfg.block_pattern)}
              for _ in range(cfg.num_groups)]
    return _tree_map(lambda *xs: torch.stack(xs), *groups)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

RECURRENT_APPLY = {MLSTM: L.mlstm_apply, SLSTM: L.slstm_apply,
                   RGLRU: L.rglru_apply}


def _apply_block(kind: str, params, x, cfg, positions, cache):
    if kind in ATTENTION_KINDS:
        x, _, aux = L.transformer_block_apply(
            params, x, cfg, positions=positions, local=(kind == ATTN_LOCAL),
            cache=cache)
        return x, aux
    x, _ = RECURRENT_APPLY[kind](params, x, cfg, positions=positions,
                                 cache=cache)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _group(x, positions, gparams, cfg: ModelConfig, gcache=None,
           act_sharding=None):
    """One group of blocks -> (x, aux); ``gcache`` (decode) is updated in
    place. Under a mesh the residual stream is redistributed to
    ``act_sharding`` after every block, and params split over the data
    axes (FSDP) are gathered there first (in the remat recompute again)."""
    gparams = _tree_map(gathered, gparams)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.block_pattern):
        name = f"b{j}_{kind}"
        x, a = _apply_block(kind, gparams[name], x, cfg, positions,
                            None if gcache is None else gcache[name])
        x = constrain(x, act_sharding)
        aux = aux + a
    return x, aux


def _unstack(tree, n: int) -> list:
    """Stacked tree -> n per-group trees of views (``unbind`` backward stacks
    the group gradients into one buffer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _lookup(table, tokens):
    """``table[tokens]``. Under a mesh it runs on local blocks at the
    table's own layout (the gather's backward, an index_put, has no
    DTensor strategy in every release), each rank on its rows of the
    batch:

    - the vocab split over ``model``: each rank gathers the ids in its
      rows [lo, hi) of the table and writes zeros for the rest; the output
      is a pending sum over ``model`` (one rank gives each token its
      value, the others exact zeros) and the table's grad stays split as
      the table, a pending sum over the batch's splits;
    - d split over ``model`` (a vocab that does not divide): each rank
      looks up its columns, the output split over d;
    - otherwise (the table whole over ``model``) the whole rows."""
    ax = model_axis(table)
    if ax is None:
        if is_dtensor(table):
            raise NotImplementedError("a lookup on a mesh without a "
                                      "'model' axis")
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    i, tp, r = ax
    rows = keep_dims(tokens, (0,))
    own = placed(replicate(table), i, table.placements[i])
    grad = placed(summed_over(rows), i, table.placements[i])
    if table.placements[i] == Shard(0):
        lo = r * -(-table.shape[0] // tp)        # torch.chunk's blocks

        def fn(t, ids):
            local = ids.long() - lo
            hit = (local >= 0) & (local < t.shape[0])
            got = t[local.clamp(0, t.shape[0] - 1)]
            return torch.where(hit[..., None], got, torch.zeros(
                (), dtype=t.dtype, device=t.device))
        out = placed(rows, i, Partial())
    else:
        def fn(t, ids):
            return t[ids.long()]
        out = placed(rows, i, Shard(2) if table.placements[i] == Shard(1)
                     else Replicate())
    return on_local(fn, (table, tokens), (own, rows), out, (grad, rows))


def _embed(params, cfg: ModelConfig, tokens, frontend_embeds=None):
    """Token embeddings, with the projected ``frontend_embeds`` (B, F,
    frontend_dim) as a prefix for the vlm and audio families (the
    frontends themselves are stubs, as in the reference)."""
    x = _lookup(gathered(params["embed"]).to(L.dtype_of(cfg)), tokens)
    if cfg.family in ("vlm", "audio") and cfg.frontend and \
            frontend_embeds is not None:
        proj = frontend_embeds.to(x.dtype) @ \
            gathered(params["frontend_proj"]).to(x.dtype)
        x = torch.cat([proj, x], dim=1)
    if cfg.attn_softcap:
        # gemma-style embedding scaling; the reference multiplies by a numpy
        # float32 scalar, which promotes the residual stream to float32
        x = x.float() * math.sqrt(cfg.d_model)
    return x


def unembed_table(params, cfg: ModelConfig, dtype):
    """The unembedding's weight, ``embed`` (tied) or ``head``, gathered over
    the data axes (FSDP) and cast to ``dtype``: the loss makes it once and
    hands it to each chunk's ``_unembed``, so that autograd keeps one copy
    of it, not one a chunk."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return gathered(w).to(dtype)


def _unembed(params, cfg: ModelConfig, x, table=None):
    """Final norm, unembedding and ``final_softcap``: (B, S, d) -> (B, S, V)
    float32 logits, at the layout the table gives them under a mesh (the
    vocab split over ``model`` where the table splits it). ``table`` is
    ``unembed_table(params, cfg, x.dtype)``, made here when not given."""
    h = L.rmsnorm(_tree_map(gathered, params["final_norm"]), x, cfg.norm_eps)
    if table is None:
        table = unembed_table(params, cfg, h.dtype)
    logits = h @ (table.T if cfg.tie_embeddings else table)
    logits = logits.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def forward(params, cfg: ModelConfig, tokens, frontend_embeds=None,
            return_hidden: bool = False, act_sharding=None):
    """Training/prefill forward: tokens (B,S) -> (logits (B,S,V) float32,
    aux), or (hidden (B,S,d), aux) with ``return_hidden``; S counts the
    frontend prefix where there is one. Under a mesh (DTensor params and
    tokens) ``act_sharding`` pins the residual stream's layout at the embed
    and after every block, as the reference's sharding constraints do."""
    x = constrain(_embed(params, cfg, tokens, frontend_embeds), act_sharding)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gparams in _unstack(params["blocks"], cfg.num_groups):
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_group, x, positions, gparams, cfg, None,
                              act_sharding, use_reentrant=False)
        else:
            x, a = _group(x, positions, gparams, cfg,
                          act_sharding=act_sharding)
        aux = aux + a
    if return_hidden:
        return x, aux
    return _unembed(params, cfg, x), aux


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                act_sharding=None):
    """One-token decode: tokens (B,1), pos (B,1) int32 absolute positions.

    ``cache`` is the stacked per-group cache from ``init_cache``; it is
    updated in place. Returns (logits (B,1,V) float32, cache). Under a mesh
    (DTensor params, cache, tokens; ``pos`` a DTensor or the same plain
    tensor on every rank) ``act_sharding`` pins the residual stream's
    layout at the embed and after every block, as ``forward`` does, and
    the logits' (the vocab whole)."""
    x = constrain(_embed(params, cfg, tokens), act_sharding)
    for gparams, gcache in zip(_unstack(params["blocks"], cfg.num_groups),
                               _unstack(cache, cfg.num_groups)):
        x, _ = _group(x, pos, gparams, cfg, gcache, act_sharding)
    return constrain(_unembed(params, cfg, x), act_sharding), cache
