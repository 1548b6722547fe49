"""Argument specs of every (arch x shape) dry-run cell, on ``meta``.

Counterpart of ``repro/launch/specs.py``. Nothing is allocated: every model
input, parameter, optimizer moment and decode-cache leaf is an ``ArgSpec``
— a ``meta`` tensor (shape and dtype) with its ``Layout`` on the mesh —
from which the dry run reads per-device shapes and bytes. The mesh may be a
``DeviceMesh`` or an ``AbstractMesh`` (``launch.mesh``): only the axis names
and sizes are used.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.serialization import tree_leaves_with_path, tree_map_with_path
from ..models import transformer as T
from ..models.config import ModelConfig, ShapeConfig
from ..sharding.partition import Layout, Partitioner
from ..train.steps import init_train_state


@dataclass(frozen=True)
class ArgSpec:
    """One argument leaf: its ``meta`` tensor and its layout."""
    tensor: torch.Tensor
    layout: Layout

    @property
    def shape(self) -> tuple:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def local_shape(self) -> tuple:
        return self.layout.local_shape(self.shape)

    @property
    def local_nbytes(self) -> int:
        return int(np.prod(self.local_shape, dtype=np.int64)) * \
            self.tensor.element_size()


def _spec(shape, dtype, layout: Layout) -> ArgSpec:
    return ArgSpec(torch.empty(shape, dtype=dtype, device="meta"), layout)


def _with_layouts(meta_tree, layout_tree):
    def one(path, t):
        lay = layout_tree
        for k in path:
            lay = lay[k]
        return ArgSpec(t, lay)
    return tree_map_with_path(one, meta_tree)


def arg_leaves(tree) -> list[tuple[str, ArgSpec]]:
    """[(key, ArgSpec)] of a spec tree, keys as the checkpoint's."""
    return [("/".join(map(str, p)), s) for p, s in tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, ArgSpec))]


def local_bytes(*trees) -> int:
    """Per-device bytes of every ``ArgSpec`` in ``trees``."""
    return sum(s.local_nbytes for t in trees for _, s in arg_leaves(t))


def train_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                fsdp: bool = True):
    """(state_specs, batch_specs, shardings) for train/prefill cells.

    Training defaults to FSDP (ZeRO-3) param sharding: at 32B-scale the
    per-layer fp32 grad accumulator otherwise exceeds per-device HBM."""
    part = Partitioner(cfg, mesh, fsdp=fsdp)
    state = init_train_state(cfg, device="meta")
    shardings = part.state_shardings(state)
    state_specs = _with_layouts(state, shardings)

    B, S = shape.global_batch, shape.seq_len
    tok = part.tokens_sharding(B)
    batch_specs = {"tokens": _spec((B, S), torch.int32, tok),
                   "labels": _spec((B, S), torch.int32, tok)}
    if cfg.frontend:
        batch_specs["frontend_embeds"] = _spec(
            (B, cfg.frontend_len, cfg.frontend_dim), torch.float32,
            part.frontend_sharding(B))
    return state_specs, batch_specs, shardings


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(param_specs, batch_specs, param_shardings) for the prefill cells.
    Inference keeps params TP-only (no FSDP gathers on the serving path)."""
    state_specs, batch_specs, shardings = train_specs(cfg, shape, mesh,
                                                      fsdp=False)
    return state_specs["params"], batch_specs, shardings["params"]


def serve_cache_layouts(cfg: ModelConfig, mesh, cache):
    """Tree of ``Layout``s of a decode cache (``T.init_cache``'s tree, its
    leaves real tensors, DTensors or ``meta``: only shapes are read) on
    ``mesh``: the reference's decode-cell rule. The stacked group axis
    stays whole, the batch splits over the DP axes where it divides, and
    the first dim among the rest that is a head count (KV or query heads)
    or ``lru_dim`` and divides over ``model`` splits over ``model``. Where
    the KV heads cannot split, K/V (G, B, W, KV, hd) split their slot dim
    W over ``model`` instead — the cache TIMELINE, flash-decoding style,
    the partial softmax reductions becoming collectives
    (``models.layers`` merges them by a log-sum-exp combine).

    This is the rule the live server uses (``init_cache(layouts=)``), so
    the dry run's decode cells report the bytes a server holds. It is not
    ``Partitioner.cache_specs``, the reference's Partitioner rule, which
    never splits the timeline and raises as the reference has it (ROADMAP
    §C); the reference's decode cells compile with this one
    (``repro/launch/specs.py:91-124``)."""
    part = Partitioner(cfg, mesh)
    batch = next(int(t.shape[1]) for _, t in tree_leaves_with_path(cache)
                 if t.ndim >= 2)
    bdim, = part.batch_spec(batch)
    kv_shardable = (cfg.num_kv_heads % part.model == 0
                    and cfg.num_kv_heads >= part.model)

    def cache_layout(_path, leaf):
        shp = tuple(leaf.shape)
        entries: list = []
        if len(shp) >= 1:
            entries.append(None)            # stacked group axis
        if len(shp) >= 2:
            entries.append(bdim)            # batch
        used_model = False
        for i, dim in enumerate(shp[2:], start=2):
            if used_model:
                entries.append(None)
                continue
            if dim in (cfg.num_kv_heads, cfg.num_heads) and \
                    dim % part.model == 0 and dim >= part.model:
                entries.append("model")
                used_model = True
            elif dim == cfg.lru_dim and dim % part.model == 0:
                entries.append("model")
                used_model = True
            elif (not kv_shardable and len(shp) == 5 and i == 2
                  and dim % part.model == 0 and dim > part.model):
                # K/V (G, B, W, kv, hd) with unshardable kv heads: the
                # cache TIMELINE splits over 'model' (flash-decoding style)
                entries.append("model")
                used_model = True
            else:
                entries.append(None)
        return part.layout(tuple(entries[:len(shp)]))

    return tree_map_with_path(cache_layout, cache)


def serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(param_specs, cache_specs, token_specs, pos_specs, param_shardings,
    cache_shardings) for decode cells.

    The KV/recurrent cache is sized for shape.seq_len context; the step
    decodes ONE new token. Params are TP-only (no FSDP); the cache is laid
    out by ``serve_cache_layouts``, as the live server's."""
    part = Partitioner(cfg, mesh)
    params = init_train_state(cfg, device="meta")["params"]
    param_shardings = part.param_shardings(params)
    param_specs = _with_layouts(params, param_shardings)

    B = shape.global_batch
    cache = T.init_cache(cfg, B, shape.seq_len, device="meta")
    cache_shardings = serve_cache_layouts(cfg, mesh, cache)
    cache_specs = _with_layouts(cache, cache_shardings)
    tok = _spec((B, 1), torch.int32, part.tokens_sharding(B))
    pos = _spec((B, 1), torch.int32, part.tokens_sharding(B))
    return (param_specs, cache_specs, tok, pos, param_shardings,
            cache_shardings)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Uniform entry: kind-dispatched specs for a dry-run cell."""
    if shape.kind == "train":
        return {"mode": "train", "specs": train_specs(cfg, shape, mesh)}
    if shape.kind == "prefill":
        return {"mode": "prefill", "specs": prefill_specs(cfg, shape, mesh)}
    return {"mode": "decode", "specs": serve_specs(cfg, shape, mesh)}


def cell_args(info: dict) -> tuple:
    """The argument spec trees of an ``input_specs`` result, as the step
    of its mode takes them: (state, batch), (params, batch) or (params,
    cache, token, pos)."""
    specs = info["specs"]
    return specs[:2] if info["mode"] != "decode" else specs[:4]
