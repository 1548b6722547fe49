"""Train-state inventories of the models the port checkpoints.

An inventory lists every leaf of a model's train state (key, shape, dtype)
exactly as the JAX package lays it out: ``params/...`` (bf16 with f32 norm
scales), the AdamW moments ``opt/mu/...`` and ``opt/nu/...`` (f32), and the
``opt/count`` and ``step`` scalars. Layers are stacked on a leading axis of
``stacked_layers``. The JSON files are generated from the JAX package and
pinned by a test; this package reads them without JAX.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..core.serialization import torch_dtype

_DIR = Path(__file__).resolve().parent
INVENTORIES = {"qwen2.5-3b": "qwen2_5_3b_train_state.json"}


def train_state_inventory(name: str = "qwen2.5-3b") -> dict:
    with open(_DIR / INVENTORIES[name]) as f:
        return json.load(f)


def leaf_shapes(inv: dict, layers: int | None = None) -> list[tuple]:
    """[(key, shape, torch dtype)]; ``layers`` cuts the stacked layer axis
    (depth) and never a width."""
    out = []
    for leaf in inv["leaves"]:
        shape = list(leaf["shape"])
        if layers is not None and "/blocks/" in leaf["key"]:
            if shape[0] != inv["stacked_layers"]:
                raise ValueError(f"{leaf['key']}: no stacked layer axis")
            shape[0] = layers
        out.append((leaf["key"], tuple(shape), torch_dtype(leaf["dtype"])))
    return out


def make_train_state(inv: dict, *, device="cuda", seed: int = 0,
                     layers: int | None = None) -> dict:
    """A random train state of the inventory's layout, filled on ``device``
    from a seeded ``torch.Generator``: params ~ N(0, 0.02), norm scales 1,
    first moments ~ N(0, 1e-3), second moments |N(0, 1e-6)|, scalars 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state: dict = {}
    for key, shape, dtype in leaf_shapes(inv, layers):
        if dtype in (torch.int32, torch.int64):
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif key.startswith("params/") and key.endswith("/scale"):
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            std = {"params": 0.02, "opt/mu": 1e-3, "opt/nu": 1e-6}[
                next(p for p in ("params", "opt/mu", "opt/nu")
                     if key.startswith(p))]
            t = torch.empty(shape, dtype=dtype, device=device)
            t.normal_(0.0, std, generator=gen)
            if key.startswith("opt/nu"):
                t.abs_()
        node = state
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return state
