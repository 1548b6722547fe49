"""Architecture registry and train-state inventories.

``get_config(id)`` returns the full-size ``ModelConfig`` of an architecture
(``--arch <id>``); the config modules beside this file are carried from the
JAX package as data.

An inventory lists every leaf of a model's train state (key, shape, dtype)
exactly as the JAX package lays it out: ``params/...`` (bf16 with f32 norm
scales), the AdamW moments ``opt/mu/...`` and ``opt/nu/...`` (f32), and the
``opt/count`` and ``step`` scalars. Layers are stacked on a leading axis of
``stacked_layers``. The JSON files are generated from the JAX package and
pinned by a test; this package reads them without JAX.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch

from ..core.serialization import torch_dtype
from ..models.config import ModelConfig

_MODULES = {
    "musicgen-large": "musicgen_large",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "stablelm-3b": "stablelm_3b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-32b": "qwen3_32b",
    "gemma2-9b": "gemma2_9b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.CONFIG


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
