"""The train state that a cell starts from, made on the card from the seed.

The layout (every leaf's key, shape and type) is the program's; the values
are the benchmark's: weights in the type they are trained in, one normal
draw a type for all its leaves (standard deviation 0.02 for the embedding
and the router, 1 / sqrt(fan-in) for every other matrix), norm scales 1,
AdamW moments 0 and the counters 0. ``flat`` is the weights as a flat
dict keyed as the reference keys them; the same seed gives the same bits.
"""

from __future__ import annotations

import math

import torch

from .feed import generator

TAG_WEIGHTS = 3


def _paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _std(path, shape) -> float | None:
    """None for a norm scale (filled with 1)."""
    name = path[-1]
    if name == "scale":
        return None
    if name in ("embed", "router"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_weights(layout: dict, seed: int, device="cuda") -> dict:
    """{key: tensor} of the param leaves of ``layout`` (a tree of ``meta``
    tensors), keyed "a/b/c"."""
    leaves = list(_paths(layout))
    out = {}
    g = generator(seed, TAG_WEIGHTS, device=device)
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        drawn = [(p, t) for p, t in leaves
                 if t.dtype == dtype and _std(p, t.shape) is not None]
        n = sum(t.numel() for _, t in drawn)
        pool = torch.randn(n, generator=g, device=device, dtype=dtype) \
            if n else None
        a = 0
        for p, t in drawn:
            out["/".join(p)] = pool[a:a + t.numel()].view(t.shape).clone() \
                .mul_(_std(p, t.shape))
            a += t.numel()
        del pool
    for p, t in leaves:
        if _std(p, t.shape) is None:
            out["/".join(p)] = torch.ones(t.shape, dtype=t.dtype,
                                          device=device)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def make_state(layout: dict, seed: int, device="cuda") -> dict:
    """{"params", "opt": {"mu", "nu", "count"}, "step"} in the layout of
    the program's train state ``layout`` (``meta`` tensors)."""
    params = _nest(make_weights(layout["params"], seed, device))

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.zeros(v.shape, dtype=torch.float32, device=device)
                for k, v in tree.items()}
    scalar = {k: torch.zeros((), dtype=layout[k].dtype, device=device)
              for k in ("step",)}
    return {"params": params,
            "opt": {"mu": zeros(layout["params"]),
                    "nu": zeros(layout["params"]),
                    "count": torch.zeros(
                        (), dtype=layout["opt"]["count"].dtype,
                        device=device)},
            **scalar}


def leaves(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict."""
    return {prefix + "/".join(p): t for p, t in _paths(tree)}
