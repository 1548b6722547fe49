"""Model-swap serving on the PyTorch port: the paper's inference-restore
scenario.

"To serve inference requests that need a large number of different models,
all of which don't fit into the GPU memory at the same time and therefore
need to be swapped in and out of slower memory tiers as needed." (§1)

Counterpart of ``examples/serve_swap.py`` on ``repro_torch``. Three reduced
models are checkpointed once; the server then round-robins batched
generation requests across them, restoring ("swapping in") each model from
its checkpoint on demand, and reports each swap's restore bandwidth.

Part 2 is the delta-aware swap: the zoo is kept under ``delta=True``
managers, a served model is lightly fine-tuned (one row block of its first
and last leaves), and the update is pushed back into the zoo as a delta
save — only dirty chunks move (on the card they are found by the
fingerprint kernel) — before the model is re-served. Requests are served
by ``repro_torch.train.steps.generate``.

    PYTHONPATH=src python examples/torch_serve_swap.py [--root DIR] \\
        [--device cpu]

Each model's weights come from a stable seed, ``zlib.crc32`` of its name
(the reference seeds with ``hash(arch)``, which changes per process).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CheckpointManager
from repro_torch.core.serialization import (tree_leaves_with_path,
                                            tree_map_with_path)
from repro_torch.train.steps import generate, init_train_state

ARCHS = ["qwen2.5-3b", "stablelm-3b", "gemma2-9b"]
DELTA_CHUNK = 64 << 10   # reduced models are small; keep the grid fine


def zoo_config(arch: str):
    return get_config(arch).scaled_down(layers=2, width_div=16, vocab=512)


def zoo_seed(arch: str) -> int:
    return zlib.crc32(arch.encode())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _light_update(params):
    """Simulate a light fine-tune touching a sliver of the weights: += an
    exactly representable constant on the first 1/16 of the rows of the
    first and last leaves (JAX flatten order), which changes bits even in
    bfloat16."""
    flat = tree_leaves_with_path(params)
    ends = (flat[0][0], flat[-1][0])
    touched = 0

    def update(path, leaf):
        nonlocal touched
        if path not in ends or not leaf.ndim:
            return leaf
        leaf = leaf.clone()
        n = max(1, leaf.shape[0] // 16)
        leaf[:n] += torch.tensor(0.125, dtype=leaf.dtype)
        touched += leaf[:n].numel() * leaf.element_size()
        return leaf

    return tree_map_with_path(update, params), touched


def _manager(root: str, arch: str, device) -> CheckpointManager:
    return CheckpointManager(os.path.join(root, arch), delta=True, keep=2,
                             delta_chunk_bytes=DELTA_CHUNK, device=device)


def serve_one(root, arch, cfg, tmpl, rng, device) -> dict:
    """Swap ``arch`` in from its checkpoint and serve one request batch."""
    t0 = time.perf_counter()
    with _manager(root, arch, device) as mgr:
        params = mgr.restore(state_template={"params": tmpl})["params"]
        _sync(device)
        swap_s = time.perf_counter() - t0
        nbytes = mgr.last_restore_metrics.total_bytes
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, 8)),
                             dtype=torch.int32, device=device)
    toks = generate(cfg, params, prompt, steps=12)
    print(f"{arch:14s} swap-in {swap_s*1e3:7.1f} ms "
          f"({nbytes / swap_s / 1e6:7.1f} MB/s)  generated {toks.shape[1]} "
          f"tokens/req x{toks.shape[0]} reqs")
    return dict(arch=arch, swap_s=swap_s, bytes=nbytes, tokens=toks.numel())


def main(root: str | None = None, device="cuda") -> dict:
    """Run both parts under ``root``; returns the swaps and the updates."""
    root = root or os.path.join(tempfile.gettempdir(), "repro_torch_serve")
    device = torch.device(device)
    shutil.rmtree(root, ignore_errors=True)
    # 1. checkpoint three models (the "model zoo" on slow storage, kept by
    #    delta-aware managers so later updates move only dirty chunks)
    zoo = {}
    for arch in ARCHS:
        cfg = zoo_config(arch)
        params = init_train_state(cfg, seed=zoo_seed(arch),
                                  device=device)["params"]
        with _manager(root, arch, device) as mgr:
            mgr.save(0, {"params": params})
        zoo[arch] = (cfg, tree_map_with_path(
            lambda _p, t: torch.empty_like(t, device="meta"), params))
        del params

    # 2. serve a stream of requests, swapping models in on demand
    rng = np.random.default_rng(0)
    swaps = [serve_one(root, arch, *zoo[arch], rng, device)
             for arch in [ARCHS[i % 3] for i in range(6)]]
    print("serving with model swap ✓")

    # 3. delta-aware re-swap: lightly fine-tune a served model and push the
    #    UPDATE back into the zoo — only dirty chunks move
    print("\ndelta update + re-swap (bytes moved per update):")
    updates = []
    for arch in ARCHS:
        cfg, tmpl = zoo[arch]
        with _manager(root, arch, device) as mgr:
            params = mgr.restore(state_template={"params": tmpl})["params"]
            params, touched = _light_update(params)
            m = mgr.save(1, {"params": params})
            print(f"{arch:14s} touched {touched/1e3:7.1f} KB -> moved "
                  f"{m.written_bytes/1e3:8.1f} KB of "
                  f"{m.total_bytes/1e6:6.2f} MB model "
                  f"({m.written_bytes/m.total_bytes:6.1%}; "
                  f"{m.chunks_dirty}/{m.chunks_total} chunks)")
        updates.append(dict(arch=arch, touched=touched,
                            written_bytes=m.written_bytes,
                            total_bytes=m.total_bytes,
                            chunks_dirty=m.chunks_dirty,
                            chunks_total=m.chunks_total))
        swaps.append(serve_one(root, arch, cfg, tmpl, rng, device))
    print("delta-aware model swap ✓")
    return dict(swaps=swaps, updates=updates)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="zoo directory (default: repro_torch_serve under "
                         "the temp dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.root, args.device)
