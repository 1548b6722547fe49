"""Shared helpers of the ``test_torch_*`` files: identical states for the JAX
package and the PyTorch port, byte-level directory and manifest comparison.

States are made with numpy from a seed and handed to both packages: to
``repro`` as ``jnp`` arrays, to ``repro_torch`` through ``state_from_numpy``.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.core import CheckpointManager as RefManager
from repro.core import EngineConfig as RefConfig
from repro_torch.core import CheckpointManager as PortManager
from repro_torch.core import EngineConfig as PortConfig
from repro_torch.core.serialization import state_from_numpy, state_to_numpy

STRATEGIES = ("single_file", "file_per_process", "file_per_tensor")
QUANT = ("opt/mu", "opt/nu")

# manifest fields that legitimately differ between two saves of the same
# state: wall-clock timings, and the random ids of delta pack directories
# and chunk-entry paths (normalised by ``normalize_manifest``)
VOLATILE_FIELDS = ("extra.save_metrics.flush_seconds",
                   "tensors.*.shards.*.path (<chunks:uuid> entries)",
                   "chunk ref paths (../chunkstore/packs/<step>-<uuid>/...)")


def np_state(seed: int, rows: int = 40, cols: int = 300) -> dict:
    """A small train-state-shaped numpy tree: bf16 params with an f32 norm
    scale, f32 moments (two above the quantize threshold), int32 scalars,
    lean leaves and a None."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "params": {"w": f32(rows, cols).astype(ml_dtypes.bfloat16),
                   "emb": f32(cols + 3, 64).astype(ml_dtypes.bfloat16),
                   "norm": {"scale": f32(cols)}},
        "opt": {"mu": {"w": f32(rows, cols) * 1e-3,
                       "emb": f32(cols + 3, 64) * 1e-3,
                       "norm": {"scale": f32(cols)}},
                "nu": {"w": np.abs(f32(rows, cols)) * 1e-6},
                "count": np.asarray(7, np.int32)},
        "step": np.asarray(7, np.int32),
        "data": {"epoch": 2, "name": "run-a", "cursor": None},
    }


def to_jax(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, tree)


def to_port(tree):
    return state_from_numpy(tree, device="cpu")


def to_numpy(tree):
    """Either package's restored tree -> numpy leaves."""
    tree = state_to_numpy(tree)
    return jax.tree.map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def leaves_bytes(tree) -> dict:
    """path -> (dtype name, shape, bytes) of every array leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(to_numpy(tree))
    out = {}
    for path, leaf in flat:
        if isinstance(leaf, np.ndarray):
            out[jax.tree_util.keystr(path)] = (
                leaf.dtype.name, leaf.shape,
                np.ascontiguousarray(leaf).tobytes())
        else:
            out[jax.tree_util.keystr(path)] = leaf
    return out


def ref_config(strategy: str = "single_file") -> RefConfig:
    return RefConfig(backend="posix", strategy=strategy, direct=False)


def port_config(strategy: str = "single_file") -> PortConfig:
    return PortConfig(backend="posix", strategy=strategy, direct=False)


def ref_manager(path, strategy="single_file", **kw) -> RefManager:
    return RefManager(str(path), config=ref_config(strategy), **kw)


def port_manager(path, strategy="single_file", **kw) -> PortManager:
    return PortManager(str(path), config=port_config(strategy),
                       device="cpu", **kw)


def dir_files(d: str) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, d)] = fh.read()
    return out


def normalize_manifest(raw: bytes) -> dict:
    """The manifest with ``VOLATILE_FIELDS`` removed or normalised."""
    m = json.loads(raw)
    m["extra"].get("save_metrics", {}).pop("flush_seconds", None)
    for rec in m["tensors"].values():
        for sh in rec["shards"]:
            if sh.get("path", "").startswith("<chunks:"):
                sh["path"] = "<chunks>"
            for ref in sh.get("chunks") or ():
                parts = ref["path"].split("/")
                if len(parts) > 3 and parts[1] == "chunkstore":
                    parts[3] = parts[3].rsplit("-", 1)[0]
                    ref["path"] = "/".join(parts)
    return m

