"""Tensor extraction + "lean object" serialization (paper §2, stage 1).

A checkpointable state is a nested structure of dicts, lists, tuples and
named tuples. Tensors (``torch.Tensor`` / numpy) are pre-serialized
contiguous byte streams and bypass pickling entirely; everything else —
step counters, python scalars, strings, dataloader state — is the "lean
checkpoint object", pickled as one small blob.

The on-disk form is shared with ``repro.core`` (the JAX package), so two
things follow its rules rather than PyTorch's:

  · flatten order: dict keys are visited in sorted order and ``None`` is
    an empty node, not a leaf — ``jax.tree_util``'s rules. Put order sets
    file offsets, so ``torch.utils._pytree`` (insertion order, ``None`` as
    a leaf) would change the layout and the manifest.
  · the lean blob pickles stubs under the JAX package's class name
    (``repro.core.serialization.TensorStub``) without importing it, and
    reads that name back as this module's ``TensorStub``; dtype names are
    numpy's (``"bfloat16"``, never ``"torch.bfloat16"``).
"""

from __future__ import annotations

import io
import pickle
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

LEAN_KEY = "__lean__"

# the global name stubs are pickled under, shared with repro.core
STUB_MODULE = "repro.core.serialization"
STUB_NAME = "TensorStub"


@dataclass(frozen=True)
class TensorStub:
    """Placeholder left in the lean object where a tensor was extracted.

    ``is_prng_key``/``prng_impl`` are read from JAX-written checkpoints (a
    typed PRNG key saved as its uint32 key data); this package restores such
    a leaf as the plain uint32 tensor."""
    key: str
    shape: tuple[int, ...]
    dtype: str
    is_prng_key: bool = False
    prng_impl: str | None = None


@dataclass(frozen=True)
class LocalShard:
    """A rank-local window of a global tensor (multi-writer leaf).

    Looks like a tensor whose ``.shape`` is the GLOBAL shape while holding
    only this rank's ``data`` covering ``index`` (global (start, stop) per
    dim)."""
    data: object                       # torch.Tensor or np.ndarray
    index: tuple[tuple[int, int], ...]
    global_shape: tuple[int, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return self.global_shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.data)


# ------------------------------------------------------------------ dtypes
# numpy-native dtypes: names come from np.dtype so each call returns a fresh
# str, exactly as ``str(arr.dtype)`` does in the JAX package — the pickler's
# memo (and so the lean blob's bytes) depends on string identity
_NUMPY_NATIVE = {
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
    torch.uint16: np.uint16, torch.uint32: np.uint32,
    torch.uint64: np.uint64, torch.bool: np.bool_,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
}
# ml_dtypes types: their dtype name is one shared str object
_BFLOAT16 = "bfloat16"
_EXTENDED = {torch.bfloat16: _BFLOAT16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _EXTENDED[getattr(torch, _name)] = _name
_BY_NAME = {np.dtype(v).name: k for k, v in _NUMPY_NATIVE.items()}
_BY_NAME.update({v: k for k, v in _EXTENDED.items()})


def dtype_name(dt) -> str:
    """numpy name of a torch or numpy dtype (``"bfloat16"``, ``"float32"``)."""
    if isinstance(dt, torch.dtype):
        if dt in _EXTENDED:
            return _EXTENDED[dt]
        if dt not in _NUMPY_NATIVE:
            raise TypeError(f"{dt} has no numpy name to record on disk")
        return str(np.dtype(_NUMPY_NATIVE[dt]))
    return str(np.dtype(dt))


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a numpy dtype name (or a torch/numpy dtype)."""
    if isinstance(name, torch.dtype):
        return name
    key = name if isinstance(name, str) else np.dtype(name).name
    try:
        return _BY_NAME[key]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def itemsize(dt) -> int:
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    return np.dtype(dt).itemsize


def is_float_kind(dt) -> bool:
    """numpy's ``dtype.kind == "f"``: float16/32/64 only. bfloat16 and the
    float8 types are kind ``"V"`` under ml_dtypes, so they are NOT float
    here — the quantize decision must not change the on-disk format."""
    if isinstance(dt, torch.dtype):
        return dt in (torch.float16, torch.float32, torch.float64)
    return np.dtype(dt).kind == "f"


# ------------------------------------------------------------------ pytrees
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(path part, child) pairs in JAX's flatten order, or None for a leaf."""
    if isinstance(node, OrderedDict):
        return [(k, node[k]) for k in node]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, values):
    if isinstance(node, OrderedDict):
        return OrderedDict(zip(node.keys(), values))
    if isinstance(node, dict):
        # JAX rebuilds every dict in sorted key order
        return dict(zip(sorted(node), values))
    if _is_namedtuple(node):
        return type(node)(*values)
    if isinstance(node, list):
        return list(values)
    return tuple(values)


def tree_map_with_path(fn, tree, is_leaf=None, _path=()):
    """Map ``fn(path, leaf)`` over leaves; ``None`` stays ``None``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree)
    kids = _children(tree)
    if kids is None:
        return fn(_path, tree)
    return _rebuild(tree, [tree_map_with_path(fn, c, is_leaf, _path + (p,))
                           for p, c in kids])


def tree_leaves_with_path(tree, is_leaf=None) -> list:
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf)
    return out


def path_str(path) -> str:
    """Stable string form of a key path (same strings as the JAX package)."""
    parts = [str(p) for p in path]
    return "/".join(parts) if parts else "<root>"


def _is_tensor(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, LocalShard))


def extract_tensors(state):
    """Split a state into ({key: tensor}, lean_tree_with_stubs)."""
    tensors: dict[str, object] = {}

    def take(path, leaf):
        if isinstance(leaf, np.ndarray) and leaf.ndim == 0:
            # 0-d numpy scalars ride in the lean object (cheaper than an extent)
            return leaf
        if not _is_tensor(leaf):
            return leaf
        key = path_str(path)
        if key in tensors:
            raise ValueError(f"duplicate tensor key {key}")
        tensors[key] = leaf
        return TensorStub(key, tuple(leaf.shape), dtype_name(leaf.dtype))

    lean_tree = tree_map_with_path(take, state)
    return tensors, lean_tree


class _LeanPickler(pickle._Pickler):
    """Pickles ``TensorStub`` under the JAX package's global name, so the
    blob is byte-identical to the one ``repro.core`` writes for the same
    tree (the pure-Python pickler emits the same opcodes as the C one)."""

    def save_global(self, obj, name=None):
        if obj is TensorStub:
            self.save(STUB_MODULE)
            self.save(STUB_NAME)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _LeanUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == (STUB_MODULE, STUB_NAME):
            return TensorStub
        return super().find_class(module, name)


def serialize_lean(lean_tree) -> bytes:
    buf = io.BytesIO()
    _LeanPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(lean_tree)
    return buf.getvalue()


def deserialize_lean(data: bytes):
    return _LeanUnpickler(io.BytesIO(data)).load()


def _is_stub(x) -> bool:
    return isinstance(x, TensorStub)


def reinsert_tensors(lean_tree, tensors: dict):
    """Inverse of extract_tensors: replace stubs with loaded tensors."""
    return tree_map_with_path(
        lambda _p, leaf: tensors[leaf.key] if _is_stub(leaf) else leaf,
        lean_tree, is_leaf=_is_stub)


def iter_stubs(lean_tree):
    for _p, leaf in tree_leaves_with_path(lean_tree, is_leaf=_is_stub):
        if _is_stub(leaf):
            yield leaf


def tensor_nbytes(t) -> int:
    return itemsize(t.dtype) * int(np.prod(tuple(t.shape), dtype=np.int64))


def to_numpy_view(t) -> np.ndarray:
    """Zero-copy contiguous numpy view of a host tensor's bytes; the dtype is
    numpy's for native types and a same-width unsigned int otherwise
    (bfloat16 comes back as uint16 — numpy has no bfloat16 of its own)."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t)
    if t.device.type != "cpu":
        raise ValueError(f"to_numpy_view needs a CPU tensor, got {t.device}")
    t = t.detach().contiguous()
    if t.dtype in _NUMPY_NATIVE:
        return t.numpy()
    return t.view(_UINT_OF[t.dtype.itemsize]).numpy()


_UINT_OF = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32, 8: torch.uint64}


def as_bytes_view(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 reinterpretation (buffer-protocol safe for ml_dtypes)."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    return arr.view(np.uint8).reshape(-1)


# ------------------------------------------- state exchange with numpy trees
def _np_to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.require(a, requirements="C")   # keeps 0-d arrays 0-d
    name = a.dtype.name
    if name in _EXTENDED.values():
        # torch.from_numpy refuses ml_dtypes types: go through the same-width
        # unsigned int and reinterpret
        t = torch.from_numpy(a.view(np.dtype(f"u{a.dtype.itemsize}")))
        t = t.view(_BY_NAME[name])
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def state_from_numpy(tree, device="cuda"):
    """numpy pytree (the form ``np.asarray`` gives the JAX package's arrays)
    -> the same tree with every array a torch tensor on ``device``."""
    return tree_map_with_path(
        lambda _p, x: _np_to_torch(x, device)
        if isinstance(x, np.ndarray) else x, tree)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _NUMPY_NATIVE:
        return t.numpy()
    import ml_dtypes   # test-side helper; the save/restore path never needs it
    return t.view(_UINT_OF[t.dtype.itemsize]).numpy().view(
        getattr(ml_dtypes, _EXTENDED[t.dtype]))


def state_to_numpy(tree):
    """Inverse of ``state_from_numpy``: every tensor becomes a host array."""
    return tree_map_with_path(
        lambda _p, x: tensor_to_numpy(x) if isinstance(x, torch.Tensor)
        else x, tree)
