"""Partition rules: DP x TP (x pod) with EP for MoE and ZeRO-1 moments.

Counterpart of ``repro/sharding/partition.py``, with the same name rules:
every parameter path maps to a spec, with divisibility guards (qwen2.5's 2
KV heads can't split 16 ways — they replicate; internvl2's 92553 vocab
shards on d_model instead). Stacked per-group block params get a leading
``None`` for the stack axis.

A spec keeps the reference's form: a tuple with one entry per tensor dim,
each ``None`` (whole), a mesh-axis name, or a tuple of names (the dim split
over those axes, the first the major one). ``placements`` turns it into
DTensor placements: a dim split over axes ``(a1, a2, ...)`` is ``Shard(dim)``
on each of those mesh dims, every other mesh dim ``Replicate()``. A
``Layout`` is a mesh with one spec and its placements; a ``DeviceMesh``'s
layout builds DTensors, an ``AbstractMesh``'s (``launch.mesh``) only sizes.

DP axes: ("pod", "data") when the pod axis exists, else ("data",).
TP/EP axis: "model".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.serialization import tree_leaves_with_path, tree_map_with_path
from ..launch.mesh import mesh_axes
from ..models.config import ModelConfig


def dp_axes(mesh) -> tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh, shape: tuple[int, ...] | None = None
               ) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``. With ``shape``, every
    split must be even (the rules' guards make it so): torch chunks a dim
    with ceil-sized chunks and JAX with equal ones, which agree only then."""
    from torch.distributed.tensor import Replicate, Shard
    axes = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(axes)
    used: set = set()
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        idx = [axes.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes of dim {dim} out of mesh order "
                             f"{axes}")
        if used & set(idx):
            raise ValueError(f"{spec}: a mesh axis splits two dims (named "
                             f"twice)")
        used |= set(idx)
        for i in idx:
            out[i] = Shard(dim)
        if shape is not None and names:
            k = int(np.prod([axis_size(mesh, n) for n in names]))
            if shape[dim] % k:
                raise ValueError(f"{spec}: dim {dim} of {shape} does not "
                                 f"split evenly {k} ways")
    return tuple(out)


def local_shape(spec: tuple, mesh, shape: tuple[int, ...]) -> tuple:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for n in _axes_of(entry):
            out[dim] //= axis_size(mesh, n)
    return tuple(out)


@dataclass(frozen=True)
class Layout:
    """A mesh and the spec of one tensor on it (``placements`` derived)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def placements_for(self, shape) -> tuple:
        """``placements``, checking that a tensor of ``shape`` splits
        evenly."""
        return placements(self.spec, self.mesh, tuple(shape))

    def local_shape(self, shape) -> tuple:
        return local_shape(self.spec, self.mesh, tuple(shape))

    def distribute(self, t):
        """``t`` (whole, on every rank alike) as a DTensor of this layout:
        each rank keeps its window, nothing is communicated."""
        from torch.distributed.tensor import DTensor
        place = self.placements_for(t.shape)
        local = _window(t, self.spec, self.mesh)
        # a window is a copy of its own, never a view holding all of ``t``
        local = local.clone() if local.numel() < t.numel() \
            else local.contiguous()
        return DTensor.from_local(
            local, self.mesh, place, run_check=False, shape=t.shape,
            stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple:
    return tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                 for i in range(len(shape)))


def window(spec: tuple, mesh, shape, coord) -> tuple:
    """The ((start, stop), ...) window, per tensor dim, of the device at
    mesh coordinate ``coord`` of a tensor of ``shape`` laid out by
    ``spec`` (even splits, the first axis of a dim the major one)."""
    axes = list(mesh_axes(mesh))
    out = [(0, int(d)) for d in shape]
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        if not names:
            continue
        pos = 0
        for n in names:
            pos = pos * axis_size(mesh, n) + coord[axes.index(n)]
        step = shape[dim] // int(np.prod([axis_size(mesh, n)
                                          for n in names]))
        out[dim] = (pos * step, (pos + 1) * step)
    return tuple(out)


def _window(t, spec: tuple, mesh):
    """This rank's window of the whole tensor ``t`` under ``spec``."""
    for dim, (lo, hi) in enumerate(window(spec, mesh, tuple(t.shape),
                                          mesh.get_coordinate())):
        t = t.narrow(dim, lo, hi - lo)
    return t


class Partitioner:
    def __init__(self, cfg: ModelConfig, mesh, fsdp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = fsdp   # additionally shard params over 'data' (ZeRO-3)
        self.model = axis_size(mesh, "model")
        self.dp = dp_axes(mesh)
        self.dp_size = int(np.prod([axis_size(mesh, a) for a in self.dp]))

    def layout(self, spec: tuple) -> Layout:
        return Layout(self.mesh, tuple(spec))

    # ------------------------------------------------------------- params
    def param_spec(self, path: tuple[str, ...], shape: tuple[int, ...]
                   ) -> tuple:
        name = path[-1]
        stacked = "blocks" in path      # leading stack axis
        lead = (None,) if stacked else ()
        body = shape[1:] if stacked else shape
        m = self.model

        def guard(spec_entries):
            # each sharded dim must divide; else replicate that entry
            out = []
            for dim, e in zip(body, spec_entries):
                out.append(e if (e is None or _div(dim, m)) else None)
            return (*lead, *out)

        if name == "embed":
            return (("model", None) if _div(shape[0], m)
                    else guard((None, "model")))
        if name == "head":
            return guard((None, "model"))
        if name == "frontend_proj":
            return guard((None, "model"))
        if name in ("wq", "wk", "wv", "w_up1", "w_up2", "wg", "wu", "wx",
                    "wgate", "w_input_gate", "w_a_gate", "w_up",
                    "w_i", "w_f", "w_z", "w_o", "r_i", "r_f", "r_z", "r_o"):
            if len(body) == 3:   # MoE expert-stacked (E, d, f): EP on experts
                return guard(("model", None, None))
            return guard((None, "model"))
        if name in ("wo", "wd", "w_down", "wout"):
            if len(body) == 3:   # MoE (E, f, d)
                return guard(("model", None, None))
            return guard(("model", None))
        if name == "router":
            return guard((None, None))
        if name in ("bq", "bk", "bv", "a_param", "b_input_gate", "b_a_gate"):
            return guard(("model",))
        if name in ("b_i", "b_f", "b_z", "b_o", "b_igate", "b_fgate",
                    "w_igate", "w_fgate"):
            return guard(tuple(None for _ in body))
        # norms' scale and the rest: replicate
        return (*lead, *(None for _ in body))

    def _fsdp_spec(self, pspec: tuple, shape: tuple[int, ...],
                   stacked: bool) -> tuple:
        """ZeRO-3: add 'data' to the first unsharded divisible dim, skipping
        the leading layer-stack dim."""
        if not self.fsdp or "data" not in mesh_axes(self.mesh):
            return pspec
        entries = list(pspec) + [None] * (len(shape) - len(pspec))
        dsize = axis_size(self.mesh, "data")
        start = 1 if stacked else 0
        for i in range(start, len(shape)):
            if entries[i] is None and _div(shape[i], dsize) \
                    and shape[i] >= dsize:
                entries[i] = "data"
                return tuple(entries)
        return pspec

    def param_specs(self, params):
        """Tree of specs matching a params tree (tensors or ``meta``)."""
        def one(path, leaf):
            names = tuple(str(p) for p in path)
            shape = tuple(leaf.shape)
            spec = self.param_spec(names, shape)
            return self._fsdp_spec(spec, shape, stacked="blocks" in names)
        return tree_map_with_path(one, params)

    def param_shardings(self, params):
        """Tree of ``Layout``s matching a params tree."""
        return _layouts(self, self.param_specs(params))

    # ------------------------------------------------------------ optimizer
    def zero1_spec(self, pspec: tuple, shape: tuple[int, ...]) -> tuple:
        """Add 'data' sharding to the first unsharded, divisible dim."""
        if "data" not in mesh_axes(self.mesh):
            return pspec
        entries = list(pspec) + [None] * (len(shape) - len(pspec))
        dsize = axis_size(self.mesh, "data")
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and _div(dim, dsize) and dim >= dsize:
                entries[i] = "data"
                return tuple(entries)
        return pspec

    def moment_specs(self, params):
        def one(path, leaf):
            names = tuple(str(p) for p in path)
            shape = tuple(leaf.shape)
            ps = self.param_spec(names, shape)
            if self.fsdp:   # ZeRO-3: moments follow the fsdp param layout
                return self._fsdp_spec(ps, shape, stacked="blocks" in names)
            return self.zero1_spec(ps, shape)   # ZeRO-1: over data
        return tree_map_with_path(one, params)

    def opt_shardings(self, params):
        moments = _layouts(self, self.moment_specs(params))
        return {"mu": moments, "nu": moments, "count": self.replicated()}

    def state_shardings(self, state):
        """Layouts of a whole train state {params, opt, step}."""
        return {"params": self.param_shardings(state["params"]),
                "opt": self.opt_shardings(state["params"]),
                "step": self.replicated()}

    # ------------------------------------------------------------ activations
    def batch_spec(self, batch: int) -> tuple:
        """The batch dim split over the DP axes only where ``batch`` divides
        (long_500k has B = 1)."""
        return (self.dp if batch % self.dp_size == 0 else None,)

    def tokens_sharding(self, batch: int) -> Layout:
        return self.layout((*self.batch_spec(batch), None))

    def frontend_sharding(self, batch: int) -> Layout:
        return self.layout((*self.batch_spec(batch), None, None))

    def activation_spec(self, batch: int) -> tuple:
        return (*self.batch_spec(batch), None, None)

    def cache_specs(self, cache):
        """Decode caches: batch over DP; KV-head dim over model if divisible.

        The reference Partitioner's rule, kept and pinned against it; the
        reference's own ``cache_shardings`` raises as it stands (ROADMAP
        §C). The live server does NOT use it: ``init_cache(layouts=)`` takes
        ``launch.specs.serve_cache_layouts``, the rule the reference's
        decode cells compile with, which also splits ``lru_dim`` and, where
        the KV heads cannot split, the cache timeline — so the dry run's
        decode bytes are the server's."""
        def one(_path, leaf):
            shape = tuple(leaf.shape)
            entries: list = [None]  # stacked group axis
            if len(shape) >= 2:
                entries.append(self.dp)
            for dim in shape[2:]:
                if dim == self.cfg.num_kv_heads and \
                        _div(self.cfg.num_kv_heads, self.model):
                    entries.append("model")
                elif dim == self.cfg.num_heads and \
                        _div(self.cfg.num_heads, self.model):
                    entries.append("model")
                else:
                    entries.append(None)
            return tuple(entries[:len(shape)])   # scalar leaves (pos)
        return tree_map_with_path(one, cache)

    def cache_shardings(self, cache):
        return _layouts(self, self.cache_specs(cache))

    def replicated(self) -> Layout:
        return self.layout(())


def _layouts(part: Partitioner, specs):
    return tree_map_with_path(lambda _p, s: part.layout(s), specs,
                              is_leaf=lambda x: isinstance(x, tuple))


def shard_tree(tree, layouts):
    """Whole tensors -> DTensors of the matching ``Layout`` tree."""
    flat = dict(tree_leaves_with_path(
        layouts, is_leaf=lambda x: isinstance(x, Layout)))
    return tree_map_with_path(lambda p, t: flat[p].distribute(t), tree)
