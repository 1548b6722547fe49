"""The port's sharding layer against the JAX package, on meshes that hold no
devices (``jax.sharding.AbstractMesh`` beside the port's ``AbstractMesh``).

For all ten archs on 16x16, 2x16x16 and 4x4: every param and moment leaf's
spec equals the reference ``Partitioner``'s ``PartitionSpec`` (with and
without FSDP), and so does every decode-cache leaf's. For the 80 (arch x
shape x mesh) dry-run cells of the production meshes: every argument
leaf's per-device shape and the per-device argument bytes equal the
reference ``input_specs``' (``sharding.shard_shape`` of each leaf), with
the same ``long_500k`` skips. Tolerance: exact.
"""

import functools
import types

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.configs import ARCH_IDS, get_config as ref_config
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import transformer as RT
from repro.models.config import SHAPES_BY_NAME as REF_SHAPES
from repro.sharding.partition import Partitioner as RefPartitioner
from repro.train.steps import init_train_state as ref_init
from repro_torch.configs import get_config
from repro_torch.core.serialization import tree_leaves_with_path
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.specs import arg_leaves, cell_args, input_specs
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.sharding.partition import Partitioner, placements
from repro_torch.train.steps import init_train_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}


def _entries(spec, ndim: int) -> tuple:
    """A spec (the reference's PartitionSpec or the port's tuple) as one
    tuple of mesh-axis names per tensor dim."""
    out = list(spec) + [None] * (ndim - len(spec))
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in out)


@functools.lru_cache(maxsize=None)
def _ref_state_shape(arch: str):
    cfg = ref_config(arch)
    return jax.eval_shape(lambda: ref_init(jax.random.key(0), cfg))


def _ref_specs(shardings) -> dict:
    """keystr -> PartitionSpec of a tree of NamedShardings."""
    return {jax.tree_util.keystr(p): s.spec
            for p, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _key(path) -> str:
    return "".join(f"['{k}']" for k in path)


def _port_specs(tree) -> dict:
    """keystr -> spec tuple of a tree of the port's specs."""
    return {_key(p): s for p, s in tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))}


def _port_ndims(tree) -> dict:
    return {_key(p): leaf.ndim for p, leaf in tree_leaves_with_path(tree)}


def _ref_cache_specs(part, cache_shape, monkeypatch) -> dict:
    """The reference ``Partitioner.cache_shardings``' rule, leaf by leaf. As
    it stands the method maps a two-argument ``one(path, leaf)`` with
    ``jax.tree_util.tree_map`` (which passes the leaf alone), and for some
    archs its rule names ``model`` on two dims, which ``NamedSharding``
    refuses; so it runs with ``tree_map_with_path`` in that name and a
    ``NamedSharding`` that keeps the spec unchecked."""
    import repro.sharding.partition as ref_partition
    with monkeypatch.context() as m:
        m.setattr(jax.tree_util, "tree_map", jax.tree_util.tree_map_with_path)
        m.setattr(ref_partition, "NamedSharding",
                  lambda mesh, spec: types.SimpleNamespace(spec=spec))
        return _ref_specs(part.cache_shardings(cache_shape))


def _jax_accepts(spec, sizes, axes) -> bool:
    from jax._src.named_sharding import DuplicateSpecError
    try:
        jax.sharding.NamedSharding(RefAbstractMesh(sizes, axes), spec)
    except DuplicateSpecError:
        return False
    return True


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_moment_and_cache_specs_match_the_reference(arch, monkeypatch):
    shape = _ref_state_shape(arch)
    meta = init_train_state(get_config(arch), device="meta")
    ref_cache = jax.eval_shape(lambda: RT.init_cache(ref_config(arch), 32,
                                                     64))
    cache = T.init_cache(get_config(arch), 32, 64, device="meta")
    ndims, cache_ndims = _port_ndims(meta["params"]), _port_ndims(cache)
    for name, (sizes, axes) in MESHES.items():
        for fsdp in (False, True):
            ref = RefPartitioner(ref_config(arch),
                                 RefAbstractMesh(sizes, axes), fsdp=fsdp)
            port = Partitioner(get_config(arch), AbstractMesh(sizes, axes),
                               fsdp=fsdp)
            pairs = [(_ref_specs(ref.param_shardings(shape["params"])),
                      _port_specs(port.param_specs(meta["params"])), ndims),
                     (_ref_specs(ref.opt_shardings(shape["params"])["mu"]),
                      _port_specs(port.moment_specs(meta["params"])), ndims),
                     (_ref_cache_specs(ref, ref_cache, monkeypatch),
                      _port_specs(port.cache_specs(cache)), cache_ndims)]
            for want, got, nd in pairs:
                assert want.keys() == got.keys()
                for k in want:
                    assert _entries(got[k], nd[k]) == \
                        _entries(want[k], nd[k]), (name, fsdp, k)
            # a layout JAX refuses (an axis on two dims) is refused here too
            mesh = AbstractMesh(sizes, axes)
            for k, spec in pairs[2][0].items():
                if _jax_accepts(spec, sizes, axes):
                    placements(pairs[2][1][k], mesh)
                else:
                    with pytest.raises(ValueError, match="twice"):
                        placements(pairs[2][1][k], mesh)
            assert _ref_specs(ref.opt_shardings(shape["params"])["count"]) \
                == {"": jax.sharding.PartitionSpec()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_cells_match_the_reference_specs(arch):
    """Every cell of ``arch`` on both production meshes: per-leaf local
    shapes and per-device argument bytes against the reference specs."""
    for multi_pod in (False, True):
        sizes, axes = MESHES["2x16x16" if multi_pod else "16x16"]
        for shape_name in SHAPES_BY_NAME:
            rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod,
                                  step=False)
            cfg = ref_config(arch)
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok", rec.get("traceback")
            info = ref_input_specs(cfg, REF_SHAPES[shape_name],
                                   RefAbstractMesh(sizes, axes))
            args = info["specs"][:2] if info["mode"] != "decode" \
                else info["specs"][:4]
            want = [(tuple(leaf.sharding.shard_shape(leaf.shape)),
                     leaf.dtype.itemsize)
                    for a in args
                    for leaf in jax.tree_util.tree_leaves(a)]
            got = [(tuple(v), None) for v in
                   rec["per_device"]["local_shapes"].values()]
            assert [w for w, _ in want] == [g for g, _ in got], shape_name
            assert rec["per_device"]["argument_bytes"] == sum(
                int(np.prod(s, dtype=np.int64)) * b for s, b in want)
            assert rec["model"]["params"] == cfg.param_count()


def test_dryrun_cli_sweeps_every_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--both-meshes", "--specs-only"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "80/80 cells ok, 0 errors" in out
    assert out.count("[skipped]") == 16


def test_placements_split_major_to_minor_and_refuse_uneven_splits():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="evenly"):
        placements(("model",), mesh, (24,))
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(("model", "model"), mesh)
    spec = input_specs(get_config("qwen2.5-3b"), SHAPES_BY_NAME["long_500k"],
                       mesh)
    # B = 1 does not split over the DP axes
    _, _, tok, pos, _, _ = spec["specs"]
    assert tok.layout.spec == (None, None) and tok.local_shape == (1, 1)
    assert dict(arg_leaves(cell_args(spec)[0]))["embed"].local_shape == \
        (151936 // 16, 2048)
    # internvl2's 92553-row vocab does not split 16 ways: d_model does
    part = Partitioner(get_config("internvl2-26b"), mesh)
    assert part.param_spec(("embed",), (92553, 6144)) == (None, "model")
