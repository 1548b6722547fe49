"""Extraction and the lean object: the port against ``repro.core``.

Named after the traps found while porting: (1) flatten order — JAX sorts
dict keys and drops ``None``, ``torch.utils._pytree`` does neither; (2) the
lean blob pickles the JAX package's ``TensorStub`` class name; (3) dtype
names are numpy's and bfloat16 is not "float" for the quantize decision;
(5) a typed PRNG key saved by JAX restores in the port as its key data.
"""

import pickle
from collections import OrderedDict, namedtuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.utils._pytree as torch_pytree

from repro.core import serialization as ref_ser
from repro_torch.core import serialization as ser

from _torch_port import (np_state, port_manager, ref_manager, to_jax,
                         to_numpy, to_port)

Pair = namedtuple("Pair", ["b", "a"])


def _mixed_tree(rng):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"zeta": f32(3), "alpha": {"y": f32(2, 2), "x": None,
                                      "b": [f32(1), None, (f32(4),)]},
            "m": Pair(b=f32(2), a=np.arange(3, dtype=np.int32)),
            "od": OrderedDict([("k2", f32(1)), ("k1", f32(1))]),
            "lean": {"s": "text", "n": 3, "f": 0.5},
            "scalar": np.asarray(1.5, np.float32)}


def test_flatten_order_is_jax_not_torch_pytree(rng):
    """Trap 1: put order sets file offsets, so the port flattens as JAX."""
    tree = _mixed_tree(rng)
    ref_keys = list(ref_ser.extract_tensors(to_jax(tree))[0])
    port_keys = list(ser.extract_tensors(to_port(tree))[0])
    assert port_keys == ref_keys
    # torch's own pytree would keep insertion order and None leaves
    leaves, _ = torch_pytree.tree_flatten_with_path(to_port(tree))
    assert [ser.path_str(tuple(getattr(k, "key", getattr(k, "idx", None))
                               for k in p)) for p, _ in leaves] != ref_keys


def test_lean_blob_is_byte_identical_and_cross_readable(rng):
    """Trap 2: the port pickles stubs under repro.core's class name."""
    tree = np_state(1)
    ref_tensors, ref_lean = ref_ser.extract_tensors(to_jax(tree))
    port_tensors, port_lean = ser.extract_tensors(to_port(tree))
    ref_blob = ref_ser.serialize_lean(ref_lean)
    port_blob = ser.serialize_lean(port_lean)
    assert port_blob == ref_blob
    assert b"repro.core.serialization" in port_blob
    assert b"repro_torch" not in port_blob
    # the reference reads the port's blob with its own class, and back
    back = ref_ser.deserialize_lean(port_blob)
    assert [s.key for s in ref_ser.iter_stubs(back)] == list(ref_tensors)
    mine = ser.deserialize_lean(ref_blob)
    stubs = list(ser.iter_stubs(mine))
    assert [s.key for s in stubs] == list(port_tensors)
    assert all(isinstance(s, ser.TensorStub) for s in stubs)
    assert mine["data"] == tree["data"]


def test_dtype_names_are_numpy_names():
    """Trap 3a: records carry numpy names, never torch's."""
    for dt, name in [(torch.bfloat16, "bfloat16"), (torch.float32, "float32"),
                     (torch.int8, "int8"), (torch.uint32, "uint32"),
                     (torch.bool, "bool")]:
        assert ser.dtype_name(dt) == name
        assert ser.torch_dtype(name) is dt
    assert not ser.is_float_kind(torch.bfloat16)
    assert ser.is_float_kind(torch.float16)
    assert np.dtype(ml_dtypes.bfloat16).kind == "V"


def test_bf16_under_a_quantize_prefix_is_saved_unquantized(tmp_path):
    """Trap 3b: numpy's kind "f" test excludes bfloat16, in both packages."""
    tree = {"opt": {"mu": {"w": np.ones((64, 512), ml_dtypes.bfloat16),
                           "v": np.ones((64, 512), np.float32)}}}
    kw = dict(quantize_prefixes=("opt/mu",), quantize_min_bytes=1024)
    with ref_manager(tmp_path / "ref", **kw) as r:
        r.save(1, to_jax(tree))
    with port_manager(tmp_path / "port", **kw) as p:
        p.save(1, to_port(tree))
    from repro_torch.core import Manifest
    for d in ("ref", "port"):
        m = Manifest.load(str(tmp_path / d / "step_00000001"))
        assert m.extra["quantized"] == ["opt/mu/v"]
        assert m.tensors["opt/mu/w"].dtype == "bfloat16"


def test_jax_prng_key_restores_as_key_data(tmp_path):
    """Trap 5: no torch twin of a typed key — its uint32 data comes back."""
    key = jax.random.key(42)
    with ref_manager(tmp_path) as r:
        r.save(1, {"rng": key, "w": jnp.ones(4)})
    with port_manager(tmp_path) as p:
        out = p.restore()
    assert out["rng"].dtype == torch.uint32
    assert np.array_equal(out["rng"].numpy(),
                          np.asarray(jax.random.key_data(key)))


def test_state_numpy_round_trip_keeps_bits():
    tree = np_state(3)
    back = to_numpy(to_port(tree))
    assert back["params"]["w"].dtype == ml_dtypes.bfloat16
    assert back["params"]["w"].tobytes() == tree["params"]["w"].tobytes()
    assert back["step"].shape == () and int(back["step"]) == 7
    assert back["data"] == tree["data"]


def test_port_stub_pickles_with_the_stock_pickler_too():
    """The stub is an ordinary dataclass: a plain pickle round trip (its own
    module name) still works for in-process use."""
    stub = ser.TensorStub("k", (2,), "float32")
    assert pickle.loads(pickle.dumps(stub)) == stub


@pytest.mark.parametrize("leaf", [np.float32(1.0), 3, "s", None])
def test_non_tensor_leaves_ride_in_the_lean_object(leaf):
    tree = {"a": leaf, "t": np.zeros(2, np.float32)}
    tensors, lean = ser.extract_tensors(to_port(tree))
    assert list(tensors) == ["t"]
    assert lean["a"] == leaf or (leaf is None and lean["a"] is None)
