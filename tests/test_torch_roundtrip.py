"""Cross-package round trips: a step saved by one package restores
bit-exactly through the other, in both directions, and both packages write
the same bytes for the same state.

Covers FILE_PER_TENSOR, FILE_PER_PROCESS and SINGLE_FILE, each quantized and
plain, on the streaming path. Data files must be byte-identical;
``manifest.json`` must be equal except for ``_torch_port.VOLATILE_FIELDS``.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import Manifest
from repro_torch.core.serialization import extract_tensors

from _torch_port import (QUANT, STRATEGIES, VOLATILE_FIELDS, dir_files,
                         leaves_bytes, normalize_manifest, np_state,
                         port_manager, ref_manager, to_jax, to_port)

STEP_DIR = "step_00000003"


def _save_both(tmp_path, strategy, quantize, **kw):
    kw = dict(kw, quantize_prefixes=QUANT if quantize else (),
              quantize_min_bytes=1024)
    tree = np_state(0)
    with ref_manager(tmp_path / "ref", strategy, **kw) as r:
        r.save(3, to_jax(tree))
    with port_manager(tmp_path / "port", strategy, **kw) as p:
        p.save(3, to_port(tree))
    return tree, kw


def _assert_same_bytes(a: str, b: str):
    fa, fb = dir_files(a), dir_files(b)
    ma, mb = fa.pop("manifest.json"), fb.pop("manifest.json")
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    assert normalize_manifest(ma) == normalize_manifest(mb), VOLATILE_FIELDS


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_both_packages_write_identical_steps(tmp_path, strategy, quantize):
    _save_both(tmp_path, strategy, quantize)
    _assert_same_bytes(str(tmp_path / "ref" / STEP_DIR),
                       str(tmp_path / "port" / STEP_DIR))


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_cross_package_restore(tmp_path, direction, strategy, quantize):
    """A step restores in the other package to the bytes its own package
    restores (quantized tensors: the same decode, bit for bit)."""
    _tree, kw = _save_both(tmp_path, strategy, quantize)
    writer = "port" if direction == "port_to_ref" else "ref"
    with ref_manager(tmp_path / writer, strategy, **kw) as r:
        by_ref = leaves_bytes(r.restore(step=3))
    with port_manager(tmp_path / writer, strategy, **kw) as p:
        by_port = leaves_bytes(p.restore(step=3))
    assert by_port == by_ref


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
def test_plain_tensors_restore_bit_exact(tmp_path, quantize):
    """Unquantized tensors come back bit-exact; quantized ones as the
    decode of their int8 payload (same dtype and shape)."""
    tree, kw = _save_both(tmp_path, "single_file", quantize)
    with port_manager(tmp_path / "ref", **kw) as p:
        got, _ = extract_tensors(p.restore(step=3))
    qset = set(Manifest.load(str(tmp_path / "ref" / STEP_DIR))
               .extra.get("quantized", ()))
    assert bool(qset) == quantize
    want, _ = extract_tensors(to_port(tree))
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        if key not in qset:
            assert torch.equal(g.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), key


def test_restore_places_on_the_template_device(tmp_path):
    """No template: the manager's device. Template tensors: theirs."""
    _tree, kw = _save_both(tmp_path, "single_file", True)
    tmpl = to_port(np_state(0))
    with port_manager(tmp_path / "ref", **kw) as p:
        out = p.restore(state_template=tmpl, step=3)
    assert out["opt"]["mu"]["w"].device.type == "cpu"
    assert out["params"]["w"].dtype == tmpl["params"]["w"].dtype


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
def test_legacy_paths_match_the_reference(tmp_path, quantize):
    """``streaming=False`` (monolithic save and restore) in both packages."""
    _save_both(tmp_path, "file_per_tensor", quantize, streaming=False)
    _assert_same_bytes(str(tmp_path / "ref" / STEP_DIR),
                       str(tmp_path / "port" / STEP_DIR))
    kw = dict(quantize_prefixes=QUANT if quantize else (), streaming=False)
    with port_manager(tmp_path / "ref", "file_per_tensor", **kw) as p:
        mono = leaves_bytes(p.restore(step=3))
    with port_manager(tmp_path / "ref", "file_per_tensor",
                      quantize_prefixes=kw["quantize_prefixes"]) as p:
        streamed = leaves_bytes(p.restore(step=3))
    assert mono == streamed
    assert os.path.isdir(tmp_path / "port" / STEP_DIR)
    assert np.all([v is not None for v in mono.values()])
