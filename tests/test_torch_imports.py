"""The port stands alone: it imports with JAX blocked, names nothing of the
JAX package, and its committed state inventory is the JAX package's."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config
from repro.core.serialization import path_str as ref_path_str
from repro.train.steps import init_train_state
from repro_torch.configs import (leaf_shapes, make_train_state,
                                 train_state_inventory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
# ``repro`` as a module, not ``repro_torch``
REF_IMPORT = re.compile(r"^\s*(import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                        re.M)


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "repro_torch.core.checkpoint" in mods
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_file_of_the_port_imports_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    offenders = []
    for path in files:
        with open(path) as f:
            if REF_IMPORT.search(f.read()):
                offenders.append(path)
    assert not offenders


def test_inventory_is_the_jax_train_state():
    """Pins the smoke's qwen2.5-3b inventory: key, shape and dtype of all
    44 leaves, regenerated without allocating (jax.eval_shape)."""
    shapes = jax.eval_shape(lambda: init_train_state(
        jax.random.key(0), get_config("qwen2.5-3b")))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = [{"key": ref_path_str(p), "shape": list(l.shape),
             "dtype": str(l.dtype)} for p, l in flat]
    inv = train_state_inventory("qwen2.5-3b")
    assert len(want) == 44
    assert inv["leaves"] == want
    total = sum(int(np.prod(e["shape"])) * (2 if e["dtype"] == "bfloat16"
                                            else 4) for e in want)
    assert round(total / 2**30, 2) == 28.74


def test_depth_cut_keeps_every_width():
    inv = train_state_inventory("qwen2.5-3b")
    full = {k: s for k, s, _ in leaf_shapes(inv)}
    cut = {k: (s, d) for k, s, d in leaf_shapes(inv, layers=2)}
    for key, shape in full.items():
        if "/blocks/" in key:
            assert cut[key][0] == (2,) + shape[1:]
        else:
            assert cut[key][0] == shape
    assert cut["params/embed"][1] is torch.bfloat16
    assert cut["opt/mu/embed"][1] is torch.float32


def test_make_train_state_layout_on_cpu():
    inv = json.loads(json.dumps(train_state_inventory("qwen2.5-3b")))
    for leaf in inv["leaves"]:        # narrow copy: a CPU-sized check
        leaf["shape"] = [min(d, 8) if i else d
                         for i, d in enumerate(leaf["shape"])]
    state = make_train_state(inv, device="cpu", seed=3, layers=1)
    again = make_train_state(inv, device="cpu", seed=3, layers=1)
    assert torch.equal(state["opt"]["nu"]["embed"],
                       again["opt"]["nu"]["embed"])
    assert bool((state["opt"]["nu"]["embed"] >= 0).all())
    assert state["params"]["final_norm"]["scale"].dtype is torch.float32
    assert state["step"].shape == () and int(state["step"]) == 0


def test_kernel_build_is_lazy():
    """Importing the kernels builds nothing; the build targets a
    git-ignored directory inside the checkout."""
    from repro_torch.kernels import _lib
    assert _lib._lib is None or torch.cuda.is_available()
    assert os.path.relpath(_lib.BUILD_DIR, ROOT).split(os.sep)[0] == "build"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()


REPLACED = {"quantize.cu": "quantize.py", "fingerprint.cu": "fingerprint.py",
            "rglru.cu": "rglru.py"}


@pytest.mark.parametrize("source", list(REPLACED))
def test_kernel_sources_name_what_they_replace(source):
    with open(os.path.join(PORT, "kernels", "csrc", source)) as f:
        text = f.read()
    assert f"Replaces repro/kernels/{REPLACED[source]}" in text
    assert "Bound on the H100" in text or "Bound:" in text
