"""The port's dry run reads each cell's memory off its step: the peak of the
live local bytes, its outputs and the outputs that are argument storage,
held against the same step on real CPU tensors and against the reference's
``compiled.memory_analysis()``.

Cells: reduced qwen2.5-3b and olmoe-1b-7b (2 layers, width / 4, vocab
512) at train (4 x 64 tokens, the reference's 2 microbatches), prefill
(4 x 64) and decode (4 tokens against 64 cache slots) on a 2x2 (data,
model) mesh. The port's cells run in one subprocess (a process holds one
fake process group at a time), the reference's ``_jit_cell`` compiles in
another with 4 host devices.

Meta against CPU: the same step on zero-filled CPU local blocks frees its
tensors at the same points, so every field must be equal. (Two meta
kernels return a fresh tensor where the device's op returns its input —
``_wrap_tensor_autograd`` and ``wait_tensor`` of a collective's result —
and ``dryrun.LiveBytes`` counts those as the one allocation they are.)

Against the reference: ``alias_bytes`` must be equal (the train state and
the decode caches, updated in place here, donated there), and
``argument_bytes`` too, but for the prefill's ``labels``, which the
prefill never reads and ``jax.jit`` drops from its arguments;
``output_bytes`` differs by three named amounts:

- XLA counts the output tuple's index table, 8 bytes a leaf, in its
  output size (a single-array output, the prefill's, has none);
- under microbatches the port's ``nll`` metric is the loss tensor itself,
  one storage for two leaves (4 bytes);
- the port's decode logits keep the vocab whole on every rank
  (``transformer.decode_step``); the reference's stay split over
  ``model``.
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b")
KINDS = ("train", "prefill", "decode")
DP, TP = 2, 2
TIMEOUT = 300
CELLS = [(a, k) for a in ARCHS for k in KINDS]
FIELDS = ("output_bytes", "alias_bytes", "temp_bytes", "peak_hbm_bytes")


def narrow(get_config, arch):
    return get_config(arch).scaled_down(layers=2, width_div=4, vocab=512)


def shapes(ShapeConfig):
    return {"train": ShapeConfig("train_4k", 64, 4, "train"),
            "prefill": ShapeConfig("prefill_32k", 64, 4, "prefill"),
            "decode": ShapeConfig("decode_32k", 64, 4, "decode")}


PORT = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_mesh, measure_cell, run_step
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import ShapeConfig
from test_torch_dryrun_mem import ARCHS, DP, TP, narrow, shapes
out = {}
for arch in ARCHS:
    cfg = narrow(get_config, arch)
    for kind, shape in shapes(ShapeConfig).items():
        rec = measure_cell(cfg, shape, (DP, TP), ("data", "model"))
        with fake_mesh((DP, TP), ("data", "model")) as mesh:
            info = input_specs(cfg, shape, mesh)
            cpu = run_step(cfg, shape, mesh, info, rec["microbatches"],
                           device="cpu")[2]
        out[f"{arch}/{kind}"] = {"meta": rec, "cpu": cpu}
json.dump(out, open(sys.argv[1], "w"))
print("PORT-OK")
"""

REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax
from repro.configs import get_config
from repro.launch.dryrun import _jit_cell
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import input_specs
from repro.models.config import ShapeConfig
from test_torch_dryrun_mem import ARCHS, DP, TP, narrow, shapes
mesh = make_host_mesh(DP, TP)
out = {}
for arch in ARCHS:
    cfg = narrow(get_config, arch)
    for kind, shape in shapes(ShapeConfig).items():
        si = input_specs(cfg, shape, mesh)
        fn, args = _jit_cell(cfg, shape, mesh, si["mode"], si["specs"])
        with mesh:
            compiled = fn.lower(*args).compile()
        mem = compiled.memory_analysis()
        out[f"{arch}/{kind}"] = {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
            "leaves": len(jax.tree.leaves(compiled.out_info))}
json.dump(out, open(sys.argv[1], "w"))
print("REF-OK")
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(port records, reference memory analyses) by "arch/kind"."""
    d = tmp_path_factory.mktemp("dryrun_mem")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + ROOT, OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, str(d / f"{name}.json"), HERE],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, script in (("port", PORT), ("ref", REF))}
    try:
        for name, p in procs.items():
            log = p.communicate(timeout=TIMEOUT)[0]
            assert p.returncode == 0 and f"{name.upper()}-OK" in log, \
                log[-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(d / "port.json") as f, open(d / "ref.json") as g:
        return json.load(f), json.load(g)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_meta_memory_equals_the_same_step_on_cpu(cells, arch, kind):
    rec = cells[0][f"{arch}/{kind}"]
    pd = rec["meta"]["per_device"]
    assert rec["meta"]["status"] == "ok", rec["meta"].get("error")
    assert {k: pd[k] for k in FIELDS} == rec["cpu"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_peak_holds_the_reference_identity(cells, arch, kind):
    pd = cells[0][f"{arch}/{kind}"]["meta"]["per_device"]
    assert pd["temp_bytes"] >= 0 and pd["output_bytes"] > 0
    assert pd["peak_hbm_bytes"] >= pd["argument_bytes"] > 0
    assert pd["peak_hbm_bytes"] == (pd["argument_bytes"] + pd["output_bytes"]
                                    + pd["temp_bytes"] - pd["alias_bytes"])
    if kind == "prefill":
        assert pd["alias_bytes"] == 0
    else:       # the whole state (train) or every cache (decode) in place
        assert pd["alias_bytes"] > 0.9 * pd["output_bytes"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_outputs_and_aliases_match_the_reference(cells, arch, kind):
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig
    port, ref = cells
    pd, theirs = port[f"{arch}/{kind}"]["meta"]["per_device"], \
        ref[f"{arch}/{kind}"]
    shape = shapes(ShapeConfig)[kind]
    rows = shape.global_batch // DP
    labels = rows * shape.seq_len * 4 if kind == "prefill" else 0
    assert pd["argument_bytes"] - labels == theirs["argument_bytes"]
    assert pd["alias_bytes"] == theirs["alias_bytes"]
    # XLA's output tuple index table
    want = theirs["output_bytes"] - (8 * theirs["leaves"]
                                     if theirs["leaves"] > 1 else 0)
    if kind == "train":
        want -= 4                          # nll is the loss's own storage
    elif kind == "decode":
        logits = rows * narrow(get_config, arch).vocab_size * 4
        want += logits - logits // TP     # the vocab whole, not over model
    assert pd["output_bytes"] == want, (pd["output_bytes"], theirs)
