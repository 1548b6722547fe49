"""The port's dry run runs each cell's step on a fake process group: its
per-device FLOPs held to ``benchmarks/roofline.analytic_terms`` and its
collective kinds to the reference's compiled HLO.

Cells: reduced qwen2.5-3b and olmoe-1b-7b (2 layers, width / 4, vocab
512: qwen 4 query heads over 2 KV heads, olmoe 8 experts of 512 x 256,
top-2) at train (8 x 256 tokens, 4 microbatches), prefill (8 x 256) and
decode (8 tokens against 256 cache slots) on a 2x4 (data, model) mesh;
and production olmoe-1b-7b ``decode_32k``, the two MoE configs'
``prefill_32k``, the GQA cells of ``PRODUCTION_GQA`` and xlstm-350m
``prefill_32k`` (the xLSTM blocks split over ``model``) on 16x16. The
port's cells run in one subprocess (a process holds one fake process
group at a time), the reference's ``_jit_cell`` compiles in another with
8 host devices, as ``tests/test_dryrun.py`` does.

FLOPs. ``analytic_terms`` is the closed form the roofline uses: 6 (train)
or 2 FLOPs per active parameter per token, and causal attention over half
the context, split evenly over the mesh. The port's step differs from it
in four named ways, each applied as a closed form below; what is left must
agree within ``FLOPS_RTOL`` (2%: norms, biases and the routers' share of
N_active are the rest):

1. an untied embedding is a lookup (no FLOPs);
2. the prefill unembeds the last position only;
3. attention computes every (query, key) pair of its chunk against the
   whole sequence and masks, so a causal S x S costs twice the half, and
   a local layer S keys a query, not its window's (gemma2's 4096 of
   32768);
4. MoE: the experts run over E x C' capacity slots a microbatch (the
   capacity factor, decode's floor of min(T, 4k), and C rounded up to C',
   a multiple of dp), not T x k, split over both axes: each rank runs its
   E / tp experts over C' / dp of the slots. The router runs over the
   rank's own tokens: its shard of the batch where the batch splits over
   ``data``, else every token.

The attention core splits over both axes as the closed form has it, GQA
heads whose KV heads do not split over ``model`` (qwen's 2 over 4)
included: each rank attends its H/tp query heads against the KV heads
they read (``layers._attention_local``); decode splits the cache timeline
instead.

Collectives: the kinds each cell issues (non-zero bytes) against the
reference's HLO on the same mesh and config. The kinds that differ, GSPMD
against DTensor:

- ``reduce-scatter`` (the port only): DTensor turns a pending sum into a
  split layout with a reduce-scatter (the ZeRO-2 grads, a projection's
  partial output at the residual stream's layout); XLA:CPU's SPMD
  partitioner lowers the same as an all-reduce and a dynamic slice;
- ``all-to-all`` (the reference only): GSPMD moves a split from one dim
  to another (heads to batch around attention) with an all-to-all; the
  port makes K/V whole over ``model`` (``split_heads``,
  ``layers._attention_local``), and on a CPU mesh DTensor itself falls
  back to an all-gather and a chunk;
- ``collective-permute`` (the reference only): GSPMD's halo and
  device-order shifts; DTensor has no permute in its redistributions.
"""

import json
import math
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b")
TWO_HEADS = ("xlstm-350m", "recurrentgemma-2b")
DP, TP = 2, 4
FLOPS_RTOL = 0.02
PORT_ONLY = {"reduce-scatter"}
REF_ONLY = {"all-to-all", "collective-permute"}
TIMEOUT = 300
PREFILL_MOE = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
PEAK_LIMIT = 20e9           # bytes a device: prefill_32k of PREFILL_MOE
# (arch, shape) of the GQA cells whose KV heads do not split 16 ways
PRODUCTION_GQA = (("qwen3-32b", "prefill_32k"), ("gemma2-9b", "prefill_32k"),
                  ("qwen3-32b", "decode_32k"))
DECODE_GATHER_LIMIT = 64e6  # all-gather bytes a device of one decode step
# xlstm-350m prefill_32k on 16x16 with the xLSTM blocks split over model
# (the parent: 2.041e13 FLOPs, a peak of 5.994 GB a device)
XLSTM_FLOPS_LIMIT = 5.0e12
XLSTM_PEAK_LIMIT = 2.0e9


def slstm_gathers(B: int = 2, S: int = 16, d: int = 32, tp: int = 4
                  ) -> dict:
    """``layers._slstm_scan`` of one rank's d/tp channels, forward and
    backward under ``CostMode``, its h gathered over a fake process group
    of ``tp`` ranks at each step: on CPU tensors (the loop over time) and
    on ``meta`` (one step over all B·S rows) -> {device: collective bytes
    by kind and ``flops``}."""
    import torch
    from repro_torch.launch.dryrun import CostMode, fake_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding.dtensor import gather_last
    got = {}
    with fake_mesh((tp,), ("model",)) as mesh:
        group = mesh.get_group(0)
        for dev in ("cpu", "meta"):
            px = torch.ones(B, S, 4 * d // tp, device=dev,
                            requires_grad=True)
            r = torch.ones(d, 4 * d // tp, device=dev, requires_grad=True)
            with CostMode() as cost:
                h = L._slstm_scan(px, r, lambda t: gather_last(t, group, tp))
                torch.autograd.grad(h.sum(), (px, r))
            got[dev] = dict(cost.collective_bytes, flops=cost.flops,
                            shape=list(h.shape))
    return got


def narrow(get_config, arch):
    return get_config(arch).scaled_down(layers=2, width_div=4, vocab=512)


def shapes(ShapeConfig):
    """Named as the production shapes (``roofline.SHAPES`` keys), sized
    down."""
    return [ShapeConfig("train_4k", 256, 8, "train"),
            ShapeConfig("prefill_32k", 256, 8, "prefill"),
            ShapeConfig("decode_32k", 256, 8, "decode")]


PORT = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import measure_cell, run_cell
from repro_torch.models.config import ShapeConfig
from test_torch_dryrun_cost import (ARCHS, DP, PREFILL_MOE, PRODUCTION_GQA,
                                    TP, TWO_HEADS, narrow, shapes,
                                    slstm_gathers)
out = {}
for arch in ARCHS:
    for shape in shapes(ShapeConfig):
        out[f"{arch}/{shape.kind}"] = measure_cell(
            narrow(get_config, arch), shape, (DP, TP), ("data", "model"))
out["production"] = run_cell("olmoe-1b-7b", "decode_32k")
for arch in PREFILL_MOE:
    out[f"prefill/{arch}"] = run_cell(arch, "prefill_32k")
for arch, shape in PRODUCTION_GQA:
    out[f"gqa/{arch}/{shape}"] = run_cell(arch, shape)
out["xlstm"] = run_cell("xlstm-350m", "prefill_32k")
out["slstm_gathers"] = slstm_gathers()
out["split"] = run_cell("olmoe-1b-7b", "decode_32k", mesh_split=(4, 64))
cfg = narrow(get_config, "qwen2.5-3b")
train, prefill = shapes(ShapeConfig)[:2]
out["microbatches"] = measure_cell(cfg, train, (DP, TP), ("data", "model"),
                                   microbatches=2)
out["seq_parallel"] = measure_cell(cfg, prefill, (DP, TP),
                                   ("data", "model"), seq_parallel=True)
for arch in TWO_HEADS:
    out[f"two_heads/{arch}"] = measure_cell(
        narrow(get_config, arch).replace(num_heads=2, num_kv_heads=1),
        train, (DP, TP), ("data", "model"))
json.dump(out, open(sys.argv[1], "w"))
print("PORT-OK")
"""

REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[2])
from repro.configs import get_config
from repro.launch.dryrun import _jit_cell, collective_bytes
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import input_specs
from repro.models.config import ShapeConfig
from test_torch_dryrun_cost import ARCHS, DP, TP, narrow, shapes
mesh = make_host_mesh(DP, TP)
out = {}
for arch in ARCHS:
    for shape in shapes(ShapeConfig):
        si = input_specs(narrow(get_config, arch), shape, mesh)
        fn, args = _jit_cell(narrow(get_config, arch), shape, mesh,
                             si["mode"], si["specs"])
        with mesh:
            hlo = fn.lower(*args).compile().as_text()
        out[f"{arch}/{shape.kind}"] = collective_bytes(hlo)
json.dump(out, open(sys.argv[1], "w"))
print("REF-OK")
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(port records, reference collective bytes) by "arch/kind"."""
    d = tmp_path_factory.mktemp("dryrun_cost")
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


def expected_flops(cfg, jax_cfg, shape, rec, dp: int, tp: int) -> float:
    """Per-device FLOPs of the port's step: ``analytic_terms`` of the cell
    with the module docstring's corrections 1-4."""
    import benchmarks.roofline as roofline
    import repro.configs
    mode = shape.kind
    mult = 6 if mode == "train" else 2
    M = rec["microbatches"] or 1
    saved = roofline.SHAPES.get(shape.name), repro.configs.get_config
    roofline.SHAPES[shape.name] = (shape.seq_len, shape.global_batch)
    repro.configs.get_config = lambda _arch: jax_cfg
    try:      # analytic_terms reads the config by name, and per 16x16
        a = roofline.analytic_terms(dict(rec, mesh="16x16"), dp=dp, tp=tp,
                                    M=M)
    finally:
        roofline.SHAPES[shape.name], repro.configs.get_config = saved
    n = dp * tp
    matmul = a["model_flops_dev"] * 256
    attn = (a["flops_dev"] - a["model_flops_dev"]) * 256
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S if mode != "decode" else B
    d, V = cfg.d_model, cfg.vocab_size
    if not cfg.tie_embeddings:                               # 1
        matmul -= mult * V * d * tokens
    if mode == "prefill":                                    # 2
        matmul -= 2 * V * d * (tokens - B)
    if mode != "decode":                                     # 3
        per = cfg.num_layers // len(cfg.block_pattern)
        n_g, n_l = (cfg.block_pattern.count(kind) * per
                    for kind in ("attn", "attn_local"))
        if n_g + n_l:
            ctx_l = min(cfg.sliding_window or S, S)
            attn *= (n_g + n_l) * S / (n_g * S / 2 + n_l * ctx_l)
    dev = matmul / n + attn / n
    if cfg.is_moe:                                           # 4
        from repro_torch.models.layers import moe_capacity
        L, f = cfg.num_layers, cfg.moe_d_ff
        E, k = cfg.num_experts, cfg.experts_per_token
        per_slot = mult * L * 3 * d * f
        router = mult * L * d * E * tokens
        C = moe_capacity(tokens // M, cfg, cfg.moe_capacity_factor)
        slots = -(-C // dp) * dp                             # C'
        rows = dp if (B // M) % dp == 0 else 1       # the batch's split
        dev += (per_slot * E * slots * M / (dp * tp) + router / rows
                - (per_slot * k * tokens + router) / n)
    return dev


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_match_the_closed_form(cells, arch, kind):
    import repro.configs
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig
    rec = cells[0][f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    shape = next(s for s in shapes(ShapeConfig) if s.kind == kind)
    want = expected_flops(narrow(get_config, arch),
                          narrow(repro.configs.get_config, arch), shape,
                          rec, DP, TP)
    got = rec["per_device"]["flops"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want, got / want)
    if kind == "train":
        assert rec["microbatches"] == 4     # 8 rows, one per DP shard each


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_collective_kinds_match_the_reference_hlo(cells, arch, kind):
    port, ref = cells
    coll = port[f"{arch}/{kind}"]["per_device"]["collective_bytes"]
    mine = {k for k, v in coll.items() if k != "count" and v}
    theirs = {k for k, v in ref[f"{arch}/{kind}"].items()
              if k != "count" and v}
    assert mine <= {"all-gather", "all-reduce"} | PORT_ONLY, mine
    assert mine - PORT_ONLY == theirs - REF_ONLY, (mine, theirs)
    assert coll["count"] > 0


def test_run_cell_takes_mesh_split_microbatches_and_seq_parallel(cells):
    """The reference's what-if arguments: a 4x64 mesh split holds one of
    olmoe's 64 experts a rank; 2 microbatches instead of 4 and a sequence
    split over ``model`` change the collectives, not the work."""
    port = cells[0]
    split = port["split"]
    assert split["status"] == "ok" and split["mesh"] == "4x64" and \
        split["devices"] == 256, split.get("traceback")
    assert split["per_device"]["local_shapes"][
        "0/blocks/b0_attn/moe/wg"] == [16, 1, 2048, 1024]
    mb, sp = port["microbatches"], port["seq_parallel"]
    assert mb["status"] == sp["status"] == "ok"
    assert mb["microbatches"] == 2 and sp["seq_parallel"]
    for got, base in ((mb, port["qwen2.5-3b/train"]),
                      (sp, port["qwen2.5-3b/prefill"])):
        assert got["per_device"]["flops"] == base["per_device"]["flops"]
        assert got["per_device"]["collective_bytes"] != \
            base["per_device"]["collective_bytes"]


@pytest.mark.parametrize("arch", TWO_HEADS)
def test_train_step_runs_where_the_heads_do_not_split(cells, arch):
    """Training with 2 heads over a model axis of 4: xlstm-350m's mLSTM
    (two ranks to a head, each its half of the value columns,
    ``layers._mlstm_block``) and recurrentgemma's local attention
    (DTensor hands the merged heads' grad back split 4 ways, which
    ``layers.merge_heads`` views at the heads' own layout);
    recurrentgemma's RG-LRU scan runs on ``meta`` tensors as shapes
    only."""
    rec = cells[0][f"two_heads/{arch}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["per_device"]["flops"] > 0
    assert rec["per_device"]["collective_bytes"]["count"] > 0


def test_production_olmoe_decode_splits_its_experts(cells):
    """16x16 olmoe-1b-7b decode_32k: no all-gather of an expert stack
    (64 experts of 2048 x 1024: each rank keeps 4), and the FLOPs of the
    same closed form (the experts' share 1/16 of the model axis' whole)."""
    import repro.configs
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    rec = cells[0]["production"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("olmoe-1b-7b")
    stack = {(cfg.d_model, cfg.moe_d_ff), (cfg.moe_d_ff, cfg.d_model)}
    pd = rec["per_device"]
    assert not [s for s in pd["all_gather_shapes"]
                if len(s) == 3 and tuple(s[1:]) in stack], \
        pd["all_gather_shapes"]
    assert pd["local_shapes"]["0/blocks/b0_attn/moe/wg"] == [16, 4, 2048,
                                                             1024]
    want = expected_flops(cfg, repro.configs.get_config("olmoe-1b-7b"),
                          SHAPES_BY_NAME["decode_32k"], rec, 16, 16)
    assert abs(pd["flops"] - want) <= FLOPS_RTOL * want, (pd["flops"],
                                                          want)


@pytest.mark.parametrize("arch", PREFILL_MOE)
def test_production_moe_prefill_keeps_each_ranks_tokens(cells, arch):
    """16x16 ``prefill_32k`` of the two MoE configs: each rank routes its
    own 2 of the 32 rows, so no all-gather makes the (32, 32768, d_model)
    activation whole (every rank gathered it once per layer, for a peak of
    115.22 and 90.69 GB a device), the peak stays within ``PEAK_LIMIT``,
    and the FLOPs are the closed form's (the experts over C' / 16 slots a
    rank)."""
    import repro.configs
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    rec = cells[0][f"prefill/{arch}"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, shape = get_config(arch), SHAPES_BY_NAME["prefill_32k"]
    pd = rec["per_device"]
    B, S = shape.global_batch, shape.seq_len
    assert [B, S, cfg.d_model] not in pd["all_gather_shapes"] and \
        [B * S, cfg.d_model] not in pd["all_gather_shapes"], \
        pd["all_gather_shapes"]
    assert pd["peak_hbm_bytes"] <= PEAK_LIMIT, pd["peak_hbm_bytes"]
    want = expected_flops(cfg, repro.configs.get_config(arch), shape, rec,
                          16, 16)
    assert abs(pd["flops"] - want) <= FLOPS_RTOL * want, (pd["flops"],
                                                          want)


@pytest.mark.parametrize("arch,shape", PRODUCTION_GQA)
def test_production_gqa_cells_split_attention(cells, arch, shape):
    """16x16 cells whose KV heads do not split 16 ways (qwen3-32b's 8,
    gemma2-9b's 8): the attention core splits over ``model`` as well as
    ``data`` (each rank's 4 or 1 query heads, their KV heads sliced from a
    whole K/V), so the FLOPs are the closed form's (the parent ran every
    head of its data shard on each of the 16 model ranks: 5.113e15 and
    2.076e15 a device for the two prefills) and the prefill's peak stays
    within ``PEAK_LIMIT`` (its (2, 64, 1024, 32768) float32 logits of one
    query chunk held 17.2 GB: a peak of 41.19 GB); the lookup reads the
    table at its vocab split, so no all-gather is of the whole (V, d)
    table, and a decode step gathers under ``DECODE_GATHER_LIMIT`` (the
    table's 1.56 GB before)."""
    import repro.configs
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    rec = cells[0][f"gqa/{arch}/{shape}"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, sc = get_config(arch), SHAPES_BY_NAME[shape]
    pd = rec["per_device"]
    table = cfg.vocab_size * cfg.d_model
    assert not [s for s in pd["all_gather_shapes"]
                if len(s) == 2 and s[0] * s[1] == table], \
        pd["all_gather_shapes"]
    want = expected_flops(cfg, repro.configs.get_config(arch), sc, rec,
                          16, 16)
    assert abs(pd["flops"] - want) <= FLOPS_RTOL * want, (pd["flops"],
                                                          want)
    if sc.kind == "decode":
        gathered = pd["collective_bytes"]["all-gather"]
        assert gathered < DECODE_GATHER_LIMIT, gathered
    else:
        assert pd["peak_hbm_bytes"] <= PEAK_LIMIT, pd["peak_hbm_bytes"]


def test_slstm_on_meta_counts_the_loops_flops():
    """On ``meta`` tensors the sLSTM recurrence runs as one step over all
    B·S rows: the FLOPs of the loop over time on real tensors, forward and
    backward, and the output's shape — plus the one step's grad of the
    recurrent input the loop does not form (its first step starts from a
    constant zero state)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import layers as L
    B, S, d = 2, 64, 32
    got = {}
    for dev in ("cpu", "meta"):
        px = torch.ones(B, S, 4 * d, device=dev, requires_grad=True)
        r = torch.ones(d, 4 * d, device=dev, requires_grad=True)
        with FlopCounterMode(display=False) as fc:
            h = L._slstm_scan(px, r)
            torch.autograd.grad(h.sum(), (px, r))
        got[dev] = (fc.get_total_flops(), tuple(h.shape))
    assert got["meta"][1] == got["cpu"][1] == (B, S, d)
    assert got["meta"][0] == got["cpu"][0] + 2 * B * d * 4 * d


def test_slstm_on_meta_gathers_the_loops_bytes(cells):
    """A rank's d/tp channels of the sLSTM, its h gathered over ``model``
    at every step (``layers._slstm_local``): on ``meta`` the one step over
    all B·S rows all-gathers the bytes of the S steps of the loop in sum,
    and its FLOPs and backward reduce-scatters are the loop's plus the
    first step's recurrent-input grad, which the loop does not form (its
    first step gathers the constant zero state)."""
    got = cells[0]["slstm_gathers"]
    cpu, meta = got["cpu"], got["meta"]
    B, S, d, tp = 2, 16, 32, 4
    assert meta["shape"] == cpu["shape"] == [B, S, d // tp]
    assert meta["all-gather"] == cpu["all-gather"] == S * B * d * 4, cpu
    assert cpu["reduce-scatter"] == (S - 1) * B * d // tp * 4, cpu
    assert meta["reduce-scatter"] == cpu["reduce-scatter"] + B * d // tp * 4
    assert meta["flops"] == cpu["flops"] + 2 * B * d * 4 * d // tp


def test_production_xlstm_prefill_splits_its_blocks(cells):
    """16x16 xlstm-350m ``prefill_32k`` (4 mLSTM heads over 16 model
    ranks: 4 ranks to a head, each its 128 of the head's 512 value
    columns; the sLSTM 64 of its 1024 channels a rank): the FLOPs a device
    within ``XLSTM_FLOPS_LIMIT`` and the peak within ``XLSTM_PEAK_LIMIT``
    (the parent ran every head and channel on each model rank: 2.041e13
    FLOPs, 5.994 GB); no all-gather of a whole (d, d) or (d, 4d) sLSTM
    gate weight (in any orientation: DTensor gathers a column split
    transposed); and the only all-gathers of v's size with every head are
    u1's, the projections' input, one an mLSTM block (neither v, nor q, nor
    k is made whole)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    rec = cells[0]["xlstm"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, sc = get_config("xlstm-350m"), SHAPES_BY_NAME["prefill_32k"]
    pd = rec["per_device"]
    assert pd["flops"] <= XLSTM_FLOPS_LIMIT, pd["flops"]
    assert pd["peak_hbm_bytes"] <= XLSTM_PEAK_LIMIT, pd["peak_hbm_bytes"]
    d = cfg.d_model
    assert not [s for s in pd["all_gather_shapes"]
                if len(s) == 2 and s[0] * s[1] in (d * d, 4 * d * d)], \
        pd["all_gather_shapes"]
    up = int(cfg.proj_factor * d)
    v = sc.global_batch // 16 * sc.seq_len * up
    counts = pd["all_gather_counts"]
    mlstm = cfg.num_layers // len(cfg.block_pattern)
    whole_v = sum(n for k, n in counts.items()
                  if math.prod(int(x) for x in k.split("x")) == v)
    assert whole_v == mlstm, counts
