"""The port on the card: the CUDA kernels against their plain versions,
CUDA-resident saves against CPU-resident ones, narrow train steps and a
narrow decode on the card against the same on the CPU, CUDA states through
every engine and storage tier, and the model-swap serving example. Marked
``gpu``; each test skips where there is no card (decided at run time). This
file imports no JAX, so it runs as it is on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import (CheckpointManager, EngineConfig, LocalShard,
                              MultiLevelCheckpointer, MultiWriterCheckpointer,
                              RemoteCheckpointer, SimObjectStore,
                              process_group_manager)
from repro_torch.core.engines import ENGINES
from repro_torch.core.quant_codec import packed_rows
from repro_torch.kernels import _lib, fingerprint as fpk, quantize as qk
from repro_torch.kernels.quantize import LANE_COLS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _rows(cuda, rows=64):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((rows, LANE_COLS), device=cuda, generator=g)
    x *= torch.rand((rows, 1), device=cuda, generator=g) * 100
    x[1] = 0
    x[2] = torch.arange(LANE_COLS, device=cuda) % 9 - 4.5
    x[2, 0] = 127
    return x


def test_quantize_and_dequantize_match_plain(cuda):
    x = _rows(cuda)
    q, s = qk.quantize_blocks(x)
    qp, sp = qk.quantize_blocks_plain(x)
    assert _same(q, qp) and _same(s, sp)
    flat = x.reshape(-1)[:20 * LANE_COLS + 9]
    assert all(_same(a, b) for a, b in zip(
        qk.quantize_blocks(flat, 24), qk.quantize_blocks_plain(flat, 24)))
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.float64):
        assert _same(qk.dequantize_blocks(q, s, dt, n=1001),
                     qk.dequantize_blocks_plain(q, s, dt, n=1001))


@pytest.mark.parametrize("dtype,n", [(torch.uint8, 3 * 4096 + 5),
                                     (torch.bfloat16, 3 * 2048 + 3),
                                     (torch.float32, 5 * 1024 + 7)])
def test_fingerprint_matches_plain_and_host_twin(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    t = torch.randint(0, 255, (n,), device=cuda, generator=g,
                      dtype=torch.uint8) if dtype is torch.uint8 else \
        torch.randn(n, device=cuda, generator=g).to(dtype)
    d = fpk.fingerprint_chunks(t, 4096)
    assert _same(d, fpk.fingerprint_chunks_plain(t, 4096))
    host = fpk.fingerprint_chunks_host(_bits(t).cpu().numpy(), 4096)
    assert np.array_equal(fpk.digest_table(d), host)


def test_fused_quant_fingerprint_matches_plain(cuda):
    x = _rows(cuda, 32)
    got = fpk.quantize_fingerprint_blocks(x, 16 * LANE_COLS)
    want = fpk.quantize_fingerprint_blocks_plain(x, 16 * LANE_COLS)
    assert all(_same(a, b) for a, b in zip(got, want))
    src = torch.randn(3 * 8192 + 100, device=cuda)
    rows = packed_rows(src.numel())
    q, s, d = fpk.quant_fingerprint(src, rows, 8192)
    qc, sc, dc = fpk.quant_fingerprint(src.cpu(), rows, 8192)
    assert _same(q.cpu(), qc) and _same(s.cpu(), sc)
    assert np.array_equal(d, dc)


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    _lib.reset_launches()
    x = _rows(cuda, 8)
    qk.quantize_blocks(x)
    fpk.fingerprint_chunks(x, 4096)
    assert _lib.LAUNCHES["quantize_blocks"] == 1
    assert _lib.LAUNCHES["fingerprint_chunks"] == 1
    with pytest.raises(TypeError):
        qk.quantize_blocks(x.double())
    with pytest.raises(ValueError):
        fpk.fingerprint_chunks(x, 4095)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "quant"])
def test_delta_plan_fingerprints_on_card_and_gathers_into_staging(
        cuda, monkeypatch, quant):
    """Every CUDA put is digested by the kernels (int64 and bool included,
    never the host pass), and its dirty chunks come back through the
    pinned staging buffer with the bytes a CPU plan gives."""
    from repro_torch.core import delta as dm
    from repro_torch.core.pipeline import HostStaging, build_save_puts

    def no_host_pass(*_):
        raise AssertionError("CUDA put took the host fingerprint pass")

    g = torch.Generator(device=cuda).manual_seed(3)
    state = {"i64": torch.randint(-2**40, 2**40, (3001,), device=cuda,
                                  generator=g),
             "flag": torch.rand(9001, device=cuda, generator=g) > 0.5,
             "opt/mu": torch.randn(5 * 4096 + 7, device=cuda, generator=g)}
    quant_kw = dict(quantize_prefixes=("opt/mu",) if quant else (),
                    quantize_min_bytes=1024)
    cpu_puts, _ = build_save_puts({k: v.cpu() for k, v in state.items()},
                                  b"lean", **quant_kw)
    cpu_plan = dm.plan_delta(cpu_puts, dm.DeltaIndex(), chunk_bytes=8192,
                             device_fingerprint=True)
    want = [bytes(p.resolve()) for p in cpu_plan.puts]
    monkeypatch.setattr(fpk, "fingerprint_chunks_host", no_host_pass)
    puts, _ = build_save_puts(state, b"lean", **quant_kw)
    _lib.reset_launches()
    plan = dm.plan_delta(puts, dm.DeltaIndex(), chunk_bytes=8192,
                         device_fingerprint=True)
    assert _lib.LAUNCHES["fingerprint_chunks"] >= 2
    if quant:
        assert _lib.LAUNCHES["quantize_fingerprint_blocks"] == 1
    assert [r for s in plan.shards for r in s.refs] == \
        [r for s in cpu_plan.shards for r in s.refs]
    staging = HostStaging()
    got = [bytes(p.resolve(staging)) for p in plan.puts]
    assert got == want


@pytest.mark.parametrize("shape", [(8, 255, 2560), (2, 300, 2561),
                                   (3, 1, 1), (2, 31, 2564), (2, 33, 2560),
                                   (2, 129, 2560)])
def test_rglru_scan_matches_plain_both_directions(cuda, shape):
    """B5 against its plain version, bit for bit: the main-path shape, an
    odd width, one step of one column, and S = T - 1, T + 1 and 4T + 1 for
    the kernel's T = 32 steps per ring stage (R = 2564: a narrow last
    column tile on the bulk-copy path)."""
    from repro_torch.kernels import rglru as rk
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    a = torch.rand(shape, device=cuda, generator=g) * 0.3 + 0.69
    b = torch.randn(shape, device=cuda, generator=g) * 0.1
    for reverse in (False, True):
        got = rk.linear_scan(a, b, reverse=reverse)
        torch.cuda.synchronize()
        assert _same(got, rk.linear_scan_plain(a, b, reverse=reverse))
    # carry: h_t = 0.999^t, within float32 rounding of t multiplies
    a = torch.full((1, 300, 3), 0.999, device=cuda)
    b = torch.zeros_like(a)
    b[:, 0] = 1.0
    h = rk.linear_scan(a, b)
    want = 0.999 ** torch.arange(300, dtype=torch.float64, device=cuda)
    torch.testing.assert_close(h[0, :, 1].double(), want, rtol=1e-4,
                               atol=0)


def _scan_inputs(cuda, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.rand(shape, device=cuda, generator=g) * 0.3 + 0.69
    b = torch.randn(shape, device=cuda, generator=g) * 0.1
    dh = torch.randn(shape, device=cuda, generator=g)
    return a, b, dh


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("shape,misaligned", [
    ((8, 255, 2560), False), ((2, 300, 2561), False), ((3, 1, 1), False),
    ((2, 31, 2560), False), ((2, 33, 2560), False), ((2, 97, 2564), False),
    ((2, 33, 2560), True)])
def test_rglru_grad_matches_plain(cuda, shape, misaligned):
    """The fused backward (g and da in one launch) against its plain
    version, bit for bit: the main-path shape, an odd width, one column, S
    = T - 1 and T + 1, the grad ring's wrap (3T + 1), and a misaligned view
    that must take the 4-byte copy path."""
    from repro_torch.kernels import rglru as rk
    a, b, dh = _scan_inputs(cuda, shape, shape[1])
    h = rk.linear_scan(a, b)
    if misaligned:
        a, h, dh = _misaligned(a), _misaligned(h), _misaligned(dh)
        assert rk.copy_variant(a, dh, h) == "cp.async"
    da, g = rk.linear_scan_grad(a, h, dh)
    torch.cuda.synchronize()
    want_da, want_g = rk.linear_scan_grad_plain(a, h, dh)
    assert _same(g, want_g) and _same(da, want_da)
    assert _same(g, rk.linear_scan(a, dh, reverse=True))


def test_rglru_backward_is_one_launch(cuda):
    """``_RGLRUScan.backward`` makes exactly one kernel launch, and its
    gradients equal the plain fused backward's."""
    from repro_torch.kernels import rglru as rk
    a, b, dh = _scan_inputs(cuda, (2, 70, 200), 3)
    a.requires_grad_(True)
    b.requires_grad_(True)
    h = rk.rglru_scan(a, b)
    _lib.reset_launches()
    h.backward(dh)
    assert _lib.LAUNCHES["rglru_scan"] == 1
    want_da, want_g = rk.linear_scan_grad_plain(a.detach(), h.detach(), dh)
    assert _same(a.grad, want_da) and _same(b.grad, want_g)


def test_rglru_scan_counts_launches_and_refuses_bad_input(cuda):
    from repro_torch.kernels import rglru as rk
    a = torch.rand((2, 5, 7), device=cuda)
    _lib.reset_launches()
    rk.linear_scan(a, a)
    rk.linear_scan(a, a, reverse=True)
    rk.linear_scan(a.cpu(), a.cpu())          # plain version: no launch
    assert _lib.LAUNCHES["rglru_scan"] == 2
    with pytest.raises(ValueError):
        rk.linear_scan(a, a.cpu())
    with pytest.raises(ValueError):
        rk.linear_scan(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(TypeError):
        rk.linear_scan(a.double(), a.double())
    assert _lib.LAUNCHES["rglru_scan"] == 2


def test_narrow_train_steps_on_card_match_cpu(cuda):
    """Two train steps of a narrow float32 recurrentgemma from one set of
    weights and batches: cuBLAS and the B5 kernel (forward, remat
    recompute and reverse) against the CPU's plain path. Tolerances: loss
    rtol 1e-4; params within 5e-5 (a few learning-rate-sized AdamW steps)."""
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = get_config("recurrentgemma-2b").replace(dtype="float32", **NARROW)
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_state = init_train_state(cfg, seed=0, device="cpu")
    states = {"cuda": tree_map_with_path(lambda _p, t: t.to(cuda),
                                         cpu_state),
              "cpu": cpu_state}
    data = SyntheticPipeline(DataConfig(512, 64, 2, seed=0))
    losses = {}
    _lib.reset_launches()
    for dev, state in states.items():
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        for s in range(2):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch_at(s).items()}
            state, m = step(state, batch)
            losses.setdefault(dev, []).append(float(m["loss"]))
    # per step: 2 RG-LRU blocks x (forward + remat recompute + reverse)
    assert _lib.LAUNCHES["rglru_scan"] == 2 * 2 * 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for (path, want), (_, have) in zip(_leaves(states["cpu"]["params"]),
                                       _leaves(states["cuda"]["params"])):
        torch.testing.assert_close(have.cpu(), want, rtol=1e-4, atol=5e-5,
                                   msg=path)


NARROW_WIDTHS = dict(d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                     vocab_size=512, dtype="float32")


def _card_vs_cpu_steps(cuda, cfg, tokens):
    """Two train steps of ``cfg`` on the card and on the CPU from one set of
    weights and batches (batch 2) -> (losses by device, final params by
    device)."""
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_state = init_train_state(cfg, seed=0, device="cpu")
    states = {"cuda": tree_map_with_path(lambda _p, t: t.to(cuda),
                                         cpu_state),
              "cpu": cpu_state}
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, tokens + 1, 2,
                                        seed=0))
    losses = {}
    for dev, state in states.items():
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        for s in range(2):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch_at(s).items()}
            state, m = step(state, batch)
            losses.setdefault(dev, []).append(float(m["loss"]))
    return losses, {dev: s["params"] for dev, s in states.items()}


@pytest.mark.parametrize("tokens", [255, 512], ids=["quadratic", "chunked"])
def test_narrow_xlstm_steps_on_card_match_cpu(cuda, tokens):
    """One mLSTM and one sLSTM block in float32: 255 tokens take the
    quadratic mLSTM form, 512 the chunkwise one (two chunks of 256).
    Tolerances: loss rtol 1e-4; params rtol 1e-4, atol 5e-5."""
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-350m").replace(num_layers=2, **NARROW_WIDTHS)
    losses, params = _card_vs_cpu_steps(cuda, cfg, tokens)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for (path, want), (_, have) in zip(_leaves(params["cpu"]),
                                       _leaves(params["cuda"])):
        torch.testing.assert_close(have.cpu(), want, rtol=1e-4, atol=5e-5,
                                   msg=path)


def test_narrow_moe_steps_on_card_match_cpu(cuda):
    """Two attention + MoE blocks (8 experts, top-2) in float32. The
    dispatch gather's backward adds atomically on the card, so the grads
    are not bit-exact. Tolerances: loss rtol 1e-4; params rtol 1e-4,
    atol 5e-5."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b").replace(
        num_layers=2, num_experts=8, experts_per_token=2, moe_d_ff=128,
        **NARROW_WIDTHS)
    losses, params = _card_vs_cpu_steps(cuda, cfg, 63)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for (path, want), (_, have) in zip(_leaves(params["cpu"]),
                                       _leaves(params["cuda"])):
        torch.testing.assert_close(have.cpu(), want, rtol=1e-4, atol=5e-5,
                                   msg=path)


def test_narrow_xlstm_decode_on_card_matches_cpu(cuda):
    """16 decode steps of the narrow float32 xLSTM through the mLSTM and
    sLSTM caches on the card against the CPU: logits and every cache leaf
    within rtol 1e-4 / atol 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import init_train_state, make_serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-350m").replace(num_layers=2, **NARROW_WIDTHS)
    params = init_train_state(cfg, seed=0, device="cpu")["params"]
    on_card = tree_map_with_path(lambda _p, t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 16)).astype(np.int32))
    serve = make_serve_step(cfg)
    caches = {"cpu": T.init_cache(cfg, 2, 16, device="cpu"),
              "cuda": T.init_cache(cfg, 2, 16, device=cuda)}
    for t in range(16):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        want, caches["cpu"] = serve(params, caches["cpu"], tokens[:, t:t + 1],
                                    pos)
        got, caches["cuda"] = serve(on_card, caches["cuda"],
                                    tokens[:, t:t + 1].to(cuda), pos.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    for (k, want), (_, got) in zip(_leaves(caches["cpu"]),
                                   _leaves(caches["cuda"])):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5,
                                   msg=k)


NARROW = dict(num_layers=3, block_pattern=("rglru", "rglru", "attn_local"),
              d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
              d_ff=256, lru_dim=200, vocab_size=512, sliding_window=16)


def _narrow_serving(cuda):
    """(cfg, CPU params, card params, prompt (2, 24) on the CPU) of the
    narrow float32 recurrentgemma."""
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.train.steps import init_train_state
    cfg = get_config("recurrentgemma-2b").replace(dtype="float32", **NARROW)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_train_state(cfg, seed=0, device="cpu")["params"]
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 24)).astype(np.int32))
    return cfg, params, tree_map_with_path(lambda _p, t: t.to(cuda),
                                           params), prompt


def test_narrow_decode_on_card_matches_cpu(cuda):
    """24 decode steps (the 16-token ring wraps) of the narrow float32
    recurrentgemma on the card against the CPU: logits and every cache
    leaf, rtol 1e-4 / atol 1e-5 (cuBLAS and the CPU sum in other orders);
    ``pos`` exact."""
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_serve_step
    cfg, params, on_card, prompt = _narrow_serving(cuda)
    serve = make_serve_step(cfg)
    caches = {"cpu": T.init_cache(cfg, 2, 24, device="cpu"),
              "cuda": T.init_cache(cfg, 2, 24, device=cuda)}
    for t in range(24):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        want, caches["cpu"] = serve(params, caches["cpu"], prompt[:, t:t + 1],
                                    pos)
        got, caches["cuda"] = serve(on_card, caches["cuda"],
                                    prompt[:, t:t + 1].to(cuda), pos.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    for (k, want), (_, got) in zip(_leaves(caches["cpu"]),
                                   _leaves(caches["cuda"])):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5,
                                   msg=k)


def test_prefill_launches_the_scan_once_per_rglru_block(cuda):
    """Prefill runs under inference mode: one forward B5 launch per RG-LRU
    block (2 here, 18 at full width), no remat or reverse; decode steps the
    recurrence with torch ops and launches none. The prefill's last logits
    match the CPU's."""
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    cfg, params, on_card, prompt = _narrow_serving(cuda)
    _lib.reset_launches()
    got = make_prefill_step(cfg)(on_card, {"tokens": prompt.to(cuda)})
    assert _lib.LAUNCHES["rglru_scan"] == 2
    cache = T.init_cache(cfg, 2, 4, device=cuda)
    serve = make_serve_step(cfg)
    for t in range(4):
        serve(on_card, cache, prompt[:, t:t + 1].to(cuda),
              torch.full((2, 1), t, dtype=torch.int32, device=cuda))
    assert _lib.LAUNCHES["rglru_scan"] == 2
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_serve_swap_example_on_the_card(cuda, tmp_path):
    """``examples/torch_serve_swap.main`` on the card: every swap-in lands
    there, and the delta updates fingerprint with B3."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_serve_swap", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "torch_serve_swap.py"))
    zoo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(zoo)
    _lib.reset_launches()
    out = zoo.main(str(tmp_path), device="cuda")
    assert len(out["swaps"]) == 9
    assert _lib.LAUNCHES["fingerprint_chunks"] > 0
    for u in out["updates"]:
        assert 0 < u["chunks_dirty"] < u["chunks_total"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _state(device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, device=device, generator=g)
    return {"params": {"w": r(64, 700).to(torch.bfloat16), "b": r(700)},
            "opt": {"mu": {"w": r(64, 700) * 1e-3},
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=device)},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _files(d):
    out = {}
    for root, _, fs in os.walk(d):
        for f in fs:
            if f != "manifest.json":
                with open(os.path.join(root, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


@pytest.mark.parametrize("delta", [False, True], ids=["full", "delta"])
def test_cuda_save_writes_the_cpu_bytes(cuda, tmp_path, delta):
    cfg = EngineConfig(backend="posix", direct=False)
    kw = dict(config=cfg, quantize_prefixes=("opt/mu",),
              quantize_min_bytes=1024, delta=delta, delta_chunk_bytes=8192)
    base = _state(torch.device("cpu"))   # one set of values for both
    for dev in ("cpu", "cuda"):
        state = {"params": {k: v.to(dev) for k, v in base["params"].items()},
                 "opt": {"mu": {"w": base["opt"]["mu"]["w"].to(dev)},
                         "count": base["opt"]["count"].to(dev)},
                 "step": base["step"].to(dev)}
        with CheckpointManager(str(tmp_path / dev), device=dev, **kw) as m:
            m.save(1, state)
            out = m.restore(state_template=state, step=1)
        assert out["params"]["w"].device.type == dev
        assert _same(out["params"]["w"].cpu(), state["params"]["w"].cpu())
    if delta:
        cpu = sorted(_files(str(tmp_path / "cpu" / "chunkstore")).values())
        gpu = sorted(_files(str(tmp_path / "cuda" / "chunkstore")).values())
    else:
        cpu = _files(str(tmp_path / "cpu" / "step_00000001"))
        gpu = _files(str(tmp_path / "cuda" / "step_00000001"))
    assert cpu == gpu


def test_async_save_barrier_with_cuda_tensors(cuda, tmp_path):
    """Trap 4 on the card: mutate right after wait_snapshotted()."""
    state = _state(cuda, 1)
    before = {k: v.clone() for k, v in state["params"].items()}
    cfg = EngineConfig(backend="posix", direct=False)
    with CheckpointManager(str(tmp_path), config=cfg, device="cuda",
                           async_save=True) as m:
        m.save(1, state)
        m.wait_snapshotted()
        for t in state["params"].values():
            t.add_(1)
        m.wait()
        out = m.restore(step=1)
    for k, v in before.items():
        assert _same(out["params"][k], v)


def _cpu_copy(state):
    return {k: _cpu_copy(v) if isinstance(v, dict) else v.cpu()
            for k, v in state.items()}


def _check_restored(out, want, device):
    """Plain leaves bit-exact on ``device``; the quantized moment as the
    plain dequantize(quantize(x)) of the saved one."""
    got, ref = dict(_leaves(out)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for k, w in ref.items():
        g = got[k]
        assert g.device.type == device.type, k
        if k == "/opt/mu/w":
            q, sc = qk.quantize_blocks_plain(w.reshape(-1).cuda(),
                                             -(-w.numel() // LANE_COLS))
            w = qk.dequantize_blocks_plain(q, sc, w.dtype, n=w.numel())
        assert _same(g.reshape(-1).cpu(), w.reshape(-1).cpu()), k


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_cuda_state_through_each_engine(cuda, tmp_path, engine):
    """A CUDA state saved asynchronously through each engine restores onto
    the card (no template): the baselines write the aggregated engine's
    tensor bytes, in their own layouts."""
    state = _state(cuda, 2)
    want = _cpu_copy(state)
    with CheckpointManager(str(tmp_path), engine=engine,
                           quantize_prefixes=("opt/mu",),
                           quantize_min_bytes=1024, async_save=True,
                           device="cuda") as m:
        m.save(1, state)
        m.wait()
        out = m.restore(step=1)
        assert m.engine.last_save_stats.files > 0
    _check_restored(out, want, cuda)


@pytest.mark.parametrize("mode", ["stream", "promote"])
def test_cuda_state_restores_from_the_object_store_onto_the_card(
        cuda, tmp_path, mode):
    """Level-0 loss, then the object-store step restores onto the card with
    no template: streamed straight into the pipeline (nothing staged
    locally) or promoted to level 0."""
    state = _state(cuda, 3)
    want = _cpu_copy(state)
    store = SimObjectStore(str(tmp_path / "bucket"))
    kw = dict(quantize_prefixes=("opt/mu",), quantize_min_bytes=1024,
              device="cuda")
    with RemoteCheckpointer(str(tmp_path / "a"), store, delta=True,
                            upload_async=False, **kw) as rc:
        rc.save(1, state)
    with RemoteCheckpointer(str(tmp_path / "b"), store, restore_mode=mode,
                            **kw) as rc:
        out = rc.restore(step=1)
        assert rc.local.all_steps() == ([1] if mode == "promote" else [])
    _check_restored(out, want, cuda)


def test_cuda_state_restores_from_level1_onto_the_card(cuda, tmp_path):
    state = _state(cuda, 4)
    want = _cpu_copy(state)
    l0, l1 = str(tmp_path / "l0"), str(tmp_path / "l1")
    kw = dict(quantize_prefixes=("opt/mu",), quantize_min_bytes=1024,
              device="cuda")
    with MultiLevelCheckpointer(l0, l1, **kw) as ml:
        ml.save(1, state)
        ml.wait()
    shutil.rmtree(l0)
    with MultiLevelCheckpointer(l0, l1, **kw) as ml:
        out = ml.restore(step=1)
        assert ml.last_restore_metrics.prefetch_seconds > 0
        assert ml.local.all_steps() == [1]
    _check_restored(out, want, cuda)


def _mw_state(device, seed=5):
    """Rows that split 4 ways on whole 512-value quantize blocks, a short
    replicated leaf and 0-d counters (host scalars in the lean object)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, device=device, generator=g)
    return {"params": {"w": r(64, 512).to(torch.bfloat16), "b": r(700),
                       "s": r(3)},
            "opt": {"mu": {"w": r(64, 512) * 1e-3},
                    "count": torch.full((), 3, dtype=torch.int32,
                                        device=device)},
            "step": torch.full((), 3, dtype=torch.int32, device=device)}


def _dequantized(w):
    q, sc = qk.quantize_blocks_plain(w.reshape(-1).cuda(),
                                     -(-w.numel() // LANE_COLS))
    return qk.dequantize_blocks_plain(q, sc, w.dtype,
                                      n=w.numel()).reshape(w.shape)


def test_multiwriter_saves_cuda_shards_and_restores_onto_the_card(
        cuda, tmp_path):
    """4 writer ranks over CUDA row views: each rank quantizes its rows of
    the moment on the card (one B1 launch per rank), the state is mutated
    in place right after ``wait_snapshotted()``, and the step restores onto
    the card with the pre-mutation bytes (B2 decodes), whole through a
    CUDA template and as 2 reader windows."""
    state = _mw_state(cuda)
    want = _cpu_copy(state)
    cfg = EngineConfig(backend="posix", direct=False)
    kw = dict(config=cfg, async_save=True, quantize_prefixes=("opt/mu",),
              quantize_min_bytes=1024, device="cuda")
    _lib.reset_launches()
    with MultiWriterCheckpointer(str(tmp_path), 4, **kw) as mw:
        mw.save(1, state)
        mw.wait_snapshotted()
        for t in (state["params"]["w"], state["opt"]["mu"]["w"],
                  state["step"]):
            t.add_(1)
        mw.wait()
        assert _lib.LAUNCHES["quantize_blocks"] == 4
        assert os.listdir(tmp_path / "step_00000001" / "data") == \
            ["checkpoint.bin"]
        out = mw.restore(state, step=1)
        assert _lib.LAUNCHES["dequantize_blocks"] >= 4
        readers = mw.restore_sharded(2, step=1)
    _check_restored(out, want, cuda)
    mu = _dequantized(want["opt"]["mu"]["w"])
    for r, tree in enumerate(readers):
        lo, hi = 32 * r, 32 * (r + 1)
        w, m = tree["params"]["w"], tree["opt"]["mu"]["w"]
        assert isinstance(w, LocalShard) and w.index[0] == (lo, hi)
        assert w.data.device.type == "cuda"
        assert _same(w.data.cpu(), want["params"]["w"][lo:hi])
        assert _same(m.data.cpu(), mu[lo:hi].cpu())
        s = tree["params"]["s"]        # 3 rows: replicated on 4 writers,
        a, b = s.index[0]              # split over 2 readers
        assert _same(s.data.cpu(), want["params"]["s"][a:b])
        assert int(tree["step"]) == 3


def test_dtensor_save_and_restore_on_the_card(cuda, tmp_path):
    """A 1-rank NCCL group: DTensor leaves (``Shard(0)``, ``Replicate``) on
    a CUDA mesh save through ``process_group_manager`` and restore into
    DTensor templates on the card, and into plain CUDA tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    base = _state(cuda, 6)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        place = {"w": [Shard(0)], "b": [Replicate()]}
        state = {"params": {k: DTensor.from_local(v, mesh, place[k],
                                                  run_check=False)
                            for k, v in base["params"].items()}}
        with process_group_manager(str(tmp_path / "ckpt"), device="cuda",
                                   config=EngineConfig(backend="posix",
                                                       direct=False)) as m:
            m.save(1, state)
            plain = m.restore(step=1)
            tmpl = {"params": {k: DTensor.from_local(
                torch.zeros_like(v), mesh, [Shard(0)], run_check=False)
                for k, v in base["params"].items()}}
            got = m.restore(tmpl, step=1)
        for k, v in base["params"].items():
            assert _same(plain["params"][k], v)
            g = got["params"][k]
            assert isinstance(g, DTensor) and g.placements == (Shard(0),)
            assert g.to_local().device.type == "cuda"
            assert _same(g.to_local(), v)
    finally:
        dist.destroy_process_group()



@pytest.fixture
def cuda_mesh(cuda, tmp_path):
    """A 1x1 ("data", "model") DeviceMesh on the card (a 1-rank NCCL
    group), torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_rglru_scan_on_dtensors_matches_plain(cuda_mesh):
    """``rglru_scan`` on DTensors of a CUDA mesh (batch split over data,
    channels over model) runs the kernel on the local block through
    ``local_map``: forward and grads bit-equal to the kernel on plain
    tensors, one launch each way."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.kernels import rglru as rk
    a, b, dh = _scan_inputs(cuda_mesh.device_type, (4, 97, 2560), 5)
    place = (Shard(0), Shard(2))
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    da = [DTensor.from_local(t, cuda_mesh, place, run_check=False)
          .requires_grad_(True) for t in (a, b)]
    _lib.reset_launches()
    h = rk.rglru_scan(*da)
    assert isinstance(h, DTensor) and h.placements == place
    assert _lib.LAUNCHES["rglru_scan"] == 1
    h.backward(DTensor.from_local(dh, cuda_mesh, place, run_check=False))
    assert _lib.LAUNCHES["rglru_scan"] == 2
    want = rk.rglru_scan(*leaves)
    want.backward(dh)
    assert _same(h.to_local(), want)
    for got, ref in zip(da, leaves):
        assert _same(got.grad.to_local(), ref.grad)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2.5-3b",
                                  "olmoe-1b-7b", "xlstm-350m"])
def test_mesh_trainer_on_the_card_matches_unsharded(cuda_mesh, tmp_path,
                                                    arch):
    """``Trainer(mesh=)`` on a 1x1 CUDA mesh (DTensor state, batch and
    activations; B5 under ``local_map``) against the unsharded Trainer on
    the card, narrow float32, 2 steps with a checkpoint at step 1 that a
    second mesh Trainer resumes through ``restore(shardings=)``. Tolerance:
    loss rtol 1e-5."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).scaled_down(layers=2, width_div=8, vocab=512) \
        .replace(dtype="float32")
    data = DataConfig(cfg.vocab_size, 65, 4, seed=0,
                      frontend_len=cfg.frontend_len,
                      frontend_dim=cfg.frontend_dim)
    eng = EngineConfig(backend="posix", direct=False)

    def run(mesh, steps, every, d):
        t = Trainer(cfg, TrainerConfig(steps=steps, ckpt_every=every,
                                       ckpt_dir=str(tmp_path / d),
                                       log_every=1, async_ckpt=False),
                    data_cfg=data, engine_config=eng, device="cuda",
                    mesh=mesh)
        try:
            return t.run()
        finally:
            t.close()

    _lib.reset_launches()
    sharded = run(cuda_mesh, 1, 1, "mesh")
    resumed = run(cuda_mesh, 2, 5, "mesh")
    launches = _lib.LAUNCHES["rglru_scan"]
    plain = run(None, 2, 0, "plain")
    assert resumed["start_step"] == 1
    assert isinstance(resumed["state"]["params"]["embed"], DTensor)
    got = [m["loss"] for m in sharded["metrics"] + resumed["metrics"]]
    np.testing.assert_allclose(got, [m["loss"] for m in plain["metrics"]],
                               rtol=1e-5)
    # forward and fused backward of each RG-LRU block, per step
    assert launches == 2 * 2 * sum(k == "rglru" for k in cfg.block_pattern)


def test_two_level_trainer_on_the_card_resumes_after_node_loss(cuda,
                                                               tmp_path):
    """``Trainer(multilevel_remote=)`` on the card, narrow float32: step 2
    saved at both levels, level 0 lost, a second Trainer resumes step 2
    from level 1 through the prefetcher and trains 2 more steps; the same
    on the CPU. Both start from the CPU's init, put at level 1 as step 0
    (the card's generator draws other numbers). Tolerance: losses rtol
    1e-4 (card against CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("stablelm-3b").scaled_down(layers=2, width_div=8,
                                                vocab=512) \
        .replace(dtype="float32")
    data = DataConfig(cfg.vocab_size, 65, 4, seed=0)
    eng = EngineConfig(backend="posix", direct=False)
    init = {"train": init_train_state(cfg, seed=0, device="cpu"),
            "data": {"data_step": 0}}

    def run(device, steps):
        d = tmp_path / device
        t = Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=str(d / "l0"),
            multilevel_remote=str(d / "l1"), log_every=1),
            data_cfg=data, engine_config=eng, device=device)
        try:
            return t.run(), t.ckpt.last_restore_metrics
        finally:
            t.close()

    losses = {}
    for device in ("cuda", "cpu"):
        with CheckpointManager(str(tmp_path / device / "l1"), config=eng,
                               device="cpu") as mgr:
            mgr.save(0, init)
        first, _ = run(device, 2)
        shutil.rmtree(tmp_path / device / "l0")
        resumed, rm = run(device, 4)
        assert resumed["start_step"] == 2 and rm.prefetch_seconds > 0
        assert resumed["state"]["params"]["embed"].device.type == device
        losses[device] = [m["loss"] for m in first["metrics"]
                          + resumed["metrics"]]
    assert len(losses["cuda"]) == 4
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_trainer_spans_on_the_card(cuda, tmp_path):
    """With the tracer on, a narrow float32 Trainer on the card records one
    device-tier ``train.step`` a step, on the tracer's clock within its
    host ``train.step`` (the upload, the step and the loss's read) widened
    by 1 ms; a second Trainer resumes the async save and its ``h2d`` spans
    carry the restored bytes, also in ``RestoreMetrics.h2d_bytes``."""
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("qwen2.5-3b").scaled_down(layers=2, width_div=8,
                                               vocab=512) \
        .replace(dtype="float32")

    def run(steps):
        t = Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=1),
            data_cfg=DataConfig(cfg.vocab_size, 65, 4, seed=0),
            engine_config=EngineConfig(backend="posix", direct=False),
            device="cuda")
        trace.enable()
        try:
            out = t.run()
            return out, trace.drain(), t.ckpt.last_restore_metrics
        finally:
            trace.disable()
            t.close()

    out, events, _ = run(3)
    host = {e.attrs["step"]: e for e in events
            if e.name == "train.step" and e.tier == "host"}
    dev = {e.attrs["step"]: e for e in events
           if e.name == "train.step" and e.tier == "device"}
    assert sorted(dev) == sorted(host) == [0, 1, 2]
    for k, d in dev.items():
        assert host[k].t0 - 1e-3 <= d.t0 < d.t1 <= host[k].t1 + 1e-3, k
    resumed, events, rm = run(4)
    assert resumed["start_step"] == 2
    h2d = [e for e in events if e.name == "h2d"]
    assert h2d and all(e.tier == "device" for e in h2d)
    assert sum(e.nbytes for e in h2d) == rm.h2d_bytes == rm.read_bytes
    assert rm.h2d_seconds == pytest.approx(sum(e.dur for e in h2d),
                                           rel=1e-9, abs=1e-12)


def test_mesh_writer_threads_on_the_card_match_cpu(cuda_mesh, tmp_path):
    """``Trainer(mesh=, ckpt_writers=4)`` on a 1x1 CUDA mesh (its commits
    over the Trainer's gloo group), narrow float32 xlstm-350m: both runs
    start from the CPU's init saved as step 0 (the card's generator draws
    other numbers); the card saves step 2 through 4 writer threads with
    step 3 in place after the snapshot barrier, and a second mesh Trainer
    resumes step 2. Losses against the unsharded CPU Trainer rtol 1e-4;
    the resume's loss and every final local block equal to the
    uninterrupted card run's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-350m").scaled_down(layers=2, width_div=8,
                                               vocab=512) \
        .replace(dtype="float32")
    data = DataConfig(cfg.vocab_size, 65, 4, seed=0)
    eng = EngineConfig(backend="posix", direct=False)
    init = {"train": init_train_state(cfg, seed=0, device="cpu"),
            "data": {"data_step": 0}}
    for d in ("card", "cpu"):
        with CheckpointManager(str(tmp_path / d), config=eng,
                               device="cpu") as mgr:
            mgr.save(0, init)

    def run(d, steps, mesh=None, writers=4):
        t = Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / d),
            ckpt_writers=writers, keep=None, log_every=1),
            data_cfg=data, engine_config=eng,
            device="cuda" if mesh is not None else "cpu", mesh=mesh)
        try:
            return t.run(), t.ckpt
        finally:
            t.close()

    first, ckpt = run("card", 3, cuda_mesh)
    assert isinstance(ckpt, MultiWriterCheckpointer)
    assert ckpt.group.num_ranks == 4
    assert sorted(n for n in os.listdir(tmp_path / "card" / "step_00000002")
                  if n.startswith("MANIFEST.rank-")) == [
        f"MANIFEST.rank-{r}" for r in range(4)]
    again, _ = run("card", 3, cuda_mesh)
    plain, _ = run("cpu", 3, writers=0)
    losses = [m["loss"] for m in first["metrics"]]
    np.testing.assert_allclose(losses, [m["loss"] for m in plain["metrics"]],
                               rtol=1e-4)
    assert again["start_step"] == 2
    assert [m["loss"] for m in again["metrics"]] == losses[2:]
    a, b = dict(_leaves(first["state"])), dict(_leaves(again["state"]))
    assert a.keys() == b.keys()
    for k in a:
        assert _same(a[k].to_local(), b[k].to_local()), k


MESH_WRITERS = r"""
import hashlib, json, os, sys
from datetime import timedelta
import numpy as np
import torch, torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from repro_torch.configs import get_config
from repro_torch.core import EngineConfig
from repro_torch.core.serialization import (path_str, tensor_to_numpy,
                                            tree_leaves_with_path)
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.trainer import Trainer, TrainerConfig
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
cfg = get_config("qwen2.5-3b").scaled_down(layers=2, width_div=8,
                                           vocab=512).replace(dtype="float32")
mesh = make_host_mesh(2, 2)
res = {}
for run in ("first", "again"):
    t = Trainer(cfg, TrainerConfig(
        steps=3, ckpt_every=2, ckpt_dir=os.path.join(out, "ckpt"),
        ckpt_writers=2, keep=None, log_every=1),
        data_cfg=DataConfig(cfg.vocab_size, 65, 4, seed=0),
        engine_config=EngineConfig(backend="posix", direct=False),
        device="cuda", mesh=mesh)
    try:
        r = t.run()
    finally:
        t.close()
    res[run] = dict(
        writers=t.ckpt.group.num_ranks, start=r["start_step"],
        losses=[m["loss"] for m in r["metrics"]],
        local={path_str(p): hashlib.sha256(np.ascontiguousarray(
            tensor_to_numpy(v.to_local())).tobytes()).hexdigest()
            for p, v in tree_leaves_with_path(r["state"])})
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("MESH-WRITERS-OK")
"""


def test_mesh_writer_threads_on_four_cards(cuda, tmp_path):
    """``Trainer(mesh=2x2, ckpt_writers=2)`` on four cards (NCCL, one
    process per card; 8 writers), narrow float32 qwen2.5-3b: step 2 saved
    asynchronously with step 3 in place, then resumed; the resume's loss
    and every final local block equal to the uninterrupted run's bit for
    bit. Skips with fewer than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WRITERS, str(r), str(tmp_path),
         str(port)], env=dict(os.environ, OMP_NUM_THREADS="1",
                              PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    assert len([n for n in os.listdir(tmp_path / "ckpt" / "step_00000002")
                if n.startswith("MANIFEST.rank-")]) == 8
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        first, again = res["first"], res["again"]
        assert first["writers"] == again["writers"] == 8
        assert again["start"] == 2
        assert again["losses"] == first["losses"][2:]
        assert again["local"] == first["local"], r


def _mesh_cli(device: str, mesh: str, steps: int, every: int, l0, l1
              ) -> dict:
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    <mesh> --remote-dir <l1>`` (the CLI's reduced bf16 xlstm-350m, batch 4
    x 32 tokens): {step: loss} of rank 0's step lines."""
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(port), "-m", "repro_torch.launch.train",
         "--device", device, "--mesh", mesh, "--steps", str(steps),
         "--ckpt-every", str(every), "--seq-len", "32", "--batch", "4",
         "--log-every", "1", "--ckpt-dir", str(l0), "--remote-dir", str(l1)],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return {int(ln.split()[1]): float(ln.split()[3])
            for ln in run.stdout.splitlines() if ln.startswith("step ")}


def _mesh_failover(device: str, d) -> dict:
    """An uninterrupted 2x2 run of 4 steps; a 2x2 run that saves step 2 at
    both levels; after node loss, 2x2 and 1x4 restarts that resume step 2
    from level 1 and run steps 2 and 3. Returns each run's losses."""
    out = {"straight": _mesh_cli(device, "2x2", 4, 0, d / "u0", d / "u1"),
           "first": _mesh_cli(device, "2x2", 2, 2, d / "l0", d / "l1")}
    out["levels"] = [sorted(os.listdir(d / lv)) for lv in ("l0", "l1")]
    for mesh in ("2x2", "1x4"):
        shutil.rmtree(d / "l0")
        out[mesh] = _mesh_cli(device, mesh, 4, 5, d / "l0", d / "l1")
    return out


def test_two_level_mesh_cli_on_four_cards(cuda, tmp_path):
    """The training CLI on a 2x2 mesh of four cards (NCCL, one process per
    card) with ``--remote-dir``: step 2 committed at both levels; after
    node loss a 2x2 and an elastic 1x4 restart resume it from level 1
    through the group prefetcher. Tolerances against the uninterrupted
    2x2 run: rtol 1e-6 on 2x2 (the same reductions), 1e-3 on 1x4 (bf16
    under another split). Skips with fewer than four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    got = _mesh_failover("cuda", tmp_path)
    straight = got["straight"]
    assert got["levels"] == [["step_00000002"]] * 2
    assert sorted(got["first"]) == [0, 1]
    np.testing.assert_allclose([got["first"][s] for s in (0, 1)],
                               [straight[s] for s in (0, 1)], rtol=1e-6)
    for mesh, rtol in (("2x2", 1e-6), ("1x4", 1e-3)):
        assert sorted(got[mesh]) == [2, 3], mesh
        np.testing.assert_allclose([got[mesh][s] for s in (2, 3)],
                                   [straight[s] for s in (2, 3)],
                                   rtol=rtol, err_msg=mesh)



def mesh_decode(mesh, arch: str) -> tuple[bool, float]:
    """``make_serve_step`` on ``mesh`` (its ranks on the card) for the
    reduced float32 ``arch`` of ``tests/test_torch_serve_mesh.py``: 12
    steps from DTensor caches laid out by ``serve_cache_layouts``, every
    step's logits and cache leaves against the unsharded decode on this
    rank's card. Returns (all within rtol 1e-5 and atol 1e-5 of each
    tensor's largest value, the largest difference over the largest
    value)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_serve_mesh import (B, MESH_TOL, STEPS, decode_tokens,
                                       serve_config)
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import (path_str,
                                                tree_leaves_with_path,
                                                tree_map_with_path)
    from repro_torch.launch.specs import serve_cache_layouts
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import Layout, Partitioner, shard_tree
    from repro_torch.train.steps import make_serve_step
    torch.backends.cuda.matmul.allow_tf32 = False

    def leaves(tree):
        return {path_str(p): t for p, t in tree_leaves_with_path(tree)}

    cfg = serve_config(arch, get_config)
    part = Partitioner(cfg, mesh)
    params = tree_map_with_path(lambda _p, t: t.cuda(), T.init_params(
        cfg, seed=0, device="cpu"))
    dparams = shard_tree(params, part.param_shardings(params))
    tok = part.tokens_sharding(B)
    cache = T.init_cache(cfg, B, STEPS, layouts=serve_cache_layouts(
        cfg, mesh, T.init_cache(cfg, B, STEPS, device="meta")))
    plain = T.init_cache(cfg, B, STEPS)
    serve = make_serve_step(cfg, Layout(mesh, part.activation_spec(B)))
    toks = torch.as_tensor(decode_tokens(cfg)).cuda()
    ok, worst = True, 0.0
    for t in range(STEPS):
        pos = torch.full((B, 1), t, dtype=torch.int32, device="cuda")
        got, _ = serve(dparams, cache, tok.distribute(toks[:, t:t + 1]),
                       tok.distribute(pos))
        want, _ = make_serve_step(cfg)(params, plain, toks[:, t:t + 1], pos)
        pairs = [(got.full_tensor(), want)] + [
            (v.full_tensor(), leaves(plain)[k])
            for k, v in leaves(cache).items()]
        for g, w in pairs:
            g, w = g.float(), w.float()
            top = float(w.abs().max())
            ok &= bool(torch.allclose(g, w, rtol=MESH_TOL["rtol"],
                                      atol=MESH_TOL["atol"] * top))
            worst = max(worst, float((g - w).abs().max()) / max(top, 1e-30))
    return ok, worst


MESH_ARCHS = ("qwen2.5-3b", "gemma2-9b", "recurrentgemma-2b", "xlstm-350m",
              "olmoe-1b-7b")


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_decode_on_the_card_matches_unsharded(cuda_mesh, arch):
    """``mesh_decode`` on a 1x1 CUDA mesh (the rule splits size-1 dims over
    the model axis of size 1, as in the smoke's phase 4i)."""
    ok, worst = mesh_decode(cuda_mesh, arch)
    assert ok, worst


MESH_DECODE = r"""
import json, os, sys
from datetime import timedelta
import torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
from test_torch_cuda import MESH_ARCHS, mesh_decode
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
res = {}
for dm, mm in ((2, 2), (1, 4)):
    mesh = make_host_mesh(dm, mm)
    for arch in MESH_ARCHS:
        ok, err = mesh_decode(mesh, arch)
        res[f"{dm}x{mm}/{arch}"] = dict(ok=ok, err=err)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("MESH-DECODE-OK")
"""


def test_mesh_decode_on_four_cards(cuda, tmp_path):
    """``mesh_decode`` on 2x2 and 1x4 meshes of four cards (NCCL, one
    process per card; qwen2.5-3b's K/V timeline split over the four cards
    on 1x4). Skips with fewer than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_DECODE, str(r), str(tmp_path),
         str(port), __file__], env=dict(
             os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert len(res) == 10 and all(v["ok"] for v in res.values()), \
            (r, res)
    print("four-card mesh decode, largest difference over the largest "
          "value:", {k: v["err"] for k, v in res.items()})


def mesh_moe(mesh) -> tuple[bool, float, int]:
    """``moe_apply``'s forward and backward on ``mesh`` (its ranks on the
    card) for ``tests/test_torch_moe_mesh.py``'s reduced float32 olmoe
    with its 64 experts and top-8 kept, the stacks at the Partitioner's
    layouts (split over ``model``), against the unsharded ``moe_apply`` on
    this rank's card. Returns (the output, aux loss and every grad within
    rtol 1e-4 and atol 1e-5 of each tensor's largest value, the largest
    difference over the largest value, the experts this rank ran)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_moe_mesh import B, S, TOL, moe_config
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.dtensor import like
    from repro_torch.sharding.partition import Layout, Partitioner, shard_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe_config(get_config).replace(num_experts=64,
                                         experts_per_token=8)
    names = ("router", "wg", "wu", "wd")
    stacked = {k: v.cuda() for k, v in T.init_params(
        cfg, seed=0, device="cpu")["blocks"]["b0_attn"]["moe"].items()}
    rng = np.random.default_rng(5)
    x, w = (torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32)).cuda() for _ in range(2))
    part = Partitioner(cfg, mesh)
    blocks = {"blocks": {"b0_attn": {"moe": stacked}}}
    dparams = {k: v.unbind(0)[0] for k, v in shard_tree(
        blocks, part.param_shardings(blocks))["blocks"]["b0_attn"][
            "moe"].items()}
    params = {k: v[0] for k, v in stacked.items()}
    ran = []
    experts = L._moe_experts

    def counting(buf, wg, *a, **kw):
        ran.append(int(wg.shape[0]))
        return experts(buf, wg, *a, **kw)

    def fwd_bwd(p, xin):
        leaves = [xin.detach().requires_grad_(True)] + \
            [p[k].detach().requires_grad_(True) for k in names]
        y, aux = L.moe_apply(dict(zip(names, leaves[1:])), leaves[0], cfg)
        loss = (y * like(w, y)).sum() + 3.0 * aux
        return [y, aux, *torch.autograd.grad(loss, leaves)]

    L._moe_experts = counting
    try:
        got = fwd_bwd(dparams, Layout(mesh, part.activation_spec(B))
                      .distribute(x))
        local = ran.pop()
        want = fwd_bwd(params, x)
    finally:
        L._moe_experts = experts
    ok, worst = True, 0.0
    for g, h in zip(got, want):
        g = (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()
        h = h.detach()
        top = float(h.abs().max())
        ok &= bool(torch.allclose(g, h, rtol=TOL["rtol"],
                                  atol=TOL["atol"] * top))
        worst = max(worst, float((g - h).abs().max()) / max(top, 1e-30))
    return ok, worst, local


def test_mesh_moe_on_the_card_matches_unsharded(cuda_mesh):
    """``mesh_moe`` on a 1x1 CUDA mesh: the expert-parallel path runs all
    64 experts on the one rank, equal to the unsharded run within rtol
    1e-4."""
    ok, worst, experts = mesh_moe(cuda_mesh)
    assert ok and experts == 64, (worst, experts)


MESH_MOE = r"""
import json, os, sys
from datetime import timedelta
import torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
from test_torch_cuda import mesh_moe
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
res = {}
for data, model in ((1, 4), (2, 2)):
    ok, err, experts = mesh_moe(make_host_mesh(data, model))
    res[f"{data}x{model}"] = dict(ok=ok, err=err, experts=experts)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("MESH-MOE-OK")
"""


def test_moe_on_four_cards(cuda, tmp_path):
    """``mesh_moe`` on a 1x4 and a 2x2 mesh of four cards (NCCL, one
    process per card): each card runs 16 (1x4) or 32 (2x2: the batch and
    the capacity slots split over ``data``) of the 64 experts, and the
    output and grads equal one card's unsharded run within rtol 1e-4.
    Skips with fewer than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_MOE, str(r), str(tmp_path), str(port),
         __file__], env=dict(os.environ, OMP_NUM_THREADS="1",
                             PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["1x4"]["ok"] and res["1x4"]["experts"] == 16, (r, res)
        assert res["2x2"]["ok"] and res["2x2"]["experts"] == 32, (r, res)
    print("four-card expert-parallel MoE, largest difference over the "
          "largest value:", {k: v["err"] for k, v in res.items()})


def mesh_attention(mesh, device: str = "cuda") -> tuple[bool, float]:
    """``tests/test_torch_attn_mesh.py``'s reduced float32 qwen2.5-3b (4
    query heads over 2 KV heads) on ``mesh``, its ranks on the card: the
    forward logits, the loss and every grad, and the prefill's logits,
    against the unsharded port on the CPU (rtol 1e-4, atol 1e-5 of each
    tensor's largest value; the loss rtol 1e-5), with no all-gather of
    the whole embedding table. Returns (all held, the largest difference
    over the largest value). (``device="cpu"`` rehearses it on gloo
    ranks.)"""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_attn_mesh import B, MESH_TOL, batch_arrays, config
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_leaves_with_path
    from repro_torch.launch.dryrun import CostMode, act_layout
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import (_unflat, make_loss_fn,
                                         make_prefill_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(get_config, "qwen2.5-3b")
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_arrays(cfg).items()}

    def run(p, b, act=None):
        flat = tree_leaves_with_path(p)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        loss, _ = make_loss_fn(cfg, act)(
            _unflat(zip((k for k, _ in flat), leaves)), b)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            logits = T.forward(p, cfg, b["tokens"], act_sharding=act)[0]
        return [loss, logits, make_prefill_step(cfg, act)(p, b), *grads]

    want = run(params, batch)
    part = Partitioner(cfg, mesh)
    dparams = shard_tree(_unflat((k, v.to(device)) for k, v in
                                 tree_leaves_with_path(params)),
                         part.param_shardings(params))
    tok = part.tokens_sharding(B)
    with CostMode() as cost:
        got = run(dparams, {k: tok.distribute(v.to(device))
                            for k, v in batch.items()},
                  act_layout(cfg, mesh, B))
    table = cfg.vocab_size * cfg.d_model
    ok = not [s for s, _ in cost.gathers
              if len(s) == 2 and s[0] * s[1] == table]
    worst = 0.0
    for i, (g, h) in enumerate(zip(got, want)):
        g = (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()
        g, h = g.cpu(), h.detach()
        top = float(h.abs().max())
        rtol = 1e-5 if i == 0 else MESH_TOL["rtol"]
        ok &= bool(torch.allclose(g, h, rtol=rtol,
                                  atol=MESH_TOL["atol"] * top))
        worst = max(worst, float((g - h).abs().max()) / max(top, 1e-30))
    return ok, worst


def test_mesh_attention_on_the_card_matches_cpu(cuda_mesh):
    """``mesh_attention`` on a 1x1 CUDA mesh: attention split over a model
    axis of size 1 and the lookup at the table's layout, as the smoke's
    phases 4h (a), 4i and 4j run them."""
    ok, worst = mesh_attention(cuda_mesh)
    assert ok, worst


MESH_ATTENTION = r"""
import json, os, sys
from datetime import timedelta
import torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
from test_torch_cuda import mesh_attention
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
ok, err = mesh_attention(make_host_mesh(1, 4))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(dict(ok=ok, err=err), f)
dist.destroy_process_group()
print("MESH-ATTENTION-OK")
"""


def test_mesh_attention_on_four_cards(cuda, tmp_path):
    """``mesh_attention`` on a 1x4 mesh of four cards (NCCL, one process
    per card): one query head a card, two cards to a KV head, the vocab
    split four ways; equal to the CPU's unsharded run. Skips with fewer
    than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_ATTENTION, str(r), str(tmp_path),
         str(port), __file__], env=dict(
             os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["ok"], (r, res)
    print("four-card attention and lookup split over model, largest "
          "difference over the largest value:", res["err"])


def mesh_xlstm(mesh, device: str = "cuda") -> tuple[bool, float]:
    """``tests/test_torch_xlstm_mesh.py``'s reduced float32 xlstm-350m (2
    mLSTM heads, d 256) on ``mesh``, its ranks on the card: the mLSTM core
    split over ``model`` (each rank its heads, or its columns of a head's
    value dim) and the sLSTM's channels, h gathered at every step. The
    forward logits, the loss and every grad, and the prefill's logits,
    against the unsharded port on the CPU (rtol 1e-4, atol 1e-5 of each
    tensor's largest value, of the tree's largest grad for the grads that
    are zero in exact arithmetic; the loss rtol 1e-5), with no all-gather
    of a whole (d, d) or (d, 4d) sLSTM gate weight. Returns (all held, the
    largest difference over the largest value). (``device="cpu"``
    rehearses it on gloo ranks.)"""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_xlstm_mesh import (B, MESH_TOL, NOISE_GRADS,
                                       batch_arrays, config)
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import path_str, \
        tree_leaves_with_path
    from repro_torch.launch.dryrun import CostMode, act_layout
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import (_unflat, make_loss_fn,
                                         make_prefill_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(get_config)
    params = T.init_params(cfg, seed=0, device="cpu")
    arrays = batch_arrays(cfg)
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
    names = [path_str(k) for k, _ in tree_leaves_with_path(params)]

    def run(p, b, act=None):
        flat = tree_leaves_with_path(p)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        loss, _ = make_loss_fn(cfg, act)(
            _unflat(zip((k for k, _ in flat), leaves)), b)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            logits = T.forward(p, cfg, b["tokens"], act_sharding=act)[0]
        return [loss, logits, make_prefill_step(cfg, act)(p, b), *grads]

    want = run(params, batch)
    part = Partitioner(cfg, mesh)
    dparams = shard_tree(_unflat((k, v.to(device)) for k, v in
                                 tree_leaves_with_path(params)),
                         part.param_shardings(params))
    tok = part.tokens_sharding(B)
    with CostMode() as cost:
        got = run(dparams, {k: tok.distribute(v.to(device))
                            for k, v in batch.items()},
                  act_layout(cfg, mesh, B))
    d = cfg.d_model
    ok = not [s for s, _ in cost.gathers
              if len(s) == 2 and s[0] * s[1] in (d * d, 4 * d * d)]
    grads_top = max(float(g.abs().max()) for g in want[3:])
    worst = 0.0
    for i, (g, h) in enumerate(zip(got, want)):
        g = (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()
        g, h = g.cpu(), h.detach()
        top = float(h.abs().max())
        if i >= 3 and names[i - 3].endswith(NOISE_GRADS):
            top = grads_top
        rtol = 1e-5 if i == 0 else MESH_TOL["rtol"]
        ok &= bool(torch.allclose(g, h, rtol=rtol,
                                  atol=MESH_TOL["atol"] * top))
        worst = max(worst, float((g - h).abs().max()) / max(top, 1e-30))
    return ok, worst


def xlstm_step_times(mesh, reps: int = 3) -> dict:
    """The wall of one forward + backward of one full-width xlstm-350m
    (mLSTM, sLSTM) group (bf16, ``TRAIN`` tokens: 8 x 255) on ``mesh``
    and unsharded on this rank's card, each the median of ``reps`` after
    a warm-up call, synchronised: the sLSTM's per-step gather of h over
    ``model`` against the loop without one. {"mesh_s", "unsharded_s"}."""
    import statistics
    import time
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_leaves_with_path
    from repro_torch.launch.dryrun import act_layout
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import _unflat, make_loss_fn
    cfg = get_config("xlstm-350m").replace(num_layers=2)
    B, S = 8, 255
    params = T.cast_params(T.init_params(cfg, seed=0, device="cuda"),
                           L.dtype_of(cfg))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}

    def step(p, b, act=None):
        flat = tree_leaves_with_path(p)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        loss, _ = make_loss_fn(cfg, act)(
            _unflat(zip((k for k, _ in flat), leaves)), b)
        torch.autograd.grad(loss, leaves)

    def timed(*args) -> float:
        step(*args)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    plain = timed(params, batch)
    part = Partitioner(cfg, mesh)
    tok = part.tokens_sharding(B)
    on_mesh = timed(shard_tree(params, part.param_shardings(params)),
                    {k: tok.distribute(v) for k, v in batch.items()},
                    act_layout(cfg, mesh, B))
    return {"mesh_s": on_mesh, "unsharded_s": plain}


def test_mesh_xlstm_on_the_card_matches_cpu(cuda_mesh):
    """``mesh_xlstm`` on a 1x1 CUDA mesh: the xLSTM blocks split over a
    model axis of size 1 (no collective), as the smoke's phase 4l runs
    them; one full-width group's forward + backward timed on the mesh
    beside the unsharded one (``xlstm_step_times``)."""
    ok, worst = mesh_xlstm(cuda_mesh)
    assert ok, worst
    print("1x1 xLSTM group step, full width, 8 x 255 tokens:",
          xlstm_step_times(cuda_mesh))


MESH_XLSTM = r"""
import json, os, sys
from datetime import timedelta
import torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
from test_torch_cuda import mesh_xlstm, xlstm_step_times
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
mesh = make_host_mesh(1, 4)
ok, err = mesh_xlstm(mesh)
times = xlstm_step_times(mesh)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(dict(ok=ok, err=err, **times), f)
dist.destroy_process_group()
print("MESH-XLSTM-OK")
"""


def test_mesh_xlstm_on_four_cards(cuda, tmp_path):
    """``mesh_xlstm`` on a 1x4 mesh of four cards (NCCL, one process per
    card): two cards to an mLSTM head, each its half of the head's value
    columns (q and k exchanged by an all-to-all within the pair, the
    output norm's sums gathered), and 64 of the sLSTM's 256 channels a
    card, h all-gathered at every step; equal to the CPU's unsharded run.
    One full-width (mLSTM, sLSTM) group's forward + backward is timed on
    the 1x4 mesh beside the unsharded one on a card
    (``xlstm_step_times``). Skips with fewer than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_XLSTM, str(r), str(tmp_path),
         str(port), __file__], env=dict(
             os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["ok"], (r, res)
    print("four-card xLSTM blocks split over model, largest difference "
          "over the largest value:", res["err"], "; a full-width group's "
          "forward + backward (8 x 255 tokens) on 1x4 vs one card:",
          {k: v for k, v in res.items() if k.endswith("_s")})


def mesh_ce(meshes: dict, device: str = "cuda") -> dict:
    """qwen2.5-3b's loss at full width and vocab (float32, tied table of
    151936 x 2048, seeded hidden states of 4 x 1024 tokens, two chunks of
    512) on each mesh of ``meshes`` ({name: mesh}) against the unsharded
    loss on this rank's card: the loss within rtol 1e-5; each grad (of h,
    of the table) within rtol 1e-5 and atol 1e-5 of its largest value, or
    else no further from the float64 grad than the unsharded float32 grad
    is (the float64 run: the same unsharded loss with h and the table in
    float64, so its matmuls run in float64; ``_unembed`` rounds its logits
    to float32). The h grad's matmul sums over the 151,936 vocab columns,
    one term of a row (the label's) far above the rest: in float32 the
    card's unsharded h grad lies 2.5e-5 of its largest value from the
    float64 one, so no other order of that sum meets 1e-5 against it; the
    vocab's split shortens each rank's sum. Also
    ``max_memory_allocated`` over the loss + backward (less what was
    allocated before it), on the card and on each mesh. {name: {"ok",
    "errs": (loss, h grad, table grad) differences from the float32
    unsharded over its largest value, "errs64": the same from the float64
    run, "peak_bytes"}}, "unsharded" the float32 unsharded's. (``device=
    "cpu"`` rehearses it on gloo ranks, at vocab 4096.)"""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import act_layout
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import chunked_cross_entropy
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device == "cuda"
    cfg = get_config("qwen2.5-3b")
    if not cuda:
        cfg = cfg.replace(vocab_size=4096)
    B, S = 4, 1024
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    full = T.init_params(cfg.replace(num_layers=1), seed=0, device=dev)
    params = {k: full[k] for k in ("final_norm", "embed")}
    del full
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model)),
                        dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=dev)

    def run(p, hh, ll):
        hh = hh.detach().requires_grad_(True)
        t = p["embed"].detach().requires_grad_(True)
        if cuda:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        loss = chunked_cross_entropy({**p, "embed": t}, cfg, hh, ll)
        grads = torch.autograd.grad(loss, (hh, t))
        peak = torch.cuda.max_memory_allocated() - before if cuda else 0
        return [(g.full_tensor() if hasattr(g, "full_tensor") else g)
                .detach() for g in (loss, *grads)], peak

    def errs(got, want) -> list[float]:
        return [float((g.double() - w.double()).abs().max()
                      / w.double().abs().max()) for g, w in zip(got, want)]

    want, peak0 = run(params, h, labels)
    exact = run(T._tree_map(lambda t: t.double(), params), h.double(),
                labels)[0]
    out = {"unsharded": {"ok": True, "errs64": errs(want, exact),
                         "peak_bytes": peak0}}
    for name, mesh in meshes.items():
        part = Partitioner(cfg, mesh)
        act = act_layout(cfg, mesh, B)
        got, peak = run(shard_tree(params, part.param_shardings(params)),
                        act.distribute(h),
                        part.tokens_sharding(B).distribute(labels))
        ok = bool(torch.allclose(got[0], want[0], rtol=1e-5, atol=0.0))
        for i in (1, 2):
            top = float(want[i].abs().max())
            ok &= bool(torch.allclose(got[i], want[i], rtol=1e-5,
                                      atol=1e-5 * top)) or \
                errs(got[i:i + 1], exact[i:i + 1]) <= \
                errs(want[i:i + 1], exact[i:i + 1])
        out[name] = {"ok": ok, "errs": errs(got, want),
                     "errs64": errs(got, exact), "peak_bytes": peak}
    return out


def test_mesh_cross_entropy_on_the_card(cuda_mesh):
    """``mesh_ce`` on a 1x1 CUDA mesh: the loss's Function with a one-rank
    vocab group, held to the unsharded loss on the card."""
    res = mesh_ce({"1x1": cuda_mesh})
    assert res["1x1"]["ok"], res
    print("1x1 loss split over model (qwen2.5-3b, full vocab):", res)


MESH_CE = r"""
import json, os, sys
from datetime import timedelta
import torch.distributed as dist
rank, out, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[4])))
from test_torch_cuda import mesh_ce
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=300))
res = mesh_ce({"1x4": make_host_mesh(1, 4), "4x1": make_host_mesh(4, 1)})
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("MESH-CE-OK")
"""


def test_mesh_cross_entropy_on_four_cards(cuda, tmp_path):
    """``mesh_ce`` on a 1x4 and a 4x1 mesh of four cards (NCCL, one process
    per card): on 1x4 each card its 37,984 of the 151,936 vocab columns,
    the max, the sum of exponentials and the gold logit all-reduced; on
    4x1 each card its row of the batch, the vocab whole. The loss and the
    grads against the unsharded loss on one card (``mesh_ce``'s
    tolerances), and each card's memory
    over the loss + backward printed beside one card's. Skips with fewer
    than four cards."""
    import json
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one process per card)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_CE, str(r), str(tmp_path),
         str(port), __file__], env=dict(
             os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, \
        [log[-3000:] for log in logs]
    for r in range(4):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["1x4"]["ok"] and res["4x1"]["ok"], (r, res)
        print(f"four-card loss split over model, rank {r}: (loss, h grad, "
              f"table grad) differences over the largest value, from one "
              f"card's float32 1x4 {res['1x4']['errs']}, 4x1 "
              f"{res['4x1']['errs']}; from its float64 1x4 "
              f"{res['1x4']['errs64']}, 4x1 {res['4x1']['errs64']}, one "
              f"card {res['unsharded']['errs64']}; memory over the loss + "
              f"backward "
              f"1x4 {res['1x4']['peak_bytes']} B, 4x1 "
              f"{res['4x1']['peak_bytes']} B, one card "
              f"{res['unsharded']['peak_bytes']} B")
