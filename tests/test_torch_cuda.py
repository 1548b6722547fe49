"""The port on the card: the CUDA kernels against their plain versions,
CUDA-resident saves against CPU-resident ones, and narrow train steps on the
card against the same steps on the CPU. Marked ``gpu``; each test
skips where there is no card (decided at run time). This file imports no
JAX, so it runs as it is on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointManager, EngineConfig
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


NARROW = dict(num_layers=3, block_pattern=("rglru", "rglru", "attn_local"),
              d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
              d_ff=256, lru_dim=200, vocab_size=512, sliding_window=16)


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
