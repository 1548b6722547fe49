"""The port on the card: the CUDA kernels against their plain versions, and
CUDA-resident saves against CPU-resident ones. Marked ``gpu``; each test
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
