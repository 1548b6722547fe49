"""The port's RG-LRU scan (B5) on the CPU against the JAX package: its plain
version against the Pallas kernel (interpret mode) and the associative-scan
oracle, and its autograd gradient against ``jax.grad``. The kernel itself is
held against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro.kernels.rglru import FEAT_BLK, SEQ_CHUNK, rglru_scan as jax_kernel
from repro_torch.kernels import rglru as rk

RTOL, ATOL = 3e-4, 3e-5          # the reference kernel test's tolerance
jax_oracle = jax.jit(jref.rglru_scan_ref)
jax_grads = jax.jit(jax.grad(
    lambda a, b, w: jnp.sum(jref.rglru_scan_ref(a, b) * w), argnums=(0, 1)))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return a, b


def _port(a, b):
    return rk.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("B,S,R", [(1, SEQ_CHUNK, FEAT_BLK),
                                   (2, 2 * SEQ_CHUNK, FEAT_BLK),
                                   (2, SEQ_CHUNK, 2 * FEAT_BLK),
                                   (3, 3 * SEQ_CHUNK, 2 * FEAT_BLK),
                                   (2, 300, 200)])
def test_scan_matches_the_jax_oracle(B, S, R):
    """Every shape of ``test_kernels.py`` (aligned, and (2, 300, 200)
    which the reference pads and this package takes as it is)."""
    a, b = _inputs((B, S, R), B * S + R)
    want = np.asarray(jax_oracle(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a, b), want, rtol=RTOL, atol=ATOL)


def test_scan_matches_the_pallas_kernel():
    """Against the Pallas kernel itself (interpret mode), through the
    reference's padded wrapper: (2, 300, 200) is aligned to neither tile.
    The aligned path of the kernel is compared in the carry test."""
    a, b = _inputs((2, 300, 200), 307)
    want = ops.rglru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(_port(a, b), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_carry_across_chunks():
    """h_t = 0.999^t past the reference's 256-step chunk boundary."""
    S = 2 * SEQ_CHUNK
    a = np.full((1, S, FEAT_BLK), 0.999, np.float32)
    b = np.zeros((1, S, FEAT_BLK), np.float32)
    b[:, 0] = 1.0
    h = _port(a, b)
    want = np.asarray(jax_kernel(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True))
    t = SEQ_CHUNK + 5
    np.testing.assert_allclose(h[0, t, 0], 0.999 ** t, rtol=1e-4)
    np.testing.assert_allclose(h, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,S,R", [(2, 37, 5), (1, 1, 3), (3, 64, 1)])
def test_gradients_match_jax(B, S, R):
    """The Function's backward (the reverse scan) against ``jax.grad``
    through the reference's associative-scan oracle."""
    a, b = _inputs((B, S, R), S)
    w = np.random.default_rng(S + 1).standard_normal((B, S, R)).astype(
        np.float32)
    ga, gb = jax_grads(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (rk.rglru_scan(ta, tb) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                               rtol=RTOL, atol=ATOL)


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    a = (torch.rand((2, 9, 3), generator=g, dtype=torch.float64) * 0.5
         + 0.4).requires_grad_(True)
    b = torch.randn((2, 9, 3), generator=g,
                    dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(rk.rglru_scan, (a, b))


def test_reverse_scan_is_the_transposed_recurrence():
    """g = reverse scan of d equals L^T d for the lower-triangular L with
    L[t, s] = prod(a[s+1..t]) that the forward scan applies."""
    a, d = _inputs((1, 6, 1), 3)
    L = np.zeros((6, 6))
    for t in range(6):
        for s in range(t + 1):
            L[t, s] = np.prod(a[0, s + 1:t + 1, 0].astype(np.float64))
    g = rk.linear_scan(torch.from_numpy(a), torch.from_numpy(d),
                       reverse=True).numpy()
    h = rk.linear_scan(torch.from_numpy(a), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(g[0, :, 0], L.T @ d[0, :, 0], rtol=1e-5)
    np.testing.assert_allclose(h[0, :, 0], L @ d[0, :, 0], rtol=1e-5)


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError):
        rk.linear_scan(torch.zeros(1, 2, 3), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError):
        rk.linear_scan(torch.zeros(2, 3), torch.zeros(2, 3))


@pytest.mark.parametrize("B,S,R", [(2, 37, 5), (1, 1, 3), (3, 64, 1),
                                   (2, 1, 1), (2, 70, 33)])
def test_grad_ref_equals_the_unfused_backward(B, S, R):
    """``rglru_scan_grad_ref`` (the kernel's fused grad mode, step for
    step) against the composition it replaces — the reverse scan, then
    g * h_prev with h_prev the output shifted one step (h_{-1} = 0) — bit
    for bit."""
    a, dh = _inputs((B, S, R), 11 * S + R)
    a, dh = torch.from_numpy(a), torch.from_numpy(dh)
    h = rk.linear_scan(a, torch.from_numpy(_inputs((B, S, R), S)[1]))
    da, g = rk.ref.rglru_scan_grad_ref(a, h, dh)
    want_g = rk.ref.rglru_scan_reverse_ref(a, dh)
    h_prev = torch.zeros_like(h)
    h_prev[:, 1:] = h[:, :-1]
    want_da = want_g * h_prev
    for got, want in ((da, want_da), (g, want_g)):
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_backward_is_one_grad_pass(monkeypatch):
    """The Function's backward is one ``linear_scan_grad`` (on the card, one
    launch): no separate reverse scan."""
    calls = []
    real = rk.ref.rglru_scan_grad_ref
    monkeypatch.setattr(rk.ref, "rglru_scan_grad_ref",
                        lambda *t: calls.append(1) or real(*t))
    monkeypatch.setattr(rk.ref, "rglru_scan_reverse_ref", None)
    a, b = _inputs((2, 9, 4), 5)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    rk.rglru_scan(ta, tb).sum().backward()
    assert calls == [1] and ta.grad is not None and tb.grad is not None


def test_copy_variant_follows_width_and_alignment():
    """TMA bulk copies need every row segment 16-byte aligned: the training
    shape (R = 2560) and any R % 4 == 0 on aligned bases take them; an odd
    R or a view that starts 4 bytes into its buffer takes 4-byte
    cp.async."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.float32)

    assert rk.copy_variant(t(8, 255, 2560), t(8, 255, 2560)) == "bulk"
    assert rk.copy_variant(t(2, 33, 2564), t(2, 33, 2564),
                           t(2, 33, 2564)) == "bulk"
    assert rk.copy_variant(t(2, 300, 2561), t(2, 300, 2561)) == "cp.async"
    assert rk.copy_variant(t(8, 255, 1), t(8, 255, 1)) == "cp.async"
    buf = t(2 * 33 * 2560 + 1)
    view = buf[1:].view(2, 33, 2560)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert rk.copy_variant(t(2, 33, 2560), view) == "cp.async"
