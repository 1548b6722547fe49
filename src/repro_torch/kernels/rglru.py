"""RG-LRU linear-recurrence scan: h_t = a_t * h_{t-1} + b_t over a sequence.

Counterpart of ``repro/kernels/rglru.py`` (and of the associative scan in
``repro/models/layers.py``'s ``rglru_apply`` that the Pallas kernel replaces).
``linear_scan`` runs the recurrence in either direction: on a CUDA tensor it
launches the hand-written kernel of ``csrc/rglru.cu``; on a CPU tensor it runs
the plain PyTorch versions of ``ref.py`` — the same arithmetic, bit for bit.
``rglru_scan`` is the differentiable op the model calls: its backward is the
same kernel run in reverse.

Shapes are (B, S, R) float32 of any size: the kernel needs no padding.
"""

from __future__ import annotations

import torch

from . import _lib, ref


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor, *,
                      reverse: bool = False) -> torch.Tensor:
    """Plain version of ``linear_scan`` (any device)."""
    if reverse:
        return ref.rglru_scan_reverse_ref(a, b)
    return ref.rglru_scan_ref(a, b)


def linear_scan(a: torch.Tensor, b: torch.Tensor, *,
                reverse: bool = False) -> torch.Tensor:
    """a, b: (B, S, R) -> (B, S, R) float32.

    ``reverse=False``: h_t = a_t * h_{t-1} + b_t from t = 0 (h_{-1} = 0).
    ``reverse=True``: g_t = a_{t+1} * g_{t+1} + b_t from t = S-1 (g_S = 0) —
    with b = dL/dh this is dL/db of the forward scan."""
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"expected two equal (B, S, R) shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return linear_scan_plain(a, b, reverse=reverse)
    for t in (a, b):
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel scans float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors")
    if a.device != b.device:
        raise ValueError(f"inputs on {a.device} and {b.device}")
    out = torch.empty_like(b)
    B, S, R = a.shape
    _lib.LAUNCHES["rglru_scan"] += 1
    _lib.check(_lib.lib().rt_rglru_scan(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, R, int(reverse),
        _lib.stream_of(a)), "rglru_scan")
    return out


class _RGLRUScan(torch.autograd.Function):
    """h = scan(a, b); dL/db = reverse scan of dL/dh, dL/da_t = dL/db_t *
    h_{t-1} (h_{-1} = 0)."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = a.contiguous(), b.contiguous()
        h = linear_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        g = linear_scan(a, dh.to(h.dtype).contiguous(), reverse=True)
        h_prev = torch.zeros_like(h)
        h_prev[:, 1:] = h[:, :-1]
        return g * h_prev, g


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, S, R) recurrence h_t = a_t * h_{t-1} + b_t."""
    return _RGLRUScan.apply(a, b)
