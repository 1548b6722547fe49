"""RG-LRU linear-recurrence scan: h_t = a_t * h_{t-1} + b_t over a sequence.

Counterpart of ``repro/kernels/rglru.py`` (and of the associative scan in
``repro/models/layers.py``'s ``rglru_apply`` that the Pallas kernel replaces).
``linear_scan`` runs the recurrence in either direction and
``linear_scan_grad`` forms the whole backward (dL/da and dL/db) in one pass:
on CUDA tensors each launches the hand-written kernel of ``csrc/rglru.cu``
once; on CPU tensors they run the plain PyTorch versions of ``ref.py`` — the
same arithmetic, bit for bit. ``rglru_scan`` is the differentiable op the
model calls: its backward is one ``linear_scan_grad``.

Shapes are (B, S, R) float32 of any size: the kernel needs no padding.
"""

from __future__ import annotations

import torch

from . import _lib, ref

_MODES = {"forward": 0, "reverse": 1, "grad": 2}
# launches of the kernel by copy variant (see ``copy_variant``); the
# launch count of the wrapper is ``_lib.LAUNCHES["rglru_scan"]``
COPY_LAUNCHES = {"bulk": 0, "cp.async": 0}


def copy_variant(*inputs: torch.Tensor) -> str:
    """How the kernel fills its shared-memory ring from ``inputs``:
    ``"bulk"`` (TMA bulk copies) when every row segment starts 16-byte
    aligned — R % 4 == 0 and every base pointer 16-byte aligned — else
    ``"cp.async"`` (4 bytes a thread)."""
    aligned = inputs[0].shape[-1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in inputs)
    return "bulk" if aligned else "cp.async"


def _check(*ts: torch.Tensor) -> None:
    shape = ts[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in ts):
        raise ValueError(f"expected equal (B, S, R) shapes, got "
                         f"{[tuple(t.shape) for t in ts]}")


def _launch(mode: str, a, b, h=None, da=None) -> torch.Tensor:
    inputs = (a, b) if h is None else (a, b, h)
    for t in inputs:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel scans float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors")
        if t.device != a.device:
            raise ValueError(f"inputs on {a.device} and {t.device}")
    out = torch.empty_like(b)
    variant = copy_variant(*inputs)
    B, S, R = a.shape
    _lib.LAUNCHES["rglru_scan"] += 1
    COPY_LAUNCHES[variant] += 1
    _lib.check(_lib.lib().rt_rglru_scan(
        a.data_ptr(), b.data_ptr(), None if h is None else h.data_ptr(),
        out.data_ptr(), None if da is None else da.data_ptr(), B, S, R,
        _MODES[mode], int(variant == "bulk"), _lib.stream_of(a)),
        "rglru_scan")
    return out


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
    _check(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return linear_scan_plain(a, b, reverse=reverse)
    return _launch("reverse" if reverse else "forward", a, b)


def linear_scan_grad_plain(a: torch.Tensor, h: torch.Tensor,
                           dh: torch.Tensor):
    """Plain version of ``linear_scan_grad`` (any device)."""
    return ref.rglru_scan_grad_ref(a, h, dh)


def linear_scan_grad(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The backward of h = scan(a, b) from its output h and dh = dL/dh, in
    one pass: returns (da, g) with g_t = a_{t+1} * g_{t+1} + dh_t
    (g_S = 0), which is dL/db, and da_t = g_t * h_{t-1} (h_{-1} = 0)."""
    _check(a, h, dh)
    if all(t.device.type == "cpu" for t in (a, h, dh)):
        return linear_scan_grad_plain(a, h, dh)
    da = torch.empty_like(dh)
    g = _launch("grad", a, dh, h, da)
    return da, g


class _RGLRUScan(torch.autograd.Function):
    """h = scan(a, b); dL/db = reverse scan of dL/dh, dL/da_t = dL/db_t *
    h_{t-1} (h_{-1} = 0) — one kernel launch."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = a.contiguous(), b.contiguous()
        h = linear_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return linear_scan_grad(a, h, dh.to(h.dtype).contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, S, R) recurrence h_t = a_t * h_{t-1} + b_t."""
    return _RGLRUScan.apply(a, b)
