"""Blockwise int8 quantization of checkpoint tensors (PQ8P payloads).

Counterpart of ``repro/kernels/quantize.py``. Quantizing optimizer moments
(f32 -> int8 + one f32 scale per 512-value row) cuts their flush bytes
~3.9x. On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/quantize.cu``; on a CPU tensor they run the plain PyTorch versions
(``*_plain``) — the same bits, byte for byte, as the JAX package.

Layout: the input is viewed as (rows, LANE_COLS), one quantization group per
row. A 1-D input with ``rows`` given is zero-extended to rows*LANE_COLS
values — virtually on the card (the kernel reads zeros past the end), so a
saved tensor is never copied into a padded buffer.
"""

from __future__ import annotations

import torch

from . import _lib, ref

ROW_BLK = 8
LANE_COLS = 512

_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
              torch.float64: 3}


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """1-D values -> (rows, LANE_COLS), zero-extended."""
    flat = x.reshape(-1)
    if flat.numel() > rows * LANE_COLS:
        raise ValueError(f"{flat.numel()} values exceed {rows} rows")
    out = torch.zeros(rows * LANE_COLS, dtype=flat.dtype, device=flat.device)
    out[:flat.numel()] = flat
    return out.reshape(rows, LANE_COLS)


def _rows_of(x: torch.Tensor, rows: int | None) -> tuple[int, int]:
    """(rows, n_valid) of a (R, LANE_COLS) input or a 1-D one with rows."""
    if rows is None:
        if x.dim() != 2 or x.shape[1] != LANE_COLS:
            raise ValueError(f"expected (R, {LANE_COLS}), got {tuple(x.shape)}")
        return x.shape[0], x.numel()
    if x.dim() != 1 or x.numel() > rows * LANE_COLS:
        raise ValueError(f"expected <= {rows * LANE_COLS} values in 1-D, "
                         f"got {tuple(x.shape)}")
    return rows, x.numel()


def require_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors")


def _f32_source(x: torch.Tensor, n_valid: int) -> None:
    require_cuda(x)
    if x.dtype != torch.float32:
        raise TypeError(f"kernel quantizes float32, got {x.dtype}")
    if n_valid and x.data_ptr() % 16:
        raise ValueError("kernel needs a 16-byte aligned source")


def _outputs(x: torch.Tensor, rows: int, out):
    if out is None:
        return (torch.empty((rows, LANE_COLS), dtype=torch.int8,
                            device=x.device),
                torch.empty((rows,), dtype=torch.float32, device=x.device))
    q, s = out
    require_cuda(q, s)
    if (q.dtype != torch.int8 or tuple(q.shape) != (rows, LANE_COLS)
            or s.dtype != torch.float32 or tuple(s.shape) != (rows,)):
        raise ValueError("out must be int8 (rows, LANE_COLS) and f32 (rows,)")
    if q.data_ptr() % 4:
        raise ValueError("kernel writes q as 4-byte words: align it")
    return q, s


# ------------------------------------------------------------------ quantize
def quantize_blocks_plain(x: torch.Tensor, rows: int | None = None):
    """Plain version of ``quantize_blocks`` (any device)."""
    if rows is not None:
        x = pad_rows(x, rows)
    return ref.quantize_blocks_ref(x)


def quantize_blocks(x: torch.Tensor, rows: int | None = None, *, out=None):
    """x: (R, LANE_COLS) f32, or 1-D f32 with ``rows`` -> (int8 q (R,
    LANE_COLS), f32 scales (R,)). ``out=(q, s)`` writes into given tensors."""
    if x.device.type == "cpu":
        q, s = quantize_blocks_plain(x, rows)
        if out is not None:
            out[0].copy_(q)
            out[1].copy_(s)
            return out
        return q, s
    rows, n_valid = _rows_of(x, rows)
    _f32_source(x, n_valid)
    q, s = _outputs(x, rows, out)
    _lib.LAUNCHES["quantize_blocks"] += 1
    _lib.check(_lib.lib().rt_quantize_blocks(
        x.data_ptr(), n_valid, rows, q.data_ptr(), s.data_ptr(),
        _lib.stream_of(x)), "quantize_blocks")
    return q, s


# ---------------------------------------------------------------- dequantize
def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor,
                            out_dtype=torch.bfloat16, n: int | None = None):
    """Plain version of ``dequantize_blocks`` (any device)."""
    x = ref.dequantize_blocks_ref(q, scales, out_dtype)
    return x if n is None else x.reshape(-1)[:n]


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      out_dtype=torch.bfloat16, n: int | None = None):
    """f32(q) * scale -> ``out_dtype``: (R, LANE_COLS), or the first ``n``
    values flattened when ``n`` is given."""
    if q.device.type == "cpu":
        return dequantize_blocks_plain(q, scales, out_dtype, n)
    require_cuda(q, scales)
    R = q.shape[0]
    if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != LANE_COLS
            or scales.dtype != torch.float32 or tuple(scales.shape) != (R,)):
        raise ValueError("expected int8 (R, LANE_COLS) q and f32 (R,) scales")
    if q.data_ptr() % 4:
        raise ValueError("kernel reads q as 4-byte words: align it")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if n is None:
        out = torch.empty((R, LANE_COLS), dtype=out_dtype, device=q.device)
        n_out = R * LANE_COLS
    else:
        if not 0 <= n <= R * LANE_COLS:
            raise ValueError(f"n={n} outside the {R * LANE_COLS} values")
        out = torch.empty((n,), dtype=out_dtype, device=q.device)
        n_out = n
    _lib.LAUNCHES["dequantize_blocks"] += 1
    _lib.check(_lib.lib().rt_dequantize_blocks(
        q.data_ptr(), scales.data_ptr(), n_out, _OUT_CODES[out_dtype],
        out.data_ptr(), _lib.stream_of(q)), "dequantize_blocks")
    return out
