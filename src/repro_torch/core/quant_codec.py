"""int8 checkpoint codec — beyond-paper flush-volume optimization.

Counterpart of ``repro/core/quant_codec.py``, same wire format, same bytes.
Quantizing optimizer moments (fp32 -> int8 + per-512-group scales) cuts
their flush bytes ~3.9x. ``pack`` quantizes a CUDA tensor on the card
(``kernels.quantize.quantize_blocks``) and copies only q and the scales to
the host; ``unpack`` copies them back and decodes on the card
(``dequantize_blocks``) to the exact bits the JAX package's host decode
gives. CPU tensors take the plain PyTorch versions.

Wire format per packed shard (little-endian):
    magic  u32 = 0x51384B50  ("PQ8P")
    orig_nbytes u64, rows u32, cols u32
    q payload  int8[rows*cols]
    scales     f32[rows]
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..kernels.quantize import ROW_BLK, dequantize_blocks, quantize_blocks
from .serialization import itemsize, torch_dtype

MAGIC = 0x51384B50
HEADER = struct.Struct("<IQII")
GROUP_COLS = 512   # must match kernels.quantize.LANE_COLS


def packed_rows(n_elems: int) -> int:
    rows = -(-n_elems // GROUP_COLS)
    return -(-rows // ROW_BLK) * ROW_BLK


def packed_nbytes(n_elems: int) -> int:
    """Exact ``pack`` output size for an ``n_elems``-element input (a
    function of the element count alone, so saves plan offsets before any
    packing runs)."""
    rows = packed_rows(n_elems)
    return HEADER.size + rows * GROUP_COLS + rows * 4


def header(n_elems: int) -> bytes:
    """The packed header; ``orig_nbytes`` is the f32 byte count, as in
    the JAX package (which casts to f32 before measuring)."""
    return HEADER.pack(MAGIC, n_elems * 4, packed_rows(n_elems), GROUP_COLS)


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def pack(arr, out: torch.Tensor | None = None) -> np.ndarray:
    """Any-shape float tensor (or numpy array) -> packed bytes as a host
    uint8 array. ``out``: a host uint8 tensor of ``packed_nbytes`` bytes to
    write into (pinned staging); a fresh buffer otherwise."""
    t = _as_tensor(arr)
    flat = t.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    flat = flat.contiguous()
    n = flat.numel()
    rows = packed_rows(n)
    q, s = quantize_blocks(flat, rows)
    total = packed_nbytes(n)
    if out is None:
        out = torch.empty(total, dtype=torch.uint8)
    elif out.numel() != total or out.dtype != torch.uint8:
        raise ValueError(f"pack needs a {total}-byte uint8 buffer")
    hb = HEADER.size
    out[:hb] = torch.frombuffer(bytearray(header(n)), dtype=torch.uint8)
    qb = rows * GROUP_COLS
    nb = q.device.type != "cpu" and out.is_pinned()
    out[hb:hb + qb].copy_(q.reshape(-1).view(torch.uint8), non_blocking=nb)
    out[hb + qb:].copy_(s.view(torch.uint8), non_blocking=nb)
    if nb:
        torch.cuda.current_stream(q.device).synchronize()
    return out.numpy()


def unpack(raw, orig_dtype, device="cpu") -> torch.Tensor:
    """Inverse of pack: the original bytes as a flat uint8 tensor on
    ``device`` (decoded there)."""
    buf = raw if isinstance(raw, np.ndarray) else np.frombuffer(raw, np.uint8)
    # torch wraps only writable arrays; read streams hand over writable ones
    buf = np.require(buf.reshape(-1).view(np.uint8), requirements="W")
    magic, orig_nbytes, rows, cols = HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError("not a PQ8P quantized payload")
    q_end = HEADER.size + rows * cols
    q = torch.from_numpy(buf[HEADER.size:q_end].view(np.int8))
    s = torch.from_numpy(buf[q_end:q_end + rows * 4].view(np.float32))
    q = q.to(device).reshape(rows, cols)
    s = s.to(device)
    # the JAX package keeps orig_nbytes // itemsize values (clipped to what
    # the rows hold) and casts them to the saved dtype
    n_elem = min(orig_nbytes // itemsize(orig_dtype), rows * cols)
    x = dequantize_blocks(q, s, torch_dtype(orig_dtype), n=n_elem)
    return x.view(torch.uint8)


def is_packed(raw) -> bool:
    try:
        b = raw[:4].tobytes() if hasattr(raw, "tobytes") else bytes(raw[:4])
        return struct.unpack("<I", b)[0] == MAGIC
    except Exception:
        return False
