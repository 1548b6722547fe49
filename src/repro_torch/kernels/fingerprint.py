"""fp128 chunk fingerprints + the fused quantize+fingerprint kernel.

Counterpart of ``repro/kernels/fingerprint.py`` (DESIGN.md §14): a per-chunk
128-bit non-cryptographic digest computed where the bytes already live, so
the delta diff runs before any D2H copy and only dirty chunks cross the
link. On a CUDA tensor the wrappers launch the kernels of
``csrc/fingerprint.cu``; on a CPU tensor they run the plain PyTorch
versions. ``fingerprint_chunks_host`` is the numpy host twin, carried over
verbatim — all three give the same digests, bit for bit, as the JAX
package's Pallas kernel, XLA oracle and numpy fallback.

Digest spec (``fp128`` / version 1):

  lanes     the chunk's bytes, zero-padded to a multiple of 4, viewed as
            little-endian uint32 words ``v_0 .. v_{L-1}``.
  weights   ``w_k[i] = fmix32((i+1) ^ SEED_k) | 1`` for four fixed seeds.
  digest    ``d_k = (sum_i v_i * w_k[i] + n * LEN_k)  mod 2^32`` where
            ``n`` is the chunk's byte length. Serialized as 32 hex chars.

Digest tables are int32 tensors holding the uint32 bits on the tensor's
device; ``digest_table`` brings one to the host as numpy uint32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _lib, ref
from .quantize import (LANE_COLS, _f32_source, _outputs, _rows_of,
                       quantize_blocks, quantize_blocks_plain, require_cuda)

LANE_BYTES = 4

_SEEDS = ref.SEEDS
_LEN = ref.LENS
_M1, _M2 = ref.M1, ref.M2


def lanes_per_chunk(chunk_bytes: int) -> int:
    return -(-chunk_bytes // LANE_BYTES)


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 16
    x = x * np.uint32(_M1)
    x ^= x >> 13
    x = x * np.uint32(_M2)
    x ^= x >> 16
    return x


@functools.lru_cache(maxsize=64)
def _weights_host(n_lanes: int) -> np.ndarray:
    """(n_lanes, 4) uint32 weight matrix, cached per lane count."""
    i = np.arange(1, n_lanes + 1, dtype=np.uint32)
    return np.stack(
        [_fmix32_np(i ^ np.uint32(s)) | np.uint32(1) for s in _SEEDS],
        axis=1)


# ------------------------------------------------------------------ host twin
def fingerprint_chunks_host(payload: np.ndarray,
                            chunk_bytes: int) -> np.ndarray:
    """Digest every chunk of a host payload: (n_chunks, 4) uint32.

    One uint32 matmul over the full-chunk body (zero-copy view when the
    grid is lane-aligned), a short padded loop for the ragged tail —
    ~1 memory pass total, which is the point of replacing blake2b.
    """
    payload = np.ascontiguousarray(payload).reshape(-1).view(np.uint8)
    n = payload.nbytes
    nc = -(-n // chunk_bytes) if n else 0
    out = np.zeros((nc, 4), np.uint32)
    if nc == 0:
        return out
    cl = lanes_per_chunk(chunk_bytes)
    w = _weights_host(cl)
    body = n // chunk_bytes if chunk_bytes % LANE_BYTES == 0 else 0
    if body:
        lanes = payload[:body * chunk_bytes].view(np.uint32) \
            .reshape(body, cl)
        np.matmul(lanes, w, out=out[:body])
    for j in range(body, nc):
        pos = j * chunk_bytes
        m = min(chunk_bytes, n - pos)
        lanes_n = -(-m // LANE_BYTES)
        buf = np.zeros(lanes_n * LANE_BYTES, np.uint8)
        buf[:m] = payload[pos:pos + m]
        out[j] = buf.view(np.uint32) @ w[:lanes_n]
    lens = np.full(nc, chunk_bytes, np.uint32)
    lens[-1] = n - (nc - 1) * chunk_bytes
    out += lens[:, None] * np.asarray(_LEN, np.uint32)
    return out


def digest_hex(d) -> str:
    """One digest row -> 32 hex chars (blake2b-128 width)."""
    return "%08x%08x%08x%08x" % tuple(int(v) for v in d)


def digests_hex(d: np.ndarray) -> list[str]:
    return [digest_hex(row) for row in np.asarray(d)]


def digest_bytes(data) -> str:
    """fp128 of one standalone chunk (domain = exactly these bytes) — the
    store scrubber's content check of fp128 references."""
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    if a.nbytes == 0:
        return digest_hex(np.zeros(4, np.uint32))
    return digest_hex(fingerprint_chunks_host(a, a.nbytes)[0])


def digest_table(d: torch.Tensor) -> np.ndarray:
    """(n_chunks, 4) int32 digest tensor -> host numpy uint32 (16 B/chunk
    cross the link)."""
    return d.to("cpu").numpy().view(np.uint32)


def _as_int32_bits(d: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    return (d - ((d >> 31) << 32)).to(torch.int32)


def _byte_view(data: torch.Tensor) -> torch.Tensor:
    return data.reshape(-1).view(torch.uint8)


# ------------------------------------------------------- chunk fingerprints
def fingerprint_chunks_plain(data: torch.Tensor,
                             chunk_bytes: int) -> torch.Tensor:
    """Plain version of ``fingerprint_chunks`` (any device)."""
    if chunk_bytes % LANE_BYTES:
        raise ValueError("chunk_bytes must be a multiple of 4")
    if data.numel() == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=data.device)
    lanes, lens = ref.lanes_of(data, chunk_bytes)
    return _as_int32_bits(ref.fingerprint_chunks_ref(lanes, lens))


def fingerprint_chunks(data: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Digest the byte image of a contiguous tensor on the ``chunk_bytes``
    grid (the last chunk ragged) -> (n_chunks, 4) int32 digest bits."""
    if data.device.type == "cpu":
        return fingerprint_chunks_plain(data, chunk_bytes)
    require_cuda(data)
    if chunk_bytes % LANE_BYTES or chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be a positive multiple of 4")
    nbytes = data.numel() * data.element_size()
    if nbytes and data.data_ptr() % LANE_BYTES:
        raise ValueError("kernel reads 4-byte lanes: align the source")
    nc = -(-nbytes // chunk_bytes)
    d = torch.empty((nc, 4), dtype=torch.int32, device=data.device)
    _lib.LAUNCHES["fingerprint_chunks"] += 1
    _lib.check(_lib.lib().rt_fingerprint_chunks(
        data.data_ptr(), nbytes, chunk_bytes, d.data_ptr(),
        _lib.stream_of(data)), "fingerprint_chunks")
    return d


def fingerprint_digests(flat: torch.Tensor, chunk_bytes: int) -> np.ndarray:
    """Digest a tensor's byte image where it lives; only the (n_chunks, 4)
    table — 16 bytes per chunk — comes back to the host."""
    return digest_table(fingerprint_chunks(flat.contiguous(), chunk_bytes))


# ------------------------------------------- fused quantize + fingerprint
def _chunk_rows(chunk_bytes: int) -> int:
    if chunk_bytes % LANE_COLS:
        raise ValueError(f"chunk_bytes must be a multiple of {LANE_COLS}")
    return chunk_bytes // LANE_COLS


def quantize_fingerprint_blocks_plain(x: torch.Tensor, chunk_bytes: int,
                                      rows: int | None = None):
    """Plain version of ``quantize_fingerprint_blocks`` (any device)."""
    q, s = quantize_blocks_plain(x, rows)
    cr = _chunk_rows(chunk_bytes)
    if q.shape[0] % cr:
        raise ValueError(f"{q.shape[0]} rows are not whole {cr}-row chunks")
    return q, s, fingerprint_chunks_plain(q, chunk_bytes)


def quantize_fingerprint_blocks(x: torch.Tensor, chunk_bytes: int,
                                rows: int | None = None, *, out=None):
    """Fused quantize + fingerprint: x (R, LANE_COLS) f32, or 1-D with
    ``rows``, R covering whole chunks of ``chunk_bytes // LANE_COLS`` rows
    -> (q, scales, (n_chunks, 4) int32 digests of the q stream)."""
    if x.device.type == "cpu":
        q, s, d = quantize_fingerprint_blocks_plain(x, chunk_bytes, rows)
        if out is not None:
            out[0].copy_(q)
            out[1].copy_(s)
            q, s = out
        return q, s, d
    rows, n_valid = _rows_of(x, rows)
    cr = _chunk_rows(chunk_bytes)
    if rows % cr:
        raise ValueError(f"{rows} rows are not whole {cr}-row chunks")
    _f32_source(x, n_valid)
    q, s = _outputs(x, rows, out)
    nc = rows // cr
    d = torch.empty((nc, 4), dtype=torch.int32, device=x.device)
    _lib.LAUNCHES["quantize_fingerprint_blocks"] += 1
    _lib.check(_lib.lib().rt_quant_fingerprint_blocks(
        x.data_ptr(), n_valid, nc, cr, q.data_ptr(), s.data_ptr(),
        d.data_ptr(), _lib.stream_of(x)), "quantize_fingerprint_blocks")
    return q, s, d


def _qs_bytes(q: torch.Tensor, s: torch.Tensor, start: int) -> torch.Tensor:
    """Bytes [start:] of the packed qs stream (int8 q rows, then f32 scales)."""
    return torch.cat([_byte_view(q)[start:], _byte_view(s)])


def quant_fingerprint(flat: torch.Tensor, rows: int, chunk_bytes: int):
    """Quantize ``flat`` (f32, zero-extended to ``rows`` x LANE_COLS) where
    it lives and digest the packed qs stream on the ``chunk_bytes`` grid.
    Returns ``(q, s)`` on the tensor's device plus the host digest table.

    On the card, the fused kernel covers every chunk made purely of q
    bytes; the remaining rows are quantized by ``quantize_blocks`` and the
    tail (q remainder + the scales region) digested by
    ``fingerprint_chunks``. On the CPU, the plain versions do the same."""
    if flat.device.type == "cpu" or chunk_bytes % LANE_COLS:
        q, s = quantize_blocks(flat, rows)
        d = fingerprint_chunks(_qs_bytes(q, s, 0), chunk_bytes)
        return q, s, digest_table(d)
    cr = chunk_bytes // LANE_COLS
    body = rows // cr                      # chunks made only of q bytes
    body_rows = body * cr
    q = torch.empty((rows, LANE_COLS), dtype=torch.int8, device=flat.device)
    s = torch.empty((rows,), dtype=torch.float32, device=flat.device)
    tables = []
    if body:
        n_body = min(flat.numel(), body_rows * LANE_COLS)
        _q, _s, db = quantize_fingerprint_blocks(
            flat[:n_body], chunk_bytes, body_rows,
            out=(q[:body_rows], s[:body_rows]))
        tables.append(db)
    if body_rows < rows:
        quantize_blocks(flat[body_rows * LANE_COLS:], rows - body_rows,
                        out=(q[body_rows:], s[body_rows:]))
    tables.append(fingerprint_chunks(
        _qs_bytes(q, s, body * chunk_bytes), chunk_bytes))
    return q, s, digest_table(torch.cat(tables))
