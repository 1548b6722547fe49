"""Plain PyTorch versions of every checkpoint kernel (the ground truth).

Counterpart of ``repro/kernels/ref.py``: the same functions on torch
tensors, on any device, with the same bits. The kernel modules' CPU paths
and the on-card checks of ``chip_smoke.py`` go through these.

Integer digests use int64 arithmetic masked to 32 bits: int64 products and
sums wrap mod 2^64, so their low 32 bits are exact mod 2^32 — torch's
``uint32`` has no arithmetic to rely on.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# the same constants as repro/kernels/fingerprint.py
SEEDS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
LENS = (0x165667B1, 0xD3A2646D, 0x9E3779B9, 0x27D4EB2F)
M1, M2 = 0x85EBCA6B, 0xC2B2AE35
INV127 = 1.0 / 127.0      # rounded to f32 where it is used, like the kernels


def quantize_blocks_ref(x: torch.Tensor):
    """x: (R, C) -> (int8 (R, C), f32 scales (R,)); one group per row."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=1)
    inv = torch.tensor(INV127, dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * inv, one)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_blocks_ref(q: torch.Tensor, scales: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scales[:, None].to(torch.float32)
            ).to(out_dtype)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * M1) & MASK32
    x = x ^ (x >> 13)
    x = (x * M2) & MASK32
    return x ^ (x >> 16)


def weights(n_lanes: int, device) -> torch.Tensor:
    """(n_lanes, 4) int64 weights w_k[i] = fmix32((i+1) ^ SEED_k) | 1."""
    i = torch.arange(1, n_lanes + 1, dtype=torch.int64, device=device)
    return torch.stack([fmix32(i ^ s) | 1 for s in SEEDS], dim=1)


def fingerprint_chunks_ref(lanes: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Oracle of the fp128 chunk digest.

    lanes: (n_chunks, CL) uint32 values (any integer dtype holding them);
    lengths: (n_chunks,) or (n_chunks, 1) byte lengths of each chunk's
    digest domain -> (n_chunks, 4) int64 holding the uint32 digests."""
    lanes = lanes.to(torch.int64) & MASK32
    w = weights(lanes.shape[1], lanes.device)
    lens = lengths.reshape(-1).to(torch.int64)
    cols = []
    for k in range(4):
        d = (lanes * w[:, k]).sum(dim=1) + lens * LENS[k]
        cols.append(d & MASK32)
    return torch.stack(cols, dim=1)


def lanes_of(data: torch.Tensor, chunk_bytes: int):
    """Any contiguous tensor -> ((n_chunks, chunk_bytes/4) int64 little-
    endian lanes with the ragged last chunk zero-padded, (n_chunks,) byte
    lengths). ``chunk_bytes`` must be a multiple of 4."""
    b = data.reshape(-1).view(torch.uint8)
    n = b.numel()
    nc = -(-n // chunk_bytes)
    padded = torch.zeros(nc * chunk_bytes, dtype=torch.uint8, device=b.device)
    padded[:n] = b
    # a fresh buffer is 4-byte aligned; little-endian int32 view = the lanes
    lanes = (padded.view(torch.int32).to(torch.int64) & MASK32) \
        .reshape(nc, chunk_bytes // 4)
    lens = torch.full((nc,), chunk_bytes, dtype=torch.int64, device=b.device)
    if nc:
        lens[-1] = n - (nc - 1) * chunk_bytes
    return lanes, lens

