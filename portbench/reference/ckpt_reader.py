"""A committed checkpoint read back byte for byte, and the digest that the
benchmark compares.

Layout read here: ``<root>/step_<8 digits>/manifest.json`` lists every
tensor by key with its dtype, global shape and shards; each shard names a
file under the step directory, the byte offset and length of its extent
and the zlib CRC32 of those bytes. The single-file layout puts every
extent of a step in ``data/checkpoint.bin``. Blobs (the pickled tree
around the tensors) are listed under ``blobs`` and only checked by CRC.

``digest`` reduces a tensor's bytes to two integers on whatever device
holds them: the sum of its little-endian 16-bit words and their sum
weighted by (position mod 65521) + 1. The program's state is digested on
the card when it is saved or restored, and the file's bytes here; the
two must be equal.
"""

from __future__ import annotations

import json
import os
import re
import zlib

import numpy as np
import torch

STEP_RE = re.compile(r"^step_(\d{8})$")
_WORDS = 1 << 24


def committed_steps(root: str) -> list[int]:
    """Steps whose manifest exists, oldest first."""
    out = []
    for name in os.listdir(root):
        m = STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _words(t: torch.Tensor) -> torch.Tensor:
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat.view(torch.int16)


def digest(t: torch.Tensor) -> torch.Tensor:
    """(2,) int64 on ``t``'s device (module docstring)."""
    w = _words(t)
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for a in range(0, w.numel(), _WORDS):
        part = w[a:a + _WORDS].to(torch.int64)
        pos = torch.arange(a, a + part.numel(), dtype=torch.int64,
                           device=t.device) % 65521 + 1
        out[0] += part.sum()
        out[1] += (part * pos).sum()
    return out


def read_step(root: str, step: int, device="cpu") -> dict:
    """{key: raw bytes as a uint8 tensor on ``device``} of every tensor of
    a step, each shard's CRC checked; raises on a mismatch, a short read
    or a tensor whose shards do not cover its bytes."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json"), encoding="utf-8") as f:
        man = json.load(f)
    if man["step"] != step:
        raise ValueError(f"manifest of step {step} says {man['step']}")
    out, files = {}, {}
    try:
        def extent(rec):
            path = os.path.join(d, rec["path"])
            if path not in files:
                files[path] = open(path, "rb")
            fh = files[path]
            fh.seek(rec["offset"])
            raw = fh.read(rec["nbytes"])
            if len(raw) != rec["nbytes"]:
                raise ValueError(f"{path}: short read at {rec['offset']}")
            if zlib.crc32(raw) & 0xFFFFFFFF != rec["crc32"]:
                raise ValueError(f"{path}: CRC of {rec.get('key')} differs")
            return raw
        for blob in man.get("blobs", {}).values():
            extent(blob)
        for key, t in man["tensors"].items():
            size = int(np.prod(t["global_shape"], dtype=np.int64)) \
                * _itemsize(t["dtype"])
            shards = sorted(t["shards"], key=lambda s: s["index"])
            raw = b"".join(extent(s) for s in shards)
            if len(shards) != 1 or len(raw) != size:
                raise ValueError(f"{key}: {len(shards)} shards, "
                                 f"{len(raw)} of {size} bytes")
            out[key] = torch.frombuffer(bytearray(raw),
                                        dtype=torch.uint8).to(device)
    finally:
        for fh in files.values():
            fh.close()
    return out


def _itemsize(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
            "int64": 8, "float64": 8, "int8": 1, "uint8": 1}[name]


def step_digests(root: str, step: int, device="cpu") -> dict:
    """{key: (2,) int64 digest} of a committed step's tensors."""
    return {k: digest(v) for k, v in read_step(root, step, device).items()}
