"""Elastic restore planning: map wanted shard windows onto saved extents.

Checkpoints record, per tensor, the *global* shape and each saved shard's
(start, stop) window in global coordinates. Restoring onto a different mesh
(different DP/TP degree, different pod count) means each new device wants a
window that may intersect several saved shards. This module plans the reads:

    wanted window ∩ saved shard  →  (read extent, src slice, dst slice)

The fast path (same-mesh restore) degenerates to exact matches and the whole
extent is read straight into the destination.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import trace
from .manifest import ShardEntry, TensorRecord
from .serialization import torch_dtype

Index = tuple[tuple[int, int], ...]  # (start, stop) per dim


def normalize_index(index, shape) -> Index:
    """Accept tuples of slices or (start, stop) pairs."""
    out = []
    for i, d in enumerate(shape):
        if index is None or i >= len(index):
            out.append((0, d))
            continue
        p = index[i]
        if isinstance(p, slice):
            start = 0 if p.start is None else int(p.start)
            stop = d if p.stop is None else int(p.stop)
            out.append((start, stop))
        else:
            out.append((int(p[0]), int(p[1])))
    return tuple(out)


def intersect(a: Index, b: Index) -> Index | None:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def window_shape(w: Index) -> tuple[int, ...]:
    return tuple(hi - lo for lo, hi in w)


@dataclass(frozen=True)
class ReadPiece:
    """One saved shard contributing to one wanted window."""
    shard: ShardEntry
    src: tuple[slice, ...]   # slice within the saved shard array
    dst: tuple[slice, ...]   # slice within the wanted window array
    exact: bool              # shard == wanted window (whole-extent fast path)


def plan_window(record: TensorRecord, wanted: Index) -> list[ReadPiece]:
    """All pieces needed to fill ``wanted``; raises if coverage is incomplete."""
    pieces: list[ReadPiece] = []
    covered = 0
    for sh in record.shards:
        inter = intersect(tuple(sh.index), wanted)
        if inter is None:
            continue
        src = tuple(slice(lo - s0, hi - s0)
                    for (lo, hi), (s0, _) in zip(inter, sh.index))
        dst = tuple(slice(lo - w0, hi - w0)
                    for (lo, hi), (w0, _) in zip(inter, wanted))
        exact = tuple(sh.index) == wanted
        pieces.append(ReadPiece(sh, src, dst, exact))
        covered += int(np.prod(window_shape(inter), dtype=np.int64))
    want_n = int(np.prod(window_shape(wanted), dtype=np.int64))
    if covered < want_n:
        raise ValueError(
            f"checkpoint does not cover wanted window {wanted} of "
            f"{record.key}: {covered}/{want_n} elements found")
    return pieces


def dedupe_shards(record: TensorRecord) -> list[ShardEntry]:
    """Drop replicated saves of identical windows (DP replicas)."""
    seen: dict[Index, ShardEntry] = {}
    for sh in record.shards:
        seen.setdefault(tuple(sh.index), sh)
    return list(seen.values())


def record_dtype(record: TensorRecord) -> torch.dtype:
    """The saved tensor's torch dtype (from its numpy name)."""
    return torch_dtype(record.dtype)


class WindowAssembler:
    """Incrementally fills one wanted window from per-extent arrivals.

    The window is a tensor on ``device``: each shard's raw bytes are
    ``feed``-ed the moment its extent lands (host bytes are copied to the
    device here, decoded bytes already on the device are copied within it),
    so window assembly overlaps the reads still in flight. Coverage is
    validated up front by ``plan_window``; ``done`` flips once every
    contributing extent has been fed. Each host-to-device copy is an
    ``h2d`` span (tier ``device``), its seconds and bytes summed in
    ``h2d_seconds`` and ``h2d_bytes``.
    """

    def __init__(self, record: TensorRecord, wanted: Index, device="cpu"):
        self.record = record
        self.wanted = wanted
        self.dtype = record_dtype(record)
        self.out = torch.empty(window_shape(wanted), dtype=self.dtype,
                               device=device)
        self.h2d_seconds = 0.0
        self.h2d_bytes = 0
        self._by_extent: dict[tuple[str, int], list[ReadPiece]] = {}
        for piece in plan_window(record, wanted):
            self._by_extent.setdefault(
                (piece.shard.path, piece.shard.offset), []).append(piece)

    def pending_shards(self) -> list[ShardEntry]:
        """One ShardEntry per extent still needed (dedup: an extent feeding
        several pieces of this window is listed once)."""
        return [pieces[0].shard for pieces in self._by_extent.values()]

    def feed(self, shard: ShardEntry, raw) -> None:
        """``raw``: the shard's decoded bytes (uint8 numpy array or tensor,
        ``shard.index`` worth of elements); fills every piece of this window
        the extent contributes."""
        pieces = self._by_extent.pop((shard.path, shard.offset), None)
        if pieces is None:
            return
        sh_shape = window_shape(tuple(shard.index))
        n = int(np.prod(sh_shape, dtype=np.int64)) * self.dtype.itemsize
        if isinstance(raw, np.ndarray):
            # torch wraps only writable arrays: a remote stream hands over
            # read-only views of immutable bytes, which are copied here
            raw = torch.from_numpy(np.require(raw.reshape(-1).view(np.uint8),
                                              requirements="W"))
        arr = raw.reshape(-1)[:n].view(self.dtype).reshape(sh_shape)
        h2d = arr.device.type == "cpu" and self.out.device.type != "cpu"
        for piece in pieces:
            dst = self.out[piece.dst]
            t0 = trace.clock()
            dst.copy_(arr[piece.src])  # from pageable memory: the host waits
            if h2d:
                t1 = trace.clock()
                nbytes = dst.numel() * self.dtype.itemsize
                self.h2d_seconds += t1 - t0
                self.h2d_bytes += nbytes
                trace.complete("h2d", t0, t1, tier="device", nbytes=nbytes)

    @property
    def done(self) -> bool:
        return not self._by_extent

    def result(self) -> torch.Tensor:
        if not self.done:
            missing = [f"{p}@{off}" for p, off in self._by_extent]
            raise RuntimeError(
                f"window {self.wanted} of {self.record.key} incomplete: "
                f"extents {missing[:3]} never arrived")
        return self.out


def assemble(record: TensorRecord, wanted: Index, lookup,
             device="cpu") -> torch.Tensor:
    """Build the wanted window; ``lookup(shard) -> raw uint8 bytes``."""
    asm = WindowAssembler(record, wanted, device)
    for sh in asm.pending_shards():
        asm.feed(sh, lookup(sh))
    return asm.result()
