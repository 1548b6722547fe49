"""Aggregation strategies — the paper's §3.2.1 axis.

Maps a rank's set of checkpoint objects (tensor shards + lean blobs) onto file
extents under one of three layouts:

- ``FILE_PER_TENSOR``  — one file per object. The uncoalesced baseline used by
  DeepSpeed/TorchSnapshot; maximizes metadata load.
- ``FILE_PER_PROCESS`` — one file per rank, objects at sequential aligned
  offsets. Moderate aggregation.
- ``SINGLE_FILE``      — every rank writes disjoint extents of ONE shared file.
  Rank r's base offset is an exclusive prefix-sum of the padded per-rank totals
  (the serialized offset computation the paper describes in §3.6).

All offsets/extents are aligned to ``align`` (page size) so the same plan works
under O_DIRECT. The planner is pure (no I/O) — engines execute plans.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .buffers import PAGE


class Strategy(enum.Enum):
    FILE_PER_TENSOR = "file_per_tensor"
    FILE_PER_PROCESS = "file_per_process"
    SINGLE_FILE = "single_file"

    @classmethod
    def parse(cls, s: "Strategy | str") -> "Strategy":
        return s if isinstance(s, Strategy) else cls(s)


@dataclass(frozen=True)
class ObjectSpec:
    """One savable byte object (a tensor shard or a serialized blob)."""
    key: str
    nbytes: int


@dataclass(frozen=True)
class Extent:
    """Placement of one object inside a checkpoint directory."""
    key: str
    path: str      # relative file path within the checkpoint dir
    offset: int    # aligned byte offset within the file
    nbytes: int    # logical (unpadded) size


@dataclass
class WritePlan:
    strategy: Strategy
    rank: int
    extents: list[Extent] = field(default_factory=list)
    file_sizes: dict[str, int] = field(default_factory=dict)  # path -> aligned bytes
    align: int = PAGE

    @property
    def total_logical_bytes(self) -> int:
        return sum(e.nbytes for e in self.extents)

    @property
    def total_padded_bytes(self) -> int:
        return sum(self.file_sizes.values())

    @property
    def num_files(self) -> int:
        return len(self.file_sizes)

    def by_file(self) -> dict[str, list[Extent]]:
        out: dict[str, list[Extent]] = {}
        for e in self.extents:
            out.setdefault(e.path, []).append(e)
        for lst in out.values():
            lst.sort(key=lambda e: e.offset)
        return out


def _align_up(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def rank_padded_total(objects: list[ObjectSpec], align: int = PAGE) -> int:
    """Padded bytes rank needs in an aggregated layout (for the prefix sum)."""
    return sum(_align_up(o.nbytes, align) for o in objects)


def partition_spans(n: int, parts: int) -> list[tuple[int, int]]:
    """Split ``[0, n)`` into ``parts`` contiguous near-even spans.

    The row-partition used by the multi-writer harness to assign each
    writer (and each elastic-restore reader) its window of a global
    tensor's leading dim. The first ``n % parts`` spans get the extra row,
    so any two rank counts produce overlapping-but-coverable windows —
    exactly what ``plan_window`` reshards across."""
    if parts < 1:
        raise ValueError("parts must be >= 1")
    base, rem = divmod(n, parts)
    out, start = [], 0
    for p in range(parts):
        size = base + (1 if p < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def single_file_base_offsets(rank_totals: list[int], align: int = PAGE) -> list[int]:
    """Exclusive prefix-sum of per-rank padded totals (paper §3.6).

    On a real multi-host deployment this scan is the serialized cross-rank
    dependency the paper measures; repro.core.checkpoint runs it through a
    process-group allgather, and the multi-process benchmark through a shared
    memory header.
    """
    offs, acc = [], 0
    for t in rank_totals:
        offs.append(acc)
        acc += _align_up(t, align)
    return offs


def plan_layout(objects: list[ObjectSpec], strategy: Strategy | str, rank: int = 0,
                rank_totals: list[int] | None = None, align: int = PAGE,
                data_subdir: str = "data") -> WritePlan:
    """Produce the write plan for this rank's objects under a strategy.

    ``rank_totals`` (padded totals for all ranks) is required for SINGLE_FILE;
    it is the result of the cross-rank prefix-sum exchange.
    """
    strategy = Strategy.parse(strategy)
    plan = WritePlan(strategy=strategy, rank=rank, align=align)

    if strategy is Strategy.FILE_PER_TENSOR:
        for o in objects:
            path = f"{data_subdir}/rank{rank:05d}/{_sanitize(o.key)}.bin"
            plan.extents.append(Extent(o.key, path, 0, o.nbytes))
            plan.file_sizes[path] = _align_up(o.nbytes, align)
        return plan

    if strategy is Strategy.FILE_PER_PROCESS:
        path = f"{data_subdir}/shard{rank:05d}.bin"
        off = 0
        for o in objects:
            plan.extents.append(Extent(o.key, path, off, o.nbytes))
            off += _align_up(o.nbytes, align)
        plan.file_sizes[path] = off
        return plan

    # SINGLE_FILE
    if rank_totals is None:
        raise ValueError("SINGLE_FILE needs rank_totals for the offset prefix-sum")
    bases = single_file_base_offsets(rank_totals, align)
    if rank >= len(bases):
        raise ValueError(f"rank {rank} outside rank_totals of {len(bases)}")
    path = f"{data_subdir}/checkpoint.bin"
    off = bases[rank]
    for o in objects:
        plan.extents.append(Extent(o.key, path, off, o.nbytes))
        off += _align_up(o.nbytes, align)
    total = bases[-1] + _align_up(rank_totals[-1], align)
    plan.file_sizes[path] = total
    return plan


def coalesce(extents: list[Extent], threshold: int, align: int = PAGE
             ) -> list[list[Extent]]:
    """Group file-adjacent extents into batches of ≥ threshold bytes.

    This is the request-level coalescing the paper recommends: extents in a
    group are contiguous in the file (modulo alignment padding) and can be
    staged into one buffer and issued as ONE write. Extents larger than the
    threshold form their own group (written zero-copy from their source).
    """
    groups: list[list[Extent]] = []
    cur: list[Extent] = []
    cur_bytes = 0
    prev_end = None
    for e in sorted(extents, key=lambda e: (e.path, e.offset)):
        padded = _align_up(e.nbytes, align)
        contiguous = (prev_end is not None and cur
                      and e.path == cur[-1].path and e.offset == prev_end)
        if cur and (not contiguous or cur_bytes + padded > threshold):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(e)
        cur_bytes += padded
        prev_end = e.offset + padded
        if cur_bytes >= threshold:
            groups.append(cur)
            cur, cur_bytes, prev_end = [], 0, None
    if cur:
        groups.append(cur)
    return groups


def chunk_extents(path: str, nbytes: int, chunk_bytes: int,
                  align: int = PAGE, start: int = 0) -> list[Extent]:
    """Split one file interval ``[start, start + nbytes)`` into transfer
    extents of at most ``chunk_bytes``.

    This is the planning half of a tier-to-tier copy (DESIGN.md §8): large
    files become pipelined, individually-hedgeable extents at aligned
    boundaries; the final extent carries any unaligned tail. Keys are
    ``<path>@<offset>`` so extents are addressable in transfer stats."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    chunk = _align_up(chunk_bytes, align)
    out: list[Extent] = []
    off = start
    end = start + nbytes
    while off < end:
        n = min(chunk, end - off)
        out.append(Extent(f"{path}@{off}", path, off, n))
        off += n
    return out


def _sanitize(key: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in key)[:180]
