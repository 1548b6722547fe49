"""Common machinery for checkpoint/restore engines.

An engine turns a list of host-resident byte objects (``SaveItem``) into files
under a checkpoint directory and back. Engines differ along exactly the axes
the paper studies: layout (aggregation strategy), I/O backend (uring / threads
/ POSIX), caching mode (O_DIRECT or buffered), submission granularity
(batched-coalesced vs per-object), and buffer management (pooled vs dynamic).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace

import numpy as np

from .. import faults
from ..aggregation import Extent, ObjectSpec, Strategy, WritePlan, plan_layout, rank_padded_total
from ..buffers import AlignedBuffer, BufferPool, PAGE, align_up
from ..io_engine import (IOEngine, IORequest, OP_READ, OP_WRITE, make_engine,
                         open_for, resolve_backend)
from ..manifest import BlobRecord, Manifest, ShardEntry, crc32_of


@dataclass
class SaveItem:
    """One host-resident object to persist.

    ``key`` must be unique across the rank's items (it names the extent);
    ``record_key`` groups multiple shards of one global tensor in the manifest
    (defaults to ``key``).
    """
    key: str
    data: object                      # buffer-protocol object (np.ndarray, bytes, memoryview)
    dtype: str | None = None          # tensor metadata (None for blobs)
    global_shape: tuple[int, ...] | None = None
    index: tuple[tuple[int, int], ...] | None = None  # global (start, stop) per dim
    is_blob: bool = False
    record_key: str | None = None

    @property
    def nbytes(self) -> int:
        return memoryview(self.data).nbytes

    def mv(self) -> memoryview:
        return item_mv(self)


@dataclass
class SaveSpec:
    """Metadata-only declaration of one object a streaming save will ``put``.

    ``SaveItem`` minus the payload: the layout planner assigns file offsets
    from object sizes alone, so a save can be planned — and the cross-rank
    prefix sum exchanged — before a single byte is staged (quantized payload
    sizes are deterministic too, see ``quant_codec.packed_nbytes``)."""
    key: str
    nbytes: int
    dtype: str | None = None
    global_shape: tuple[int, ...] | None = None
    index: tuple[tuple[int, int], ...] | None = None
    is_blob: bool = False
    record_key: str | None = None


def spec_of(item: SaveItem) -> SaveSpec:
    return SaveSpec(item.key, item.nbytes, item.dtype, item.global_shape,
                    item.index, item.is_blob, item.record_key)


@dataclass
class ReadReq:
    """One byte-range to read back.

    ``key`` names the result in the returned dict (unique per request);
    ``obj`` is the logical object key in the manifest (used by engines whose
    formats are object-addressed rather than extent-addressed, e.g. torchsave).
    """
    key: str
    path: str
    offset: int
    nbytes: int
    obj: str | None = None


class ChecksumError(IOError):
    """Restored bytes did not match the CRC the manifest recorded at save."""

    def __init__(self, key: str, path: str, offset: int,
                 expect: int, got: int):
        super().__init__(
            f"CRC mismatch restoring {key!r} ({path} @ byte {offset}): "
            f"got {got:#010x}, manifest says {expect:#010x}")
        self.key = key
        self.path = path
        self.offset = offset
        self.expect = expect
        self.got = got


@dataclass
class IOStats:
    seconds: float = 0.0
    logical_bytes: int = 0
    io_requests: int = 0
    files: int = 0
    alloc_seconds: float = 0.0   # buffer acquisition time (paper Fig 13)
    copy_seconds: float = 0.0    # staging memcpy time
    io_seconds: float = 0.0      # submit+wait time
    peak_staged_bytes: int = 0   # max staged bytes in flight (backpressure)

    @property
    def gbps(self) -> float:
        return self.logical_bytes / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class EngineConfig:
    backend: str = "auto"             # auto | uring | threadpool | posix
    strategy: Strategy | str = Strategy.SINGLE_FILE
    direct: bool = True               # O_DIRECT
    queue_depth: int = 64
    ring_entries: int = 256
    chunk_bytes: int = 64 << 20       # submission chunk for large objects
    coalesce_bytes: int = 64 << 20    # staging-batch target (paper: ~2GB/rank saturates)
    checksum: bool = False
    pooled_buffers: bool = True       # False models DataStates' dynamic allocation
    register_buffers: bool = False    # io_uring fixed buffers
    sqpoll: bool = False
    fsync_on_save: bool = True
    truncate: bool = True             # False: multi-rank shared-file mode
    align: int = PAGE
    inflight_bytes: int = 256 << 20   # streaming-save staged-byte budget

    def normalized(self) -> "EngineConfig":
        """Resolved copy (strategy enum, concrete backend). Pure: the
        receiver is left untouched, so one config object can be shared by
        several engines/managers without them corrupting each other."""
        return replace(self, strategy=Strategy.parse(self.strategy),
                       backend=resolve_backend(self.backend))


class SaveStream:
    """One in-progress streaming save (returned by ``CREngine.begin_save``).

    Contract: every spec declared at ``begin_save`` must be fully ``put``
    before ``end_save``; all calls come from one thread at a time (the
    pipeline's worker), though that may differ from ``begin_save``'s caller.
    Partial puts (``pos > 0``, in order, align-granular) are only valid for
    objects that stand alone in the layout (larger than ``chunk_bytes``)."""

    def put(self, key: str, data, pos: int = 0) -> None:
        raise NotImplementedError

    def end_save(self) -> Manifest:
        raise NotImplementedError

    def abort(self) -> None:
        """Tear down after a failure; safe to call after end_save (no-op)."""


class _BufferedSaveStream(SaveStream):
    """Batch adapter: engines without a native streaming path accumulate the
    puts and run one batch ``save`` at ``end_save`` — same data path and
    manifests as before, no stage/flush overlap."""

    def __init__(self, engine: "CREngine", ckpt_dir: str,
                 specs: list[SaveSpec], step: int, rank: int, num_ranks: int,
                 rank_totals: list[int] | None):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.specs = list(specs)
        self.kw = dict(step=step, rank=rank, num_ranks=num_ranks,
                       rank_totals=rank_totals)
        self._parts: dict[str, list[tuple[int, object]]] = {}
        self._state = "open"            # open → ended | aborted

    def put(self, key: str, data, pos: int = 0) -> None:
        if self._state != "open":
            raise RuntimeError(f"put() on a {self._state} save stream")
        if not isinstance(data, bytes):
            # own the bytes: once a put returns, the save must never read
            # caller memory again (the pipeline's staged-snapshot contract)
            data = np.frombuffer(as_u8(data), np.uint8).copy()
        self._parts.setdefault(key, []).append((pos, data))

    def end_save(self) -> Manifest:
        if self._state != "open":
            raise RuntimeError("end_save() called twice" if
                               self._state == "ended" else
                               "end_save() after abort()")
        self._state = "ended"
        items: list[SaveItem] = []
        for spec in self.specs:
            parts = self._parts.get(spec.key)
            if parts is None:
                raise RuntimeError(f"missing put() for {spec.key!r}")
            # same completeness contract as the native stream: the layout
            # (and any cross-rank prefix sum) was planned from spec.nbytes,
            # so partial coverage must fail loudly, not commit garbage
            covered = 0
            for pos, chunk in sorted(parts, key=lambda p: p[0]):
                if pos != covered:
                    raise RuntimeError(
                        f"non-contiguous puts for {spec.key!r}: "
                        f"byte {covered} missing")
                covered += memoryview(chunk).nbytes
            if covered != spec.nbytes:
                raise RuntimeError(
                    f"end_save with unfilled object {spec.key!r}: "
                    f"{covered} of {spec.nbytes} bytes put")
            if len(parts) == 1:
                data = parts[0][1]
            else:  # chunked puts: assemble the object
                data = np.empty(spec.nbytes, np.uint8)
                for pos, chunk in parts:
                    mv = as_u8(chunk)
                    data[pos:pos + mv.nbytes] = np.frombuffer(mv, np.uint8)
            items.append(SaveItem(spec.key, data, spec.dtype,
                                  spec.global_shape, spec.index,
                                  spec.is_blob, spec.record_key))
        return self.engine.save(self.ckpt_dir, items, **self.kw)

    def abort(self) -> None:
        if self._state == "open":
            self._state = "aborted"
        self._parts.clear()


class ReadStream:
    """One in-progress streaming restore (returned by ``CREngine.begin_restore``).

    Contract: every ``ReadReq`` declared at ``begin_restore`` may be fetched
    exactly once via ``get``; all calls come from one thread (the restore
    pipeline's consumer loop). ``get`` blocks only until *that* request's
    bytes have landed — requests behind it stay in flight, so decode/assemble
    /H2D of tensor k overlaps the reads of tensor k+1. Keys should be
    consumed roughly in declaration (= layout) order: the stream's staged-byte
    budget admits new reads as earlier results are drained, and an
    out-of-order ``get`` may have to exceed the budget by one unit to
    guarantee progress."""

    def get(self, key: str) -> np.ndarray:
        raise NotImplementedError

    def end_restore(self) -> IOStats:
        """Drain remaining I/O, close resources, return the restore stats
        (also published as ``engine.last_restore_stats``)."""
        raise NotImplementedError

    def abort(self) -> None:
        """Tear down after a failure: release every pooled buffer and settle
        the staged-byte books so the engine is reusable. Safe to call after
        end_restore (no-op)."""


class _BufferedReadStream(ReadStream):
    """Batch adapter: engines without a native streaming read run one batch
    ``read`` up front — same data path and stats as before, no overlap —
    then serve ``get`` from the result, validating CRCs per request."""

    def __init__(self, engine: "CREngine", ckpt_dir: str,
                 reqs: list[ReadReq], crcs: dict[str, int] | None):
        self.engine = engine
        self.reqs = {r.key: r for r in reqs}
        self.crcs = dict(crcs or {}) if engine.config.checksum else {}
        self._out = engine.read(ckpt_dir, reqs)
        # the batch read staged every request in host memory at once — make
        # the stats say so (the stream path reports its bounded peak here)
        stats = engine.last_restore_stats
        stats.peak_staged_bytes = max(stats.peak_staged_bytes,
                                      sum(r.nbytes for r in reqs))
        self._state = "open"            # open → ended | aborted

    def get(self, key: str) -> np.ndarray:
        if self._state != "open":
            raise RuntimeError(f"get() on a {self._state} read stream")
        raw = self._out.pop(key)        # KeyError on unknown/repeated key
        expect = self.crcs.get(key)
        if expect is not None:
            got = crc32_of(raw)
            if got != expect:
                r = self.reqs[key]
                raise ChecksumError(key, r.path, r.offset, expect, got)
        return raw

    def end_restore(self) -> IOStats:
        if self._state != "open":
            raise RuntimeError("end_restore() called twice" if
                               self._state == "ended" else
                               "end_restore() after abort()")
        self._state = "ended"
        self._out.clear()
        return self.engine.last_restore_stats

    def abort(self) -> None:
        if self._state == "open":
            self._state = "aborted"
        self._out.clear()


class CREngine:
    """Base class. Subclasses set ``name`` and override save/restore."""

    name = "base"
    supports_streaming = False   # True: begin_save overlaps staging & flush
    supports_streaming_read = False  # True: begin_restore overlaps read/consume

    def __init__(self, config: EngineConfig | None = None,
                 pool: BufferPool | None = None):
        self.config = (config or EngineConfig()).normalized()
        self.pool = pool or BufferPool(disabled=not self.config.pooled_buffers)
        self.last_save_stats = IOStats()
        self.last_restore_stats = IOStats()

    # ------------------------------------------------------------------ API
    def save(self, ckpt_dir: str, items: list[SaveItem], *, step: int = 0,
             rank: int = 0, num_ranks: int = 1,
             rank_totals: list[int] | None = None) -> Manifest:
        raise NotImplementedError

    def begin_save(self, ckpt_dir: str, specs: list[SaveSpec], *,
                   step: int = 0, rank: int = 0, num_ranks: int = 1,
                   rank_totals: list[int] | None = None) -> SaveStream:
        """Open a streaming save: the layout is planned from ``specs`` up
        front, then payloads arrive via ``put`` in any key order. Engines
        with ``supports_streaming`` flush each staged extent as it lands;
        this base fallback buffers and delegates to batch ``save``."""
        return _BufferedSaveStream(self, ckpt_dir, specs, step, rank,
                                   num_ranks, rank_totals)

    def read(self, ckpt_dir: str, reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def begin_restore(self, ckpt_dir: str, reqs: list[ReadReq], *,
                      crcs: dict[str, int] | None = None) -> ReadStream:
        """Open a streaming restore over ``reqs``. Engines with
        ``supports_streaming_read`` surface each request's bytes as its
        extents land, verifying CRCs incrementally (``crcs`` maps request
        key → expected crc32; checked only when ``config.checksum`` is set).
        This base fallback runs one batch ``read`` and validates per get."""
        return _BufferedReadStream(self, ckpt_dir, reqs, crcs)

    def close(self) -> None:
        self.pool.drain()

    # --------------------------------------------------------------- helpers
    def _make_io(self, fixed: list[AlignedBuffer] | None = None) -> IOEngine:
        kw = {}
        if self.config.backend == "uring":
            kw = {"entries": self.config.ring_entries, "sqpoll": self.config.sqpoll}
            if fixed and self.config.register_buffers:
                kw["fixed_buffers"] = fixed
        elif self.config.backend == "threadpool":
            kw = {"workers": min(self.config.queue_depth, 16)}
        return make_engine(self.config.backend, **kw)

    def _plan(self, items: list[SaveItem], rank: int,
              rank_totals: list[int] | None) -> WritePlan:
        objects = [ObjectSpec(i.key, i.nbytes) for i in items]
        if (Strategy.parse(self.config.strategy) is Strategy.SINGLE_FILE
                and rank_totals is None):
            rank_totals = [rank_padded_total(objects, self.config.align)]
        return plan_layout(objects, self.config.strategy, rank=rank,
                           rank_totals=rank_totals, align=self.config.align)

    def _manifest_from(self, items: list[SaveItem], plan: WritePlan, *,
                       step: int, num_ranks: int,
                       crcs: dict[str, int] | None = None) -> Manifest:
        m = Manifest(step=step, num_ranks=num_ranks,
                     strategy=Strategy.parse(self.config.strategy).value)
        by_key = {e.key: e for e in plan.extents}
        for it in items:
            e = by_key[it.key]
            crc = (crcs or {}).get(it.key)
            rkey = it.record_key or it.key
            if it.is_blob:
                m.blobs[rkey] = BlobRecord(rkey, e.path, e.offset,
                                           e.nbytes, crc)
            else:
                index = it.index
                if index is None:
                    index = tuple((0, s) for s in (it.global_shape if it.global_shape is not None else ()))
                m.add_shard(rkey, it.dtype or "uint8",
                            it.global_shape if it.global_shape is not None else (it.nbytes,),
                            ShardEntry(index, e.path, e.offset, e.nbytes, crc))
        # the writing rank, so a merge (rank-0 commit) is idempotent per rank
        m.extra["rank"] = plan.rank
        m.extra["engine"] = {
            "name": self.name, "backend": self.config.backend,
            "direct": self.config.direct, "queue_depth": self.config.queue_depth,
            "chunk_bytes": self.config.chunk_bytes,
            "coalesce_bytes": self.config.coalesce_bytes,
        }
        return m

    def _open_files(self, ckpt_dir: str, plan_or_paths, mode: str,
                    preallocate: bool = False,
                    regions: dict[str, tuple[int, int]] | None = None
                    ) -> dict[str, int]:
        """``regions`` maps path -> (offset, length) to preallocate instead
        of the whole file — in multi-rank shared-file mode each rank
        fallocates only ITS region, keeping the serialized metadata op
        O(per-rank bytes) rather than O(file size) × ranks."""
        fds: dict[str, int] = {}
        if isinstance(plan_or_paths, WritePlan):
            sizes = plan_or_paths.file_sizes
        else:
            sizes = {p: 0 for p in plan_or_paths}
        for path, size in sizes.items():
            full = os.path.join(ckpt_dir, path)
            mode_eff = "rw" if (mode == "w" and not self.config.truncate) \
                else mode
            fd = open_for(full, mode_eff, direct=self.config.direct)
            if preallocate and mode != "r" and size:
                off, length = (regions or {}).get(path, (0, size))
                try:
                    if length:
                        faults.posix_fallocate(fd, off, length)
                # modeled fallback for filesystems without fallocate — an
                # injected ENOSPC degrades to extend-on-write by design
                # crlint: allow(CRL005): fallocate fallback is the contract
                except OSError:
                    pass
            fds[path] = fd
        return fds

    @staticmethod
    def _close_files(fds: dict[str, int]) -> None:
        for fd in fds.values():
            os.close(fd)

    def _fsync_all(self, io: IOEngine, fds: dict[str, int]) -> None:
        if self.config.fsync_on_save:
            for fd in fds.values():
                io.fsync(fd)


def as_u8(data) -> memoryview:
    """Flat uint8 memoryview of any buffer-protocol object."""
    m = memoryview(data)
    if m.format != "B" or m.ndim != 1:
        m = m.cast("B")
    return m


def item_mv(it: "SaveItem") -> memoryview:
    return as_u8(it.data)
