"""AggregatedEngine — the paper's "ideal approach", productionized.

Write path (paper Observations 1, 2, 4), exposed as a STREAM
(``begin_save`` / ``put`` / ``end_save``; batch ``save`` is a degenerate
client that puts every item and drains):
  · layout per the configured aggregation strategy (default: single aggregated
    file with cross-rank prefix-sum offsets), planned from sizes alone before
    any payload exists,
  · request-level coalescing: small objects are staged into pooled aligned
    buffers and flushed as FEW LARGE writes (one per ~coalesce_bytes group),
  · large objects are staged through a small ring of chunk buffers so the
    memcpy of chunk k+1 overlaps the write of chunk k (double buffering),
  · staged bytes in flight are bounded by ``config.inflight_bytes`` —
    backpressure reaps completed writes before staging more,
  · O_DIRECT by default (4.8× write uplift in the paper), deep submission
    queues, batched io_uring submission, optional registered buffers.

Restore path (paper Observation 3), exposed as a STREAM
(``begin_restore`` / ``get`` / ``end_restore``; batch ``read`` is a
degenerate client that gets every request and drains):
  · coalesced reads — one I/O per group region covering many small objects,
  · preallocated POOLED buffers (the fix for DataStates' dominant
    allocation cost), O_DIRECT reads for large transfers,
  · per-request results surface the moment their extents land, so the
    consumer dequantizes/assembles/uploads tensor k while the reads for
    tensor k+1 are still in flight,
  · staged bytes in flight (read buffers + landed-but-unconsumed results)
    are bounded by ``config.inflight_bytes`` (StageBudget backpressure),
  · CRCs are verified incrementally against the manifest as extents land
    (``ChecksumError`` names the key and file offset).
"""

from __future__ import annotations

import zlib
from collections import deque

import numpy as np

from .. import trace
from ..aggregation import Extent, coalesce
from ..buffers import BufferPool, StageBudget, align_up
from ..io_engine import IORequest, OP_READ, OP_WRITE
from ..manifest import Manifest
from .base import (ChecksumError, CREngine, IOStats, ReadReq, ReadStream,
                   SaveItem, SaveSpec, SaveStream, as_u8, spec_of)


class _Group:
    """One coalesce group being filled across put() calls."""

    __slots__ = ("extents", "large", "buf", "filled", "seen", "submitted")

    def __init__(self, extents: list[Extent], large: bool):
        self.extents = extents
        self.large = large          # single object streamed in chunks
        self.buf = None             # staging buffer while filling
        self.filled = 0             # logical bytes staged so far
        self.seen = 0               # member objects fully put
        self.submitted = False


class _AggSaveStream(SaveStream):
    """Streaming writer against the io_engine request stream.

    Each put stages its bytes into pooled aligned buffers (coalescing small
    contiguous objects, chunking large ones) and submits the write
    immediately — storage I/O overlaps the caller's next snapshot/pack.
    """

    def __init__(self, eng: "AggregatedEngine", ckpt_dir: str,
                 specs: list[SaveSpec], step: int, rank: int, num_ranks: int,
                 rank_totals: list[int] | None):
        self.eng = eng
        self.cfg = cfg = eng.config
        self.step, self.num_ranks = step, num_ranks
        self.specs = list(specs)
        self.stats = IOStats()
        self.t0 = trace.clock()
        self.plan = eng._plan(self.specs, rank, rank_totals)
        self.extents = {e.key: e for e in self.plan.extents}
        regions = None
        if not cfg.truncate:
            # shared-file (multi-rank) mode: preallocate only this rank's
            # extent span, not the whole file once per rank
            regions = {}
            for path, exts in self.plan.by_file().items():
                start = exts[0].offset
                end = exts[-1].offset + align_up(exts[-1].nbytes, cfg.align)
                regions[path] = (start, end - start)
        self.fds = eng._open_files(ckpt_dir, self.plan, "w",
                                   preallocate=True, regions=regions)
        self.stats.files = len(self.fds)
        self.io = eng._make_io()
        self.budget = StageBudget(cfg.inflight_bytes)
        # clamp staging units to half the budget so the cap is HARD: every
        # buffer class then fits twice, and the admits() idle-override can
        # never be reached by an oversized single unit
        self._chunk = cfg.chunk_bytes
        thr = cfg.coalesce_bytes
        if cfg.inflight_bytes is not None:
            half = max(cfg.inflight_bytes // 2, 1)
            unit = max(cfg.align, 1 << (half.bit_length() - 1))  # floor pow2
            self._chunk = min(self._chunk, unit)
            thr = min(thr, unit)
        self.crcs: dict[str, int] = {}
        self._inflight: dict[int, object] = {}   # token -> buffer to release
        self._token = 0
        self._pos: dict[str, int] = {}           # chunked-put progress per key
        self._group_of: dict[str, _Group] = {}
        self._groups: list[_Group] = []
        for g in coalesce(self.plan.extents, thr, cfg.align):
            grp = _Group(g, len(g) == 1 and g[0].nbytes > self._chunk)
            self._groups.append(grp)
            for e in g:
                self._group_of[e.key] = grp
        self._state = "open"            # open → ended | aborted

    # ------------------------------------------------------------- plumbing
    def _reap(self, block_min: int) -> None:
        for c in self.io.poll(min_n=block_min):
            buf = self._inflight.pop(c.user_data, None)
            if buf is not None:
                self.budget.sub(buf.nbytes)
                buf.release()

    def _acquire(self, span: int):
        """Pooled staging buffer, bounded: reap completed writes until the
        staged bytes in flight admit one more buffer (backpressure).

        The bound is hard for clients that put objects in layout order
        (batch save and the snapshot pipeline): units are clamped to half
        the budget and every blocker is a reapable write. A client that
        interleaves puts across MANY coalesce groups can hold one open
        group buffer per interleaved group above the budget — open group
        buffers are only reclaimable by completing their groups."""
        need = BufferPool.size_class(max(span, 1))
        if not self.budget.admits(need) and self._inflight:
            with trace.span("budget.wait", nbytes=need):
                while not self.budget.admits(need) and self._inflight:
                    self._reap(1)
        buf = self.eng.pool.get(span)
        self.budget.add(buf.nbytes)
        return buf

    def _submit(self, fd: int, file_off: int, buf, span: int) -> None:
        self._token += 1
        self._inflight[self._token] = buf
        self.io.submit([IORequest(OP_WRITE, fd, file_off, buf, 0, span,
                                  user_data=self._token)])
        self.stats.io_requests += 1
        while self.io.inflight >= self.cfg.queue_depth:
            self._reap(1)

    # ------------------------------------------------------------------ API
    def put(self, key: str, data, pos: int = 0) -> None:
        if self._state != "open":
            raise RuntimeError(f"put() on a {self._state} save stream")
        cfg = self.cfg
        mv = as_u8(data)
        e = self.extents[key]
        g = self._group_of[key]
        if cfg.checksum:
            self.crcs[key] = zlib.crc32(mv, self.crcs.get(key, 0)) & 0xFFFFFFFF
        if g.large:
            expect = self._pos.get(key, 0)
            if pos != expect:
                raise ValueError(f"out-of-order put for {key!r}: "
                                 f"pos {pos} != expected {expect}")
            if pos % cfg.align:
                raise ValueError(f"partial put for {key!r} must start on a "
                                 f"{cfg.align}-byte boundary")
            if pos + mv.nbytes > e.nbytes:
                raise ValueError(f"put overruns {key!r}")
            p = 0
            while p < mv.nbytes:
                n = min(self._chunk, mv.nbytes - p)
                ta = trace.clock()
                buf = self._acquire(align_up(n, cfg.align))
                tb = trace.clock()
                buf.view(0, n)[:] = mv[p:p + n]
                tc = trace.clock()
                self.stats.alloc_seconds += tb - ta
                self.stats.copy_seconds += tc - tb
                self._submit(self.fds[e.path], e.offset + pos + p, buf,
                             align_up(n, cfg.align))
                p += n
            self._pos[key] = pos + mv.nbytes
            g.filled += mv.nbytes
            if self._pos[key] == e.nbytes:
                g.seen += 1
                g.submitted = True
            return
        # coalesced member: whole-object put staged into the group buffer
        if pos or mv.nbytes != e.nbytes:
            raise ValueError(f"coalesced object {key!r} needs one whole put")
        first, last = g.extents[0], g.extents[-1]
        span = last.offset + align_up(last.nbytes, cfg.align) - first.offset
        if g.buf is None:
            ta = trace.clock()
            g.buf = self._acquire(span)
            self.stats.alloc_seconds += trace.clock() - ta
        if mv.nbytes:
            tb = trace.clock()
            g.buf.view(e.offset - first.offset, e.nbytes)[:] = mv
            self.stats.copy_seconds += trace.clock() - tb
        g.filled += e.nbytes
        g.seen += 1
        if g.seen == len(g.extents) and not g.submitted:
            g.submitted = True
            buf, g.buf = g.buf, None
            self._submit(self.fds[first.path], first.offset, buf, span)

    def end_save(self) -> Manifest:
        if self._state != "open":
            raise RuntimeError("end_save() called twice" if
                               self._state == "ended" else
                               "end_save() after abort()")
        missing = [e.key for g in self._groups if not g.submitted
                   for e in g.extents]
        if missing:
            self.abort()
            raise RuntimeError(f"end_save with unfilled objects: {missing[:5]}")
        try:
            with trace.span("flush", tier="level0",
                            nbytes=self.plan.total_logical_bytes):
                while self.io.inflight:
                    self._reap(1)
                self._reap(0)   # drain engines that complete inline (posix)
                t_io0 = trace.clock()
                self.eng._fsync_all(self.io, self.fds)
                self.stats.io_seconds += trace.clock() - t_io0
        finally:
            self._state = "ended"
            self.io.close()
            self.eng._close_files(self.fds)
        self.stats.logical_bytes = self.plan.total_logical_bytes
        self.stats.peak_staged_bytes = self.budget.peak
        self.stats.seconds = trace.clock() - self.t0
        self.eng.last_save_stats = self.stats
        return self.eng._manifest_from(self.specs, self.plan, step=self.step,
                                       num_ranks=self.num_ranks,
                                       crcs=self.crcs or None)

    def abort(self) -> None:
        if self._state != "open":
            return
        self._state = "aborted"
        try:
            try:
                while self.io.inflight:
                    self._reap(1)
                self._reap(0)
            # crlint: allow(CRL005): abort() runs under an original error —
            # cleanup here must never mask it; buffers below still released
            except BaseException:
                pass   # inflight state unknown; buffers below still released
            self.io.close()
        finally:
            self.eng._close_files(self.fds)
            for buf in self._inflight.values():
                buf.release()
            self._inflight.clear()
            for g in self._groups:
                if g.buf is not None:
                    g.buf.release()
                    g.buf = None


class _ReadUnit:
    """One submission-granular read: a coalesced group region, or one chunk
    of an extent larger than the (budget-clamped) chunk size."""

    __slots__ = ("path", "file_off", "span", "group", "key", "pos", "n")

    def __init__(self, path: str, file_off: int, span: int, *,
                 group: list[Extent] | None = None, key: str | None = None,
                 pos: int = 0, n: int = 0):
        self.path, self.file_off, self.span = path, file_off, span
        self.group = group          # members of a coalesced group, else None
        self.key, self.pos, self.n = key, pos, n   # chunk of a large extent


class _AggReadStream(ReadStream):
    """Streaming reader against the io_engine request stream.

    All requests are planned (coalesced, chunked) up front and submitted in
    layout order as the staged-byte budget admits them; ``get`` surfaces each
    request's bytes the moment its extents have landed, so the consumer's
    decode/assemble/H2D overlaps the reads still in flight. The budget counts
    read buffers in flight AND landed-but-unconsumed coalesced-group results,
    so a slow consumer throttles submission instead of ballooning host
    memory. (A chunked large extent's destination array is consumer-owned
    output — the result the ``get`` will hand over — and is not charged, the
    same way the save stream never charges its caller's source arrays.)
    """

    def __init__(self, eng: "AggregatedEngine", ckpt_dir: str,
                 reqs: list[ReadReq], crcs: dict[str, int] | None):
        self.eng = eng
        self.cfg = cfg = eng.config
        self.stats = IOStats()
        self.t0 = trace.clock()
        self.extents: dict[str, Extent] = {}
        for r in reqs:
            if r.key in self.extents:
                raise ValueError(f"duplicate read request key {r.key!r}")
            self.extents[r.key] = Extent(r.key, r.path, r.offset, r.nbytes)
        self.crcs = dict(crcs or {}) if cfg.checksum else {}
        self.budget = StageBudget(cfg.inflight_bytes)
        # clamp staging units to half the budget (same rule as the save
        # stream) so an in-order consumer is never wedged by a single unit
        self._chunk = cfg.chunk_bytes
        thr = cfg.coalesce_bytes
        if cfg.inflight_bytes is not None:
            half = max(cfg.inflight_bytes // 2, 1)
            unit = max(cfg.align, 1 << (half.bit_length() - 1))  # floor pow2
            self._chunk = min(self._chunk, unit)
            thr = min(thr, unit)
        self._units: deque[_ReadUnit] = deque()
        self._unsubmitted: dict[str, int] = {}   # key -> units still queued
        self._dest: dict[str, np.ndarray] = {}   # chunked keys being filled
        self._left: dict[str, int] = {}          # chunked: bytes not landed
        self._crc_state: dict[str, list] = {}    # key -> [crc, pos, {pos: n}]
        self._done: dict[str, np.ndarray] = {}   # landed, awaiting get()
        self._staged_done: dict[str, int] = {}   # done bytes held in budget
        self._consumed: set[str] = set()
        self._handlers: dict[int, tuple] = {}    # token -> (buf, unit)
        self._token = 0
        for group in coalesce(list(self.extents.values()), thr, cfg.align):
            first, last = group[0], group[-1]
            if len(group) == 1 and first.nbytes > self._chunk:
                pos, n_units = 0, 0
                while pos < first.nbytes:
                    n = min(self._chunk, first.nbytes - pos)
                    self._units.append(_ReadUnit(
                        first.path, first.offset + pos,
                        align_up(n, cfg.align), key=first.key, pos=pos, n=n))
                    pos += n
                    n_units += 1
                self._unsubmitted[first.key] = n_units
                self._left[first.key] = first.nbytes
            else:
                span = (last.offset + align_up(last.nbytes, cfg.align)
                        - first.offset)
                self._units.append(
                    _ReadUnit(first.path, first.offset, span, group=group))
                for e in group:
                    self._unsubmitted[e.key] = 1
        self._state = "open"            # open → ended | aborted
        self.io = None
        self.fds = eng._open_files(
            ckpt_dir, {e.path for e in self.extents.values()}, "r")
        try:
            self.stats.files = len(self.fds)
            self.io = eng._make_io()
            self._submit_admitted(None)  # prime: reads overlap caller's work
        except BaseException:
            # begin_restore never returned, so no caller can abort(): free
            # everything here or the fds/backend/buffers leak for good
            self.abort()
            raise

    # ------------------------------------------------------------- plumbing
    def _submit_admitted(self, wait_for: str | None,
                         drain: bool = False) -> None:
        """Submit queued units while the queue depth and budget admit more.

        When the budget is held by landed-but-unconsumed results and no read
        is in flight, an out-of-order consumer (or the ``end_restore`` drain
        of a stream whose keys were never all consumed) would deadlock —
        exceed the budget one unit at a time until ``wait_for``'s units are
        submitted / the queue empties (the documented over-budget escape
        hatch)."""
        while self._units and self.io.inflight < self.cfg.queue_depth:
            unit = self._units[0]
            if not self.budget.admits(
                    BufferPool.size_class(max(unit.span, 1))):
                if self.io.inflight or not (
                        drain or (wait_for is not None
                                  and wait_for not in self._done
                                  and self._unsubmitted.get(wait_for))):
                    break
            self._units.popleft()
            self._submit(unit)

    def _submit(self, unit: _ReadUnit) -> None:
        ta = trace.clock()
        buf = self.eng.pool.get(unit.span)
        self.stats.alloc_seconds += trace.clock() - ta
        self.budget.add(buf.nbytes)
        self._token += 1
        self._handlers[self._token] = (buf, unit)
        self.io.submit([IORequest(OP_READ, self.fds[unit.path], unit.file_off,
                                  buf, 0, unit.span, user_data=self._token)])
        self.stats.io_requests += 1
        if unit.group is not None:
            for e in unit.group:
                self._unsubmitted[e.key] -= 1
        else:
            self._unsubmitted[unit.key] -= 1

    def _pump(self, wait_for: str | None = None, drain: bool = False) -> None:
        self._submit_admitted(wait_for, drain)
        if self.io.inflight:
            cs = self.io.poll(min_n=1)
        else:
            cs = self.io.poll()   # drain engines that complete inline (posix)
        for c in cs:
            self._complete(c)

    def _complete(self, c) -> None:
        buf, unit = self._handlers.pop(c.user_data)
        tb = trace.clock()
        if unit.group is not None:
            first = unit.group[0]
            landed = 0
            for e in unit.group:
                arr = np.empty(e.nbytes, dtype=np.uint8)
                arr[:] = np.frombuffer(
                    buf.view(e.offset - first.offset, e.nbytes), np.uint8)
                self._done[e.key] = arr
                self._staged_done[e.key] = e.nbytes
                landed += e.nbytes
            self.budget.sub(buf.nbytes)
            buf.release()
            self.budget.add(landed)
            self.stats.copy_seconds += trace.clock() - tb
            for e in unit.group:     # verify AFTER the books are settled
                self._verify_whole(e)
        else:
            e = self.extents[unit.key]
            dest = self._dest.get(unit.key)
            if dest is None:
                dest = self._dest[unit.key] = np.empty(e.nbytes, np.uint8)
            dest[unit.pos:unit.pos + unit.n] = np.frombuffer(
                buf.view(0, unit.n), np.uint8)
            self.budget.sub(buf.nbytes)
            buf.release()
            self._left[unit.key] -= unit.n
            if self._left[unit.key] == 0:
                self._done[unit.key] = self._dest.pop(unit.key)
            self.stats.copy_seconds += trace.clock() - tb
            self._advance_crc(e, dest, unit.pos, unit.n)

    # ------------------------------------------------------ CRC verification
    def _verify_whole(self, e: Extent) -> None:
        expect = self.crcs.get(e.key)
        if expect is None:
            return
        got = zlib.crc32(self._done[e.key]) & 0xFFFFFFFF
        if got != expect:
            raise ChecksumError(e.key, e.path, e.offset, expect, got)

    def _advance_crc(self, e: Extent, dest: np.ndarray, pos: int,
                     n: int) -> None:
        """Chunks may land out of order; the CRC rolls forward over the
        contiguous prefix as arrivals extend it."""
        expect = self.crcs.get(e.key)
        if expect is None:
            return
        st = self._crc_state.setdefault(e.key, [0, 0, {}])
        st[2][pos] = n
        while st[1] in st[2]:
            m = st[2].pop(st[1])
            st[0] = zlib.crc32(dest[st[1]:st[1] + m], st[0]) & 0xFFFFFFFF
            st[1] += m
        if st[1] == e.nbytes and st[0] != expect:
            raise ChecksumError(e.key, e.path, e.offset, expect, st[0])

    # ------------------------------------------------------------------ API
    def get(self, key: str) -> np.ndarray:
        if self._state != "open":
            raise RuntimeError(f"get() on a {self._state} read stream")
        if key in self._consumed:
            raise KeyError(f"read request {key!r} already consumed")
        if key not in self.extents:
            raise KeyError(key)
        t0 = trace.clock()
        while key not in self._done:
            self._pump(wait_for=key)
        self.stats.io_seconds += trace.clock() - t0  # blocked-on-read
        arr = self._done.pop(key)
        self._consumed.add(key)
        self.budget.sub(self._staged_done.pop(key, 0))
        return arr

    def end_restore(self) -> IOStats:
        if self._state != "open":
            raise RuntimeError("end_restore() called twice" if
                               self._state == "ended" else
                               "end_restore() after abort()")
        while self._units or self._handlers:
            self._pump(drain=True)
        self._state = "ended"
        self.io.close()
        self.eng._close_files(self.fds)
        self.stats.logical_bytes = sum(
            e.nbytes for e in self.extents.values())
        self.stats.peak_staged_bytes = self.budget.peak
        self.stats.seconds = trace.clock() - self.t0
        self.eng.last_restore_stats = self.stats
        return self.stats

    def abort(self) -> None:
        if self._state != "open":
            return
        self._state = "aborted"
        try:
            try:
                while self.io is not None and self.io.inflight:
                    for c in self.io.poll(min_n=1):
                        buf, _u = self._handlers.pop(c.user_data,
                                                     (None, None))
                        if buf is not None:
                            buf.release()
                if self.io is not None:
                    for c in self.io.poll():
                        buf, _u = self._handlers.pop(c.user_data,
                                                     (None, None))
                        if buf is not None:
                            buf.release()
            # crlint: allow(CRL005): abort() runs under an original error —
            # cleanup here must never mask it; handlers below still released
            except BaseException:
                pass   # inflight state unknown; handlers below still released
            if self.io is not None:
                self.io.close()
        finally:
            self.eng._close_files(self.fds)
            for buf, _u in self._handlers.values():
                buf.release()
            self._handlers.clear()
            self._done.clear()
            self._dest.clear()
            self.budget.settle()


class AggregatedEngine(CREngine):
    name = "aggregated"
    supports_streaming = True
    supports_streaming_read = True

    # ------------------------------------------------------------------ save
    def begin_save(self, ckpt_dir: str, specs: list[SaveSpec], *,
                   step: int = 0, rank: int = 0, num_ranks: int = 1,
                   rank_totals: list[int] | None = None) -> SaveStream:
        return _AggSaveStream(self, ckpt_dir, specs, step, rank, num_ranks,
                              rank_totals)

    def save(self, ckpt_dir: str, items: list[SaveItem], *, step: int = 0,
             rank: int = 0, num_ranks: int = 1,
             rank_totals: list[int] | None = None) -> Manifest:
        stream = self.begin_save(ckpt_dir, [spec_of(it) for it in items],
                                 step=step, rank=rank, num_ranks=num_ranks,
                                 rank_totals=rank_totals)
        try:
            for it in items:
                stream.put(it.key, it.data)
            return stream.end_save()
        except BaseException:
            stream.abort()
            raise

    # ------------------------------------------------------------------ read
    def begin_restore(self, ckpt_dir: str, reqs: list[ReadReq], *,
                      crcs: dict[str, int] | None = None) -> ReadStream:
        return _AggReadStream(self, ckpt_dir, reqs, crcs)

    def read(self, ckpt_dir: str, reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        stream = self.begin_restore(ckpt_dir, reqs)
        try:
            out = {r.key: stream.get(r.key) for r in reqs}
            stream.end_restore()
            return out
        except BaseException:
            stream.abort()
            raise
