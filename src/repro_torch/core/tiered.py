"""Tiered transfer engine — tier-to-tier checkpoint movement through the
io_engine stack (DESIGN.md §8).

Checkpoint bytes traverse storage tiers whose bandwidths differ by orders of
magnitude (HBM → host DRAM → node-local NVMe → PFS). The initial capture is
only half the story: the level-0 → level-1 flush and the level-1 → level-0
restore prefetch move the same bytes again, and a buffered ``shutil`` loop on
that path throws away everything the paper's measurements argue for (batched
kernel-accelerated submission, request coalescing, aligned buffers).

``TieredTransferEngine`` executes those transfers as ``IORequest`` streams:

  · files are split into pipelined extents (``aggregation.chunk_extents``);
    requested ranges are expanded to alignment boundaries and
    interval-merged so every submission is one large aligned I/O,
  · data is staged through pooled ``AlignedBuffer``s, O_DIRECT-capable on
    both sides of the transfer,
  · reads (source tier) and writes (destination tier) run on separate
    ``io_engine`` backends whose ``EngineStats`` attribute bandwidth per tier,
  · stragglers are hedged at *extent* granularity: a late extent gets a
    duplicate request and the first completion wins, so one contended OST
    stalls megabytes, not a whole file. Losing attempts that outlive the
    transfer are handed to a background janitor with their engines, fds,
    and buffers — the caller's latency is bounded by the hedge, not by a
    hung syscall. The janitor drains the stragglers and parks the engine
    pair in a bounded pool for the next transfer, so repeated hedged
    transfers reuse engines instead of growing thread count monotonically.

``RestorePrefetcher`` is the restore-side consumer: it stages a remote
checkpoint's manifest and lean object into a level-0 staging directory, then
pulls exactly the extents the restore plan will read (elastic resharding
reads a subset) ahead of tensor materialization. When the fetched extents
cover the full checkpoint, the staging directory is promoted to a committed
level-0 step so the next restore is local.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass, field

from . import faults, trace
from .aggregation import Extent, chunk_extents
from .buffers import (AlignedBuffer, BufferPool, PAGE, StageBudget, align_up,
                      aligned_span)
from .io_engine import (EngineStats, IOEngine, IORequest, OP_READ, OP_WRITE,
                        make_engine, open_for, resolve_backend)
from .manifest import CHUNK_KIND, MANIFEST_NAME, Manifest


@dataclass
class TransferStats:
    files: int = 0
    bytes: int = 0            # logical bytes moved (once, hedges excluded)
    extents: int = 0          # extent-granular segments issued
    seconds: float = 0.0
    hedged: int = 0           # duplicate extent requests issued
    hedge_wins: int = 0       # duplicates that beat the original
    peak_staged_bytes: int = 0  # max staged bytes in flight (backpressure)
    backend: str = ""
    read_stats: EngineStats = field(default_factory=EngineStats)   # source tier
    write_stats: EngineStats = field(default_factory=EngineStats)  # dest tier

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def per_tier(self) -> dict:
        """Per-tier attribution for benchmark reports."""
        return {"source": self.read_stats.as_dict(),
                "destination": self.write_stats.as_dict()}


class _Segment:
    """One contiguous file region in flight: src fd → staged buffer → dst fd."""

    __slots__ = ("path", "offset", "nbytes", "src_fd", "dst_fd", "state",
                 "buf", "deadline", "primary_read", "primary_write",
                 "writes_out", "hedged_read", "hedged_write", "buf_forgiven")

    def __init__(self, path: str, offset: int, nbytes: int,
                 src_fd: int, dst_fd: int):
        self.path, self.offset, self.nbytes = path, offset, nbytes
        self.src_fd, self.dst_fd = src_fd, dst_fd
        self.state = "queued"          # queued → reading → writing → done
        self.buf: AlignedBuffer | None = None
        self.deadline = 0.0
        self.primary_read = self.primary_write = -1
        self.writes_out = 0
        self.hedged_read = self.hedged_write = False
        self.buf_forgiven = False      # buf bytes already dropped from budget


class TieredTransferEngine:
    """Moves checkpoint bytes between tiers as hedged IORequest streams."""

    def __init__(self, backend: str = "auto", *,
                 chunk_bytes: int = 4 << 20,
                 queue_depth: int = 16,
                 direct: bool = False,
                 hedge_after_s: float = 5.0,
                 min_bw_bytes_s: float = 50e6,
                 fsync: bool = True,
                 align: int = PAGE,
                 pool: BufferPool | None = None,
                 inflight_bytes: int | None = None,
                 engine_factory=None):
        """``inflight_bytes`` caps staged bytes in flight (StageBudget — the
        same backpressure primitive as the streaming save pipeline); None
        leaves staging bounded only by ``queue_depth`` segments."""
        self.backend = resolve_backend(backend)
        self.chunk_bytes = chunk_bytes
        self.queue_depth = queue_depth
        self.inflight_bytes = inflight_bytes
        self.direct = direct
        self.hedge_after_s = hedge_after_s
        self.min_bw_bytes_s = min_bw_bytes_s
        self.fsync = fsync
        self.align = align
        self.pool = pool or BufferPool()
        self._engine_factory = engine_factory   # (role) -> IOEngine, tests
        self._read_io: IOEngine | None = None   # reused across transfers
        self._write_io: IOEngine | None = None
        # drained engine pairs parked by the janitor for reuse: repeated
        # hedged transfers must not grow thread/engine count monotonically
        # crlint: guarded-by(_pool_lock)
        self._engine_pool: list[tuple[IOEngine, IOEngine]] = []
        self._pool_lock = threading.Lock()
        self.engine_pool_limit = 2
        self.engines_built = 0                  # test observability
        # serializes transfers on the shared engine pair (a background
        # flush and a restore prefetch may arrive from different threads)
        self._xfer_lock = threading.Lock()
        self.last_stats = TransferStats()

    # ------------------------------------------------------------------- API
    def transfer(self, pairs: list[tuple[str, str]]) -> TransferStats:
        """Copy whole files ``[(src_abs, dst_abs), ...]`` tier to tier."""
        ranges = []
        for src, dst in pairs:
            size = os.path.getsize(src)
            ranges.append((src, dst, size, [(0, size)]))
        return self._execute(ranges, files=len(pairs))

    def fetch_ranges(self, src_dir: str, dst_dir: str,
                     extents: list[Extent]) -> TransferStats:
        """Pull byte ranges of files under ``src_dir`` into same-named files
        under ``dst_dir`` (sized like the source, sparse elsewhere)."""
        by_path: dict[str, list[tuple[int, int]]] = {}
        for e in extents:
            by_path.setdefault(e.path, []).append((e.offset, e.nbytes))
        ranges = []
        for path, spans in by_path.items():
            src = os.path.join(src_dir, path)
            size = os.path.getsize(src)
            aligned = []
            for off, n in spans:
                start, span = aligned_span(off, n, self.align)
                aligned.append((start, min(start + span, size)))
            ranges.append((src, os.path.join(dst_dir, path), size,
                           _merge_intervals(aligned)))
        return self._execute(ranges, files=len(ranges))

    def close(self) -> None:
        self._discard_engines()
        with self._pool_lock:
            pairs, self._engine_pool = self._engine_pool[:], []
        for r, w in pairs:
            r.close()
            w.close()
        self.pool.drain()

    # ------------------------------------------------------------- execution
    def _make_engine(self, role: str) -> IOEngine:
        if self._engine_factory is not None:
            return self._engine_factory(role)
        kw = {}
        if self.backend == "threadpool":
            kw = {"workers": min(self.queue_depth, 16)}
        return make_engine(self.backend, **kw)

    def _engines(self) -> tuple[IOEngine, IOEngine]:
        """Lazily build the read/write pair once; transfers are serialized
        (flush waits on flush, restore on flush), so reuse is safe. A pair
        the janitor drained after a hedged transfer is reused before a new
        one is built."""
        if self._read_io is None:
            with self._pool_lock:
                pair = (self._engine_pool.pop() if self._engine_pool
                        else None)
            if pair is not None:
                self._read_io, self._write_io = pair
            else:
                self._read_io = self._make_engine("read")
                self._write_io = self._make_engine("write")
                self._write_io.tier = "level1"   # spans land on the L1 track
                self.engines_built += 2
                # hedged attempts must tolerate one attempt failing while
                # its sibling succeeds — errors arrive as Completion.error
                self._read_io.capture_errors = True
                self._write_io.capture_errors = True
        return self._read_io, self._write_io

    def _discard_engines(self) -> None:
        for e in (self._read_io, self._write_io):
            if e is not None:
                e.close()
        self._read_io = self._write_io = None

    def _park_engines(self, read_io: IOEngine, write_io: IOEngine) -> None:
        """Return a drained pair to the bounded pool (close when full)."""
        with self._pool_lock:
            if len(self._engine_pool) < self.engine_pool_limit:
                self._engine_pool.append((read_io, write_io))
                return
        read_io.close()
        write_io.close()

    def _execute(self, ranges, files: int) -> TransferStats:
        """ranges: [(src_abs, dst_abs, file_size, [(start, end), ...])]"""
        with self._xfer_lock:
            return self._execute_locked(ranges, files)

    def _execute_locked(self, ranges, files: int) -> TransferStats:
        total = sum(end - start for _s, _d, _sz, iv in ranges
                    for start, end in iv)
        with trace.span("tier.transfer", tier="level1", nbytes=total,
                        attrs={"files": files}):
            return self._execute_traced(ranges, files)

    def _execute_traced(self, ranges, files: int) -> TransferStats:
        stats = TransferStats(backend=self.backend, files=files)
        t0 = trace.clock()
        segments: list[_Segment] = []
        src_fds: list[int] = []
        dst_fds: list[int] = []
        read_io, write_io = self._engines()
        read_io.stats = EngineStats()    # per-call tier attribution
        write_io.stats = EngineStats()
        ok = False
        orphans = None
        try:
            for src, dst, size, intervals in ranges:
                # O_DIRECT only for alignment-sized files (data files are
                # fallocated to aligned sizes; manifest.json is not)
                direct = self.direct and size % self.align == 0
                sfd = open_for(src, "r", direct=direct)
                dfd = open_for(dst, "rw", direct=direct)
                src_fds.append(sfd)
                dst_fds.append(dfd)
                try:
                    faults.posix_fallocate(dfd, 0, size)
                # modeled fallback for filesystems without fallocate — an
                # injected ENOSPC here degrades to ftruncate by design
                # crlint: allow(CRL005): fallocate fallback is the contract
                except OSError:
                    os.ftruncate(dfd, size)
                for start, end in intervals:
                    for seg in self._plan_segments(src, start, end, sfd, dfd):
                        segments.append(seg)
            orphans = self._run(segments, read_io, write_io, stats)
            if self.fsync:
                for fd in dst_fds:
                    write_io.fsync(fd)
            ok = True
        finally:
            keep = orphans[1] if (ok and orphans) else ()
            if not ok:   # inflight state unknown after an error: rebuild
                self._discard_engines()   # waits out any hung attempt
            for fd in src_fds + dst_fds:
                if fd not in keep:
                    os.close(fd)
        if orphans:
            # losing hedge attempts outlive this call: hand their engines,
            # buffers, and fds to a janitor so the caller isn't tail-bound
            # by a hung syscall (the hedge already won)
            self._spawn_janitor(read_io, write_io, *orphans)
        stats.read_stats = read_io.stats
        stats.write_stats = write_io.stats
        stats.seconds = trace.clock() - t0
        self.last_stats = stats
        return stats

    def _spawn_janitor(self, read_io: IOEngine, write_io: IOEngine,
                       bufs, fds) -> None:
        # detach the pair so the next transfer starts immediately; the
        # janitor drains the stragglers and parks the pair for reuse
        self._read_io = self._write_io = None

        def drain(io: IOEngine, deadline: float) -> bool:
            while io.inflight and trace.clock() < deadline:
                try:
                    io.poll(min_n=1, timeout_s=0.1)
                # crlint: allow(CRL005): draining losing hedge attempts —
                # the winner already committed; a loser's error is expected
                except BaseException:
                    pass           # loser failed after its hedge won
            return not io.inflight

        def janitor():
            deadline = trace.clock() + 60.0
            ok = drain(read_io, deadline) and drain(write_io, deadline)
            if ok:
                # no attempt references the buffers or fds anymore: release
                # buffers back to the shared pool and park the engine pair
                for fd in fds:
                    os.close(fd)
                for b in bufs:
                    b.release()
                self._park_engines(read_io, write_io)
                return
            # a syscall is still hung past the deadline: fall back to the
            # discard path — reusing its buffer or engine would hand a live
            # kernel write target to the next transfer
            try:
                read_io.close()
                write_io.close()
            # crlint: allow(CRL005): closing a wedged engine past the drain
            # deadline — nothing observes the janitor thread's errors
            except BaseException:
                pass
            for b in bufs:
                b.destroy()
            for fd in fds:
                os.close(fd)

        threading.Thread(target=janitor, daemon=True,
                         name="tiered-janitor").start()

    def _plan_segments(self, path: str, start: int, end: int,
                       src_fd: int, dst_fd: int):
        """One pipelined, individually-hedgeable segment per aligned chunk
        of the interval (small ranges were already interval-merged)."""
        for e in chunk_extents(path, end - start, self.chunk_bytes,
                               self.align, start=start):
            yield _Segment(path, e.offset, e.nbytes, src_fd, dst_fd)

    def _stage_deadline(self, nbytes: int) -> float:
        return trace.clock() + max(self.hedge_after_s,
                                         nbytes / self.min_bw_bytes_s)

    def _run(self, segments: list[_Segment], read_io: IOEngine,
             write_io: IOEngine, stats: TransferStats
             ) -> tuple[list, set] | None:
        """Drive all segments to done; returns straggling losing attempts'
        (buffers, fds) when a hedge won but its original is still in
        flight, else None."""
        pending = deque(segments)
        active: set[_Segment] = set()
        reads: dict[int, tuple[_Segment, AlignedBuffer]] = {}
        writes: dict[int, _Segment] = {}
        token = 0
        budget = StageBudget(self.inflight_bytes)
        forgiven_reads: set[int] = set()

        def release(buf: AlignedBuffer):
            budget.sub(buf.nbytes)
            buf.release()

        def release_read(tok: int, buf: AlignedBuffer):
            if tok in forgiven_reads:   # bytes already dropped at hedge win
                forgiven_reads.discard(tok)
                buf.release()
            else:
                release(buf)

        def forgive_stragglers(seg: _Segment, winner_tok: int):
            """A hedge attempt won this segment's read: the losing attempt's
            buffer is a straggler — drop its bytes from the budget NOW so
            backpressure never re-serializes issuance behind the very
            straggler the hedge just masked."""
            for tok, (s, b) in reads.items():
                if s is seg and tok != winner_tok and tok not in forgiven_reads:
                    budget.sub(b.nbytes)
                    forgiven_reads.add(tok)

        def release_seg_buf(seg: _Segment):
            if seg.buf_forgiven:
                seg.buf.release()
            else:
                release(seg.buf)

        def issue_read(seg: _Segment, hedge: bool = False):
            nonlocal token
            token += 1
            # staged buffers are deliberately NOT pool-released on error — a
            # hung async attempt may still target them; _execute_locked
            # discards the engines (waiting out inflight attempts) and the
            # buffers die with GC via AlignedBuffer.destroy
            # crlint: allow(CRL004): buffers intentionally die with engines
            buf = self.pool.get(align_up(seg.nbytes, self.align))
            budget.add(buf.nbytes)
            reads[token] = (seg, buf)
            if not hedge:
                seg.primary_read = token
                seg.state = "reading"
                seg.deadline = self._stage_deadline(seg.nbytes)
            read_io.submit([IORequest(OP_READ, seg.src_fd, seg.offset, buf,
                                      0, seg.nbytes, user_data=token)])

        def issue_write(seg: _Segment, hedge: bool = False):
            nonlocal token
            token += 1
            writes[token] = seg
            seg.writes_out += 1
            if not hedge:
                seg.primary_write = token
                seg.state = "writing"
                seg.deadline = self._stage_deadline(seg.nbytes)
            write_io.submit([IORequest(OP_WRITE, seg.dst_fd, seg.offset,
                                       seg.buf, 0, seg.nbytes,
                                       user_data=token)])

        def on_read(c):
            seg, buf = reads.pop(c.user_data)
            if c.error is not None:
                release_read(c.user_data, buf)
                if seg.state != "reading":
                    return                 # loser failed after the win
                if any(s is seg for s, _b in reads.values()):
                    return                 # sibling attempt still racing
                raise c.error              # ALL read attempts failed
            if seg.state != "reading":     # losing hedge attempt: discard
                release_read(c.user_data, buf)
                return
            if c.user_data != seg.primary_read:
                stats.hedge_wins += 1
                trace.event("hedge.win", tier="level1", nbytes=seg.nbytes,
                            attrs={"op": "read"})
            elif seg.hedged_read:
                trace.event("hedge.lose", tier="level1",
                            attrs={"op": "read"})
            forgive_stragglers(seg, c.user_data)
            seg.buf = buf
            issue_write(seg)

        def on_write(c):
            seg = writes.pop(c.user_data)
            seg.writes_out -= 1
            if c.error is not None:
                if seg.state != "writing":
                    if seg.state == "done" and seg.writes_out == 0:
                        release_seg_buf(seg)
                    return                 # loser failed after the win
                if any(s is seg for s in writes.values()):
                    return                 # sibling attempt still racing
                raise c.error              # ALL write attempts failed
            if seg.state == "writing":     # first completion wins
                if c.user_data != seg.primary_write:
                    stats.hedge_wins += 1
                    trace.event("hedge.win", tier="level1",
                                nbytes=seg.nbytes, attrs={"op": "write"})
                elif seg.hedged_write:
                    trace.event("hedge.lose", tier="level1",
                                attrs={"op": "write"})
                seg.state = "done"
                stats.bytes += seg.nbytes
                active.discard(seg)
                if seg.writes_out > 0 and not seg.buf_forgiven:
                    # a losing write still references buf: straggler — stop
                    # counting it against issuance (mirrors forgive_stragglers)
                    budget.sub(seg.buf.nbytes)
                    seg.buf_forgiven = True
            if seg.state == "done" and seg.writes_out == 0:
                release_seg_buf(seg)       # safe: no attempt references it

        def maybe_hedge():
            now = trace.clock()
            for seg in active:
                if now < seg.deadline:
                    continue
                if seg.state == "reading" and not seg.hedged_read:
                    seg.hedged_read = True
                    stats.hedged += 1
                    trace.event("hedge.issue", tier="level1",
                                nbytes=seg.nbytes, attrs={"op": "read"})
                    issue_read(seg, hedge=True)
                elif seg.state == "writing" and not seg.hedged_write:
                    seg.hedged_write = True
                    stats.hedged += 1
                    trace.event("hedge.issue", tier="level1",
                                nbytes=seg.nbytes, attrs={"op": "write"})
                    issue_write(seg, hedge=True)

        def next_deadline() -> float:
            now = trace.clock()
            cands = [seg.deadline - now for seg in active
                     if not (seg.hedged_read if seg.state == "reading"
                             else seg.hedged_write)]
            return max(0.001, min(cands)) if cands else 0.05

        # Exit when every segment is done — NOT when every attempt has
        # completed: leftover attempts are losing hedges whose segments
        # already committed, and waiting on them would re-introduce the
        # exact tail the hedge was issued against.
        while pending or active:
            while pending and len(active) < self.queue_depth:
                # staged-byte backpressure: defer issuance (never block the
                # completion loop) until writes land and release buffers
                need = BufferPool.size_class(
                    align_up(max(pending[0].nbytes, 1), self.align))
                if not budget.admits(need):
                    break
                seg = pending.popleft()
                active.add(seg)
                stats.extents += 1
                issue_read(seg)
            rcs = read_io.poll() if reads else []
            wcs = write_io.poll() if writes else []
            if not rcs and not wcs and (reads or writes):
                timeout = min(next_deadline(), 0.05)
                if read_io.inflight:
                    rcs = read_io.poll(min_n=1, timeout_s=timeout)
                elif write_io.inflight:
                    wcs = write_io.poll(min_n=1, timeout_s=timeout)
            for c in rcs:
                on_read(c)
            for c in wcs:
                on_write(c)
            maybe_hedge()

        stats.peak_staged_bytes = budget.peak
        if not reads and not writes:
            return None
        # straggling losers: their buffers (private read buffers + the
        # shared seg.buf a losing write still reads from) and fds must
        # outlive this call; the janitor reaps them
        bufs = [buf for _seg, buf in reads.values()]
        bufs += list({id(s.buf): s.buf for s in writes.values()}.values())
        fds = ({s.src_fd for s, _b in reads.values()}
               | {s.dst_fd for s in writes.values()})
        return bufs, fds


class _IntervalSet:
    """Merged logical byte intervals, for prefetch coverage accounting."""

    def __init__(self):
        self._ivs: list[tuple[int, int]] = []

    def add(self, start: int, end: int) -> None:
        if end > start:
            self._ivs = _merge_intervals(self._ivs + [(start, end)])

    def covers(self, start: int, end: int) -> bool:
        if end <= start:
            return True
        for lo, hi in self._ivs:
            if lo <= start and end <= hi:
                return True
        return False


def _merge_intervals(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(ivs):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


class RestorePrefetcher:
    """Stages a level-1 checkpoint's hot extents at level 0 ahead of restore.

    Wired into ``CheckpointManager.restore``: ``begin`` stages the manifest
    and lean-object extents (enough to plan the read set), ``fetch_extents``
    pulls the planned tensor extents, ``finish`` promotes the staging
    directory to a committed level-0 step when the fetched extents cover the
    whole checkpoint (a resharded restore that reads a subset stays staged
    and is garbage-collected instead).

    The staged level-0 copy feeds the same streaming ReadStream as a local
    restore (the RestorePipeline's ``on_reqs`` hook fires ``fetch_extents``
    with exactly the planned reads before the stream opens), so a level-1
    resume gets the identical overlap of decode/assembly/H2D against the
    local reads; ``last_fetch_stats`` attributes the tier-1 pull separately
    (``RestoreMetrics.prefetch_seconds`` records its wall time).
    """

    STAGING_SUFFIX = ".tmp-prefetch"

    def __init__(self, remote_dir: str,
                 transfer: TieredTransferEngine | None = None):
        self.remote_dir = os.path.abspath(remote_dir)
        self._owns_transfer = transfer is None
        self.transfer = transfer or TieredTransferEngine()
        self._active: dict[str, dict] = {}   # staged dir -> state
        self.last_fetch_stats: TransferStats | None = None

    def begin(self, step: int, local_dir: str) -> str | None:
        """Stage manifest + blob extents for ``step``; returns the staging
        dir, or None when the step is not committed at the remote tier."""
        from .checkpoint import step_dir_name
        src = os.path.join(self.remote_dir, step_dir_name(step))
        if not Manifest.exists(src):
            return None
        manifest = Manifest.load(src)
        staged = os.path.join(local_dir,
                              step_dir_name(step) + self.STAGING_SUFFIX)
        faults.rmtree(staged, ignore_errors=True)
        os.makedirs(staged)
        try:
            self.transfer.transfer([(os.path.join(src, MANIFEST_NAME),
                                     os.path.join(staged, MANIFEST_NAME))])
            fetched: dict[str, _IntervalSet] = {}
            blob_extents = [Extent(k, b.path, b.offset, b.nbytes)
                            for k, b in manifest.blobs.items()]
            if blob_extents:
                self.transfer.fetch_ranges(src, staged, blob_extents)
                for e in blob_extents:
                    fetched.setdefault(e.path, _IntervalSet()).add(
                        e.offset, e.offset + e.nbytes)
        except BaseException:   # failed mid-stage: don't leak the dir
            faults.rmtree(staged, ignore_errors=True)
            raise
        self._active[staged] = {"src": src, "manifest": manifest,
                                "fetched": fetched}
        return staged

    def fetch_extents(self, staged: str, reqs) -> TransferStats | None:
        """Pull planned read extents (objects with .path/.offset/.nbytes)
        not already staged."""
        state = self._active.get(staged)
        if state is None:
            return None
        todo = []
        for r in reqs:
            ivs = state["fetched"].setdefault(r.path, _IntervalSet())
            if not ivs.covers(r.offset, r.offset + r.nbytes):
                todo.append(Extent(getattr(r, "key", r.path), r.path,
                                   r.offset, r.nbytes))
        if not todo:
            return None
        stats = self.transfer.fetch_ranges(state["src"], staged, todo)
        for e in todo:
            state["fetched"][e.path].add(e.offset, e.offset + e.nbytes)
        self.last_fetch_stats = stats
        return stats

    def finish(self, staged: str, final: str) -> bool:
        """Promote the staging dir to a committed level-0 step iff the
        fetched extents cover every extent in the manifest."""
        state = self._active.pop(staged, None)
        if state is None:
            return False
        manifest: Manifest = state["manifest"]
        fetched = state["fetched"]

        def covered(path, off, n):
            ivs = fetched.get(path)
            return ivs is not None and ivs.covers(off, off + n)

        def extents(rec):
            """Real on-disk extents of a record: chunk-reference shards
            (delta, §12) resolve to their chunk extents — the synthetic
            entry path names nothing fetchable."""
            for sh in rec.shards:
                if sh.kind == CHUNK_KIND:
                    yield from (sh.chunks or ())
                else:
                    yield sh

        complete = all(
            covered(x.path, x.offset, x.nbytes)
            for rec in manifest.tensors.values() for x in extents(rec)
        ) and all(covered(b.path, b.offset, b.nbytes)
                  for b in manifest.blobs.values())
        if not complete:
            faults.rmtree(staged, ignore_errors=True)
            return False
        # displaced-aside publish (checkpoint.replace_dir): promoting over an
        # existing local step must never open a window where a crash leaves
        # NEITHER the old nor the new copy — the naive rmtree-then-rename
        # promote did exactly that
        from .checkpoint import replace_dir
        replace_dir(staged, final)
        return True

    def discard(self, staged: str) -> None:
        """Abandon an in-flight prefetch (restore failed mid-way)."""
        self._active.pop(staged, None)
        faults.rmtree(staged, ignore_errors=True)

    def close(self) -> None:
        for staged in list(self._active):
            self.discard(staged)
        if self._owns_transfer:   # injected engines belong to their owner
            self.transfer.close()
