"""Object-store level-2 tier — parallel hedged range I/O over ranged
GET/PUT (DESIGN.md §15).

The tier stack so far stops at local disk (level 1); production checkpoints
live in object stores behind high-latency ranged HTTP, where the paper's
tiering argument bites hardest: first-byte latency is milliseconds, not
microseconds, and per-request throughput is far below what the store serves
in aggregate. The remedies are the same ones the aggregation study
motivated locally, shifted up a level:

  · objects are read as *aligned ranges* sized like transfer extents
    (``RemoteConfig.range_bytes``), with a configurable window of ranges in
    flight under the shared ``StageBudget`` backpressure primitive,
  · a late range is *hedged*: past ``max(hedge_after_s, nbytes/min_bw)``
    a duplicate request is issued and the first completion wins —
    ``tiered.py``'s extent hedging generalized to per-request hedges, which
    is how serving stacks mask object-store stall tails (gcsfuse's
    read-stall-retry),
  · partial-range responses re-request the remainder; transient 5xx
    responses retry with backoff,
  · uploads are chunkstore-aware: the level-1→2 flush consults the delta
    manifest and HEADs each content-addressed chunk object, shipping only
    chunks the store does not already hold — a 1%-dirty step moves ~1% of
    the bytes over the wire,
  · the manifest object is PUT **last**; its existence is the remote commit
    point, so a crashed upload never publishes a step that references
    un-uploaded chunks (the same manifest-last protocol as levels 0/1).

``SimObjectStore`` is an in-process simulator (configurable latency /
bandwidth / stall / error / partial-response distributions plus the
``faults`` remote shims) so benchmarks and the chaos campaign run
hermetically; a real HTTP/S3 client only needs the four-method
``ObjectStore`` surface.

Restore has two shapes: ``RemotePrefetcher`` stages ranges at level 0 and
promotes on full coverage (inheriting ``RestorePrefetcher``'s coverage
accounting and promotion protocol), while ``engines.remote.RemoteReadEngine``
streams remote ranges straight into the ``RestorePipeline`` — read →
dequantize → assemble → H2D with no local copy of the checkpoint at all.

This is the PyTorch package's copy of ``repro.core.remote``; it differs in
one place: the stream restore's metadata manager restores onto the local
manager's ``device``.
"""

from __future__ import annotations

import os
import posixpath
import random
import re
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from queue import Empty, SimpleQueue

from . import delta as delta_mod
from . import faults, trace
from .aggregation import Extent
from .buffers import PAGE, StageBudget, aligned_span
from .manifest import MANIFEST_NAME, Manifest
from .tiered import RestorePrefetcher, _IntervalSet, _merge_intervals


class RemoteError(OSError):
    """Object-store request failed (HTTP-style status carried along)."""

    def __init__(self, status: int, key: str, what: str):
        super().__init__(f"remote {what} ({key!r}): HTTP {status}")
        self.status = status
        self.key = key


class RemoteTransientError(RemoteError):
    """Retryable failure (5xx / connection reset): retried with backoff."""


def join_key(*parts: str) -> str:
    """Join object-key components and collapse ``..`` segments — manifests
    reference the shared chunkstore as ``../chunkstore/<pack>`` relative to
    the step dir, which under a step key normalizes to the tier-wide
    ``<prefix>/chunkstore/<pack>`` object."""
    key = posixpath.normpath(posixpath.join(*[p for p in parts if p]))
    return "" if key == "." else key


@dataclass
class ObjectMeta:
    key: str
    size: int


class ObjectStore:
    """Minimal ranged-GET/PUT object-store surface (S3/GCS-shaped).

    ``put`` is atomic: the object is either fully visible at its final key
    or absent — there is no partially-visible PUT (multipart uploads only
    publish on complete). Everything above relies on that for the
    manifest-last commit protocol.
    """

    def put(self, key: str, data) -> ObjectMeta:
        raise NotImplementedError

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        """May return fewer bytes than asked (a partial-range response);
        callers re-request the remainder."""
        raise NotImplementedError

    def head(self, key: str) -> ObjectMeta | None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def get(self, key: str, *, max_retries: int = 3) -> bytes:
        """Whole-object GET: loops partial responses, retries transient
        errors (small objects only — manifests; data goes through the
        range scheduler)."""
        meta = self.head(key)
        if meta is None:
            raise RemoteError(404, key, "GET")
        out = bytearray(meta.size)
        got = 0
        errors = 0
        while got < meta.size:
            try:
                data = self.get_range(key, got, meta.size - got)
            except RemoteTransientError:
                errors += 1
                if errors > max_retries:
                    raise
                time.sleep(0.005 * errors)
                continue
            if not data:
                raise RemoteError(416, key, f"empty range at +{got}")
            out[got:got + len(data)] = data
            got += len(data)
        return bytes(out)


@dataclass
class SimProfile:
    """Pathology knobs for the in-process store (all off by default).

    ``stall_prob``/``stall_s`` model the object-store tail the hedging is
    aimed at: a stalled request sleeps ``stall_s`` before serving — a
    hedged duplicate re-rolls the dice and typically wins."""
    latency_s: float = 0.0            # per-request first-byte latency
    jitter_s: float = 0.0             # uniform extra latency
    bandwidth_bytes_s: float = 0.0    # per-request streaming cap (0 = off)
    stall_prob: float = 0.0
    stall_s: float = 0.5
    error_prob: float = 0.0           # transient 5xx
    partial_prob: float = 0.0         # ranged GET returns a prefix
    seed: int = 0


class SimObjectStore(ObjectStore):
    """Local filesystem-backed object store with simulated remoteness.

    Objects are files under ``root``; PUT stages to a tmp file and renames,
    so visibility is atomic like a real store. The ``faults`` remote shims
    (``rget``/``rput``) are consulted on every request, which is how the
    chaos campaign injects crashes, errnos, stalls, and short ranges
    deterministically on top of the probabilistic profile."""

    def __init__(self, root: str, profile: SimProfile | None = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.profile = profile or SimProfile()
        self._lock = threading.Lock()
        # crlint: guarded-by(_lock)
        self._rng = random.Random(self.profile.seed)
        # crlint: guarded-by(_lock)
        self.gets = 0
        # crlint: guarded-by(_lock)
        self.puts = 0
        # crlint: guarded-by(_lock)
        self.heads = 0
        # crlint: guarded-by(_lock)
        self.bytes_in = 0     # over-the-wire upload payload
        # crlint: guarded-by(_lock)
        self.bytes_out = 0    # over-the-wire download payload

    def backing_path(self, key: str) -> str:
        """Filesystem path of an object — exposed so chaos corruptors can
        damage remote objects in place."""
        norm = posixpath.normpath(key)
        if posixpath.isabs(norm) or norm.startswith(".."):
            raise ValueError(f"key escapes store root: {key!r}")
        return os.path.join(self.root, *norm.split("/"))

    def _weather(self, key: str, what: str, nbytes: int) -> bool:
        """Apply the profile to one request; returns the partial flag."""
        p = self.profile
        with self._lock:
            stall = self._rng.random() < p.stall_prob
            err = self._rng.random() < p.error_prob
            partial = self._rng.random() < p.partial_prob
            jitter = self._rng.uniform(0.0, p.jitter_s) if p.jitter_s else 0.0
        delay = p.latency_s + jitter + (p.stall_s if stall else 0.0)
        if p.bandwidth_bytes_s:
            delay += nbytes / p.bandwidth_bytes_s
        if delay > 0.0:
            time.sleep(delay)
        if err:
            raise RemoteTransientError(503, key, what)
        return partial

    def put(self, key: str, data) -> ObjectMeta:
        mv = memoryview(data).cast("B")
        f = faults.remote_op(faults.OP_RPUT, key)   # crash/errno raise here
        self._weather(key, "PUT", mv.nbytes)
        path = self.backing_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-put-{os.getpid()}-{threading.get_ident()}"
        if f is not None and f.action == faults.A_STALL:
            time.sleep(f.delay_s)
        if f is not None and f.action == faults.A_TORN:
            # aborted multipart upload: a prefix reached the store's staging
            # area but the object is never published at its key
            keep = min(max(int(mv.nbytes * f.frac), 0), max(mv.nbytes - 1, 0))
            with open(tmp, "wb") as fh:
                fh.write(mv[:keep])
            raise faults.InjectedCrash(
                f"torn PUT: {keep} of {mv.nbytes} bytes staged, "
                f"object {key!r} never published")
        with open(tmp, "wb") as fh:
            fh.write(mv)
            fh.flush()
            # simulated store INTERNALS — the store plays the remote side of
            # the wire, so faults inject at the protocol boundary (OP_RPUT
            # above), not at its backing files
            # crlint: allow(CRL001): simulated remote internals
            os.fsync(fh.fileno())
        # crlint: allow(CRL001): see fsync above — same simulated-internals
        os.replace(tmp, path)
        with self._lock:
            self.puts += 1
            self.bytes_in += mv.nbytes
        return ObjectMeta(key, mv.nbytes)

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        f = faults.remote_op(faults.OP_RGET, key)   # crash/errno raise here
        self._weather(key, "GET", nbytes)
        if f is not None and f.action == faults.A_STALL:
            time.sleep(f.delay_s)
        try:
            with open(self.backing_path(key), "rb") as fh:
                fh.seek(offset)
                data = fh.read(nbytes)
        except FileNotFoundError:
            raise RemoteError(404, key, "GET") from None
        if f is not None and f.action in (faults.A_SHORT, faults.A_TORN):
            data = data[:min(max(int(len(data) * f.frac), 1), len(data))]
        elif len(data) > 1:
            with self._lock:
                partial = self._rng.random() < self.profile.partial_prob
                keep = (self._rng.randrange(1, len(data))
                        if partial else len(data))
            data = data[:keep]
        with self._lock:
            self.gets += 1
            self.bytes_out += len(data)
        return data

    def head(self, key: str) -> ObjectMeta | None:
        with self._lock:
            self.heads += 1
        if self.profile.latency_s:
            time.sleep(self.profile.latency_s)
        try:
            return ObjectMeta(key, os.path.getsize(self.backing_path(key)))
        except OSError:
            return None

    def list_prefix(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if ".tmp-put-" in name:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self.backing_path(key))
        except FileNotFoundError:
            pass


# --------------------------------------------------------- range scheduling
@dataclass
class RemoteConfig:
    """Remote-tier tuning (DESIGN.md §15 for how each knob was sized)."""
    range_bytes: int = 4 << 20       # aligned range size (aggregation sweet spot)
    window: int = 8                  # ranges in flight per transfer
    hedge_after_s: float = 5.0       # stall detector floor
    min_bw_bytes_s: float = 50e6     # deadline slope: nbytes / min_bw
    max_hedges: int = 2              # duplicate attempts per range: bounds the
                                     # tail at ~(1+max_hedges) * hedge_after_s
                                     # even when a hedge itself stalls
    max_retries: int = 3             # transient 5xx retries per attempt
    retry_backoff_s: float = 0.01
    inflight_bytes: int | None = 256 << 20   # StageBudget cap on staged bytes
    align: int = PAGE
    put_workers: int = 4             # parallel uploads per step


@dataclass
class RangeStats:
    objects: int = 0
    ranges: int = 0            # range requests planned (hedges excluded)
    bytes: int = 0             # logical bytes delivered (once)
    seconds: float = 0.0
    hedged: int = 0            # duplicate range requests issued
    hedge_wins: int = 0        # duplicates that beat the original
    retries: int = 0           # partial-range re-requests + 5xx retries
    peak_staged_bytes: int = 0
    # time-to-first-completion per range (issue -> winning attempt): the
    # distribution the hedging policy is judged on — its tail must be
    # bounded by the hedge threshold, not by the store's stalls
    range_seconds: list = field(default_factory=list)

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def range_percentile(self, p: float) -> float:
        if not self.range_seconds:
            return 0.0
        s = sorted(self.range_seconds)
        return s[min(len(s) - 1, int(round(p * (len(s) - 1))))]


class _Range:
    """One ranged GET in flight (possibly hedged)."""

    __slots__ = ("rid", "key", "offset", "nbytes", "obj", "deadline",
                 "attempts", "outstanding", "demanded", "done",
                 "issued_at")

    def __init__(self, rid: int, key: str, offset: int, nbytes: int,
                 obj=None):
        self.rid, self.key, self.offset, self.nbytes = rid, key, offset, nbytes
        self.obj = obj                 # consumer tag (req key / dst fd)
        self.deadline = 0.0
        self.attempts = 0
        self.outstanding = 0
        self.demanded = False
        self.done = False
        self.issued_at = 0.0


def _split(start: int, end: int, range_bytes: int):
    """Split [start, end) on absolute range_bytes boundaries, so hedged
    re-issues and cache keys line up across callers reading overlapping
    spans of the same object."""
    off = start
    while off < end:
        nxt = min(((off // range_bytes) + 1) * range_bytes, end)
        yield off, nxt - off
        off = nxt


def _req_ranges(reqs, prefix: str, range_bytes: int) -> list[_Range]:
    """Plan ranges for engine ReadReqs: obj = (req key, offset within req)."""
    tasks = []
    for rq in reqs:
        key = join_key(prefix, rq.path)
        for off, n in _split(rq.offset, rq.offset + rq.nbytes, range_bytes):
            tasks.append(_Range(len(tasks), key, off, n,
                                obj=(rq.key, off - rq.offset)))
    return tasks


class RangeScheduler:
    """Windowed parallel ranged reads with stall-detection + hedged re-issue.

    The driving loop mirrors ``TieredTransferEngine._run`` one tier up:
    issue up to ``window`` ranges under the staged-byte budget, wait for
    completions, and past a per-range deadline issue a duplicate request
    (re-hedged after a fresh grace period if it stalls too, up to
    ``max_hedges``) — first completion wins, losers' results are discarded
    when they land (never waited on). Attempt workers run on a bounded
    executor; a hung request occupies a worker slot, not the caller's
    latency.

    ``run`` is the only entry point and is single-threaded per call (the
    budget is consulted only from the loop); concurrent ``run`` calls on
    one scheduler serialize on an internal lock.
    """

    def __init__(self, store: ObjectStore, cfg: RemoteConfig | None = None):
        self.store = store
        self.cfg = cfg or RemoteConfig()
        self._pool = ThreadPoolExecutor(
            max_workers=min(2 * self.cfg.window + 2, 64),
            thread_name_prefix="rget")
        self._run_lock = threading.Lock()

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------- attempts
    def _fetch(self, r: _Range) -> tuple[bytes, int]:
        """One full-range attempt: loops partial-range responses (each one
        makes progress, so this terminates), retries transient errors."""
        out = bytearray(r.nbytes)
        got = 0
        retries = 0
        errors = 0
        while got < r.nbytes:
            try:
                data = self.store.get_range(r.key, r.offset + got,
                                            r.nbytes - got)
            except RemoteTransientError:
                errors += 1
                retries += 1
                trace.event("range.retry", tier="remote",
                            attrs={"key": r.key, "errors": errors})
                if errors > self.cfg.max_retries:
                    raise
                time.sleep(self.cfg.retry_backoff_s * errors)
                continue
            if not data:
                raise RemoteError(416, r.key, f"empty range at +{got}")
            out[got:got + len(data)] = data
            got += len(data)
            if got < r.nbytes:
                retries += 1      # partial response: re-request the rest
        return bytes(out), retries

    def _worker(self, r: _Range, idx: int, q: SimpleQueue) -> None:
        try:
            data, retries = self._fetch(r)
            q.put((r.rid, idx, data, None, retries))
        except BaseException as e:
            q.put((r.rid, idx, None, e, 0))

    def _issue(self, r: _Range, q: SimpleQueue, hedge: bool) -> None:
        if not hedge:
            r.issued_at = trace.clock()
            r.deadline = r.issued_at + max(
                self.cfg.hedge_after_s, r.nbytes / self.cfg.min_bw_bytes_s)
            trace.event("range.issue", tier="remote", nbytes=r.nbytes,
                        attrs={"key": r.key})
        else:
            trace.event("range.hedge", tier="remote", nbytes=r.nbytes,
                        attrs={"key": r.key, "attempt": r.attempts})
        idx = r.attempts
        r.attempts += 1
        r.outstanding += 1
        self._pool.submit(self._worker, r, idx, q)

    # ----------------------------------------------------------------- loop
    def run(self, tasks: list[_Range], deliver, *,
            budget: StageBudget | None = None, demand=None, reclaim=None,
            cancel: threading.Event | None = None) -> RangeStats:
        """Drive every range to completion; ``deliver(range, data)`` runs in
        this loop as winners land and returns True to keep the bytes on the
        staged-byte books (the consumer credits them back via ``reclaim``)
        or False to release them immediately. ``demand()`` names range ids
        a blocked consumer needs now: they jump the issue queue and may
        exceed the budget by one range so an out-of-order ``get`` always
        makes progress (the ReadStream contract)."""
        with self._run_lock:
            return self._run(tasks, deliver, budget, demand, reclaim, cancel)

    def _run(self, tasks, deliver, budget, demand, reclaim, cancel):
        stats = RangeStats()
        if budget is None:
            budget = StageBudget(self.cfg.inflight_bytes)
        by_id = {r.rid: r for r in tasks}
        pending = deque(tasks)
        active: dict[int, _Range] = {}
        q: SimpleQueue = SimpleQueue()
        t0 = trace.clock()
        try:
            while pending or active:
                if cancel is not None and cancel.is_set():
                    budget.settle()
                    break
                if reclaim is not None:
                    got = reclaim()
                    if got:
                        budget.sub(got)
                want = demand() if demand is not None else None
                if want:
                    for r in pending:
                        if r.rid in want and not r.demanded:
                            r.demanded = True
                            pending.remove(r)
                            pending.appendleft(r)
                            break
                while pending and len(active) < self.cfg.window:
                    r = pending[0]
                    # demanded ranges escape the budget by one range —
                    # blocking them behind staged-but-unconsumed bytes
                    # would deadlock the consumer that needs them
                    if not (r.demanded or budget.admits(r.nbytes)):
                        break
                    pending.popleft()
                    active[r.rid] = r
                    budget.add(r.nbytes)
                    stats.ranges += 1
                    self._issue(r, q, hedge=False)
                try:
                    rid, idx, data, err, retries = q.get(
                        timeout=self._next_deadline(active))
                except Empty:
                    pass
                else:
                    stats.retries += retries
                    r = by_id[rid]
                    r.outstanding -= 1
                    if err is not None:
                        if not r.done and r.outstanding == 0:
                            raise err      # every attempt failed
                        # else: loser failed after the win, or a sibling
                        # attempt is still racing — tolerate
                    elif not r.done:       # first completion wins
                        r.done = True
                        del active[rid]
                        stats.bytes += r.nbytes
                        t_done = trace.clock()
                        stats.range_seconds.append(t_done - r.issued_at)
                        trace.complete("remote.get", r.issued_at, t_done,
                                       tier="remote", nbytes=r.nbytes,
                                       attrs={"key": r.key,
                                              "attempts": r.attempts})
                        if idx > 0:
                            stats.hedge_wins += 1
                            trace.event("hedge.win", tier="remote",
                                        nbytes=r.nbytes,
                                        attrs={"key": r.key})
                        if not deliver(r, data):
                            budget.sub(r.nbytes)
                    # else: losing hedge attempt landed late — discard
                now = trace.clock()
                for r in active.values():
                    if now >= r.deadline \
                            and r.attempts <= self.cfg.max_hedges:
                        # a hedge that itself stalls gets re-hedged after a
                        # fresh grace period, up to max_hedges duplicates —
                        # the completion tail is bounded by the hedge
                        # threshold, not by the store's stall time
                        stats.hedged += 1
                        self._issue(r, q, hedge=True)
                        r.deadline = now + max(
                            self.cfg.hedge_after_s,
                            r.nbytes / self.cfg.min_bw_bytes_s)
        except BaseException:
            budget.settle()
            raise
        finally:
            stats.seconds = trace.clock() - t0
            stats.peak_staged_bytes = budget.peak
        return stats

    def _next_deadline(self, active) -> float:
        now = trace.clock()
        cands = [r.deadline - now for r in active.values()
                 if r.attempts <= self.cfg.max_hedges]
        # cap the wait so reclaim/demand/cancel are re-polled promptly even
        # when no completion is due
        return min(max(0.001, min(cands)) if cands else 0.02, 0.02)


# -------------------------------------------------------- tier-2 transfers
class RemoteTransferEngine:
    """``TieredTransferEngine``-shaped reader over an object store.

    ``transfer`` pulls whole objects into local files; ``fetch_ranges``
    pulls byte ranges of objects under a key prefix into same-named local
    files (sized like the object, sparse elsewhere) — the exact surface
    ``RestorePrefetcher`` drives, so ``RemotePrefetcher`` below reuses its
    staging/coverage/promotion machinery unchanged. Chunk refs
    (``../chunkstore/<pack>``) normalize to tier-wide chunk objects on the
    key side and land in the local shared chunkstore on the file side.
    """

    def __init__(self, store: ObjectStore, cfg: RemoteConfig | None = None):
        self.store = store
        self.cfg = cfg or RemoteConfig()
        self.sched = RangeScheduler(store, self.cfg)
        self._lock = threading.Lock()
        # crlint: guarded-by(_lock)
        self.last_stats = RangeStats()

    def transfer(self, pairs: list[tuple[str, str]]) -> RangeStats:
        """Pull whole objects ``[(key, local_dst_abs), ...]``."""
        items = []
        for key, dst in pairs:
            meta = self.store.head(key)
            if meta is None:
                raise RemoteError(404, key, "HEAD")
            items.append((key, dst, meta.size, [(0, meta.size)]))
        return self._pull(items)

    def fetch_ranges(self, src_prefix: str, dst_dir: str,
                     extents: list[Extent]) -> RangeStats:
        by_path: dict[str, list[tuple[int, int]]] = {}
        for e in extents:
            by_path.setdefault(e.path, []).append((e.offset, e.nbytes))
        items = []
        for path, spans in sorted(by_path.items()):
            key = join_key(src_prefix, path)
            meta = self.store.head(key)
            if meta is None:
                raise RemoteError(404, key, "HEAD")
            aligned = []
            for off, n in spans:
                start, span = aligned_span(off, n, self.cfg.align)
                aligned.append((start, min(start + span, meta.size)))
            items.append((key, os.path.join(dst_dir, path), meta.size,
                          _merge_intervals(aligned)))
        return self._pull(items)

    def _pull(self, items) -> RangeStats:
        """items: [(key, dst_abs, object_size, [(start, end), ...])]"""
        with self._lock:
            fds = []
            try:
                tasks = []
                for key, dst, size, intervals in items:
                    d = os.path.dirname(dst)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    fd = os.open(dst, os.O_RDWR | os.O_CREAT, 0o644)
                    fds.append(fd)
                    os.ftruncate(fd, size)
                    for start, end in intervals:
                        for off, n in _split(start, end,
                                             self.cfg.range_bytes):
                            tasks.append(_Range(len(tasks), key, off, n,
                                                obj=fd))
                def deliver(r, data):
                    faults.pwrite(r.obj, data, r.offset)
                    return False
                stats = self.sched.run(tasks, deliver)
                for fd in fds:
                    faults.fsync(fd)
            finally:
                for fd in fds:
                    os.close(fd)
            stats.objects = len(items)
            self.last_stats = stats
            return stats

    def close(self) -> None:
        self.sched.close()


class RemotePrefetcher(RestorePrefetcher):
    """``RestorePrefetcher`` whose remote tier is an object store.

    Only ``begin`` differs from the level-1 prefetcher: the manifest is a
    whole-object GET (it is small and unplannable until read) and blob
    extents ride the range scheduler. Coverage accounting, planned-extent
    fetches, and the promote-on-full-coverage commit are inherited — a
    fully-pulled level-2 step becomes a committed level-0 step bit-exactly,
    a partial pull stays staged and is garbage-collected.
    """

    def __init__(self, store: ObjectStore, prefix: str = "",
                 cfg: RemoteConfig | None = None,
                 transfer: RemoteTransferEngine | None = None):
        self.store = store
        self.prefix = prefix
        self._owns_transfer = transfer is None
        self.transfer = transfer or RemoteTransferEngine(store, cfg)
        self._active: dict[str, dict] = {}
        self.last_fetch_stats: RangeStats | None = None

    def begin(self, step: int, local_dir: str) -> str | None:
        from .checkpoint import step_dir_name
        src = join_key(self.prefix, step_dir_name(step))
        mkey = join_key(src, MANIFEST_NAME)
        if self.store.head(mkey) is None:
            return None
        raw = self.store.get(mkey)
        manifest = Manifest.loads(raw)
        staged = os.path.join(local_dir,
                              step_dir_name(step) + self.STAGING_SUFFIX)
        faults.rmtree(staged, ignore_errors=True)
        os.makedirs(staged)
        try:
            with open(os.path.join(staged, MANIFEST_NAME), "wb") as f:
                f.write(raw)
                f.flush()
                faults.fsync(f.fileno())
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


# ----------------------------------------------------------- upload / tier
@dataclass
class UploadStats:
    objects: int = 0           # objects PUT (incl. the manifest)
    bytes: int = 0             # payload bytes shipped over the wire
    chunks_shipped: int = 0
    chunks_skipped: int = 0    # content-addressed dedup: already remote
    bytes_skipped: int = 0     # bytes the dedup kept off the wire
    seconds: float = 0.0


class RemoteTier:
    """Level-2 step publisher: chunk-dedup upload + committed-step listing.

    Key layout mirrors the local multilevel layout —
    ``<prefix>/step_XXXXXXXX/<file>`` and ``<prefix>/chunkstore/<pack>`` —
    so manifests' store-relative chunk refs resolve identically on both
    sides. Chunkstore packs are content-addressed and immutable (uuid
    names, never rewritten), so a HEAD returning the local pack's size
    proves the remote copy is identical and the pack is skipped.
    """

    def __init__(self, store: ObjectStore, *, prefix: str = "",
                 cfg: RemoteConfig | None = None):
        self.store = store
        self.prefix = prefix
        self.cfg = cfg or RemoteConfig()

    def step_key(self, step: int) -> str:
        from .checkpoint import step_dir_name
        return join_key(self.prefix, step_dir_name(step))

    def committed_steps(self) -> list[int]:
        """Steps whose manifest object exists — the remote commit point."""
        pat = re.compile(r"step_(\d{8})/" + re.escape(MANIFEST_NAME) + "$")
        steps = []
        for key in self.store.list_prefix(join_key(self.prefix, "step_")
                                          if self.prefix else "step_"):
            m = pat.search(key)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def upload_step(self, local_root: str, step: int) -> UploadStats:
        """Publish a committed local step: referenced chunkstore packs
        first (deduped via HEAD), then step data files, then the manifest
        object LAST — a crash anywhere before that final PUT leaves the
        step unpublished and every already-shipped object unreferenced
        (and reusable by the next attempt)."""
        from .checkpoint import step_dir_name
        t0 = trace.clock()
        with trace.span("upload", tier="remote", attrs={"step": step}):
            return self._upload_step_traced(local_root, step, t0)

    def _upload_step_traced(self, local_root: str, step: int,
                            t0: float) -> UploadStats:
        from .checkpoint import step_dir_name
        src_dir = os.path.join(local_root, step_dir_name(step))
        manifest = Manifest.load(src_dir)
        step_key = self.step_key(step)
        stats = UploadStats()
        puts: list[tuple[str, str]] = []
        for rel in sorted(set(delta_mod.manifest_store_paths(manifest))):
            local = os.path.join(local_root, delta_mod.CHUNKSTORE_DIR, rel)
            key = join_key(self.prefix, delta_mod.CHUNKSTORE_DIR, rel)
            size = os.path.getsize(local)
            meta = self.store.head(key)
            if meta is not None and meta.size == size:
                stats.chunks_skipped += 1
                stats.bytes_skipped += size
                continue
            stats.chunks_shipped += 1
            puts.append((key, local))
        manifest_file = None
        for dirpath, _dirs, files in os.walk(src_dir):
            for name in sorted(files):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, src_dir).replace(os.sep, "/")
                if rel == MANIFEST_NAME:
                    manifest_file = path
                    continue
                puts.append((join_key(step_key, rel), path))
        if manifest_file is None:
            raise FileNotFoundError(f"{src_dir} has no {MANIFEST_NAME}")

        def ship(item: tuple[str, str]) -> int:
            key, path = item
            with open(path, "rb") as f:
                data = f.read()
            with trace.span("remote.put", tier="remote", nbytes=len(data),
                            attrs={"key": key}):
                self.store.put(key, data)
            return len(data)

        if self.cfg.put_workers > 1 and len(puts) > 1:
            with ThreadPoolExecutor(
                    max_workers=self.cfg.put_workers,
                    thread_name_prefix="rput") as ex:
                for n in ex.map(ship, puts):
                    stats.bytes += n
        else:
            for item in puts:
                stats.bytes += ship(item)
        stats.bytes += ship((join_key(step_key, MANIFEST_NAME),
                             manifest_file))
        stats.objects = len(puts) + 1
        stats.seconds = trace.clock() - t0
        return stats


# ------------------------------------------------------------ checkpointer
class RemoteCheckpointer:
    """Level-0 ``CheckpointManager`` + level-2 object tier.

    ``save`` commits locally first, then publishes the step remotely
    (dedup upload, manifest last); ``restore`` prefers local steps and
    reaches the remote tier two ways:

      · ``restore_mode="stream"`` (default): the manifest is fetched into a
        private metadata dir and the restore runs on a
        ``RemoteReadEngine`` — every data/chunk extent streams from remote
        ranges straight into the RestorePipeline (read → dequantize →
        assemble → H2D), no local copy of the checkpoint is ever staged.
      · ``restore_mode="promote"``: a ``RemotePrefetcher`` on the local
        manager stages ranges at level 0 and promotes full pulls to a
        committed local step (the next restore of that step is local).

    Extra keyword arguments go to the local ``CheckpointManager`` (engine,
    delta, streaming, verify_crc, ...).
    """

    def __init__(self, local_dir: str, store: ObjectStore, *,
                 prefix: str = "", remote: RemoteConfig | None = None,
                 upload_async: bool = True, restore_mode: str = "stream",
                 **mgr_kw):
        from .checkpoint import CheckpointManager
        if restore_mode not in ("stream", "promote"):
            raise ValueError(f"unknown restore_mode {restore_mode!r}")
        self.store = store
        self.cfg = remote or RemoteConfig()
        self.tier = RemoteTier(store, prefix=prefix, cfg=self.cfg)
        self.local = CheckpointManager(local_dir, **mgr_kw)
        self.restore_mode = restore_mode
        if restore_mode == "promote":
            self.local.prefetcher = RemotePrefetcher(store, prefix, self.cfg)
        self.upload_async = upload_async
        self._upload_thread: threading.Thread | None = None
        self._upload_error: BaseException | None = None
        self._rmgr = None
        self.last_upload_stats = UploadStats()
        self.last_restore_metrics = None

    @property
    def directory(self) -> str:
        return self.local.directory

    def __enter__(self) -> "RemoteCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, **kw):
        self.wait()
        out = self.local.save(step, state, **kw)
        self.local.wait()        # the upload reads the committed files
        if self.upload_async:
            t = threading.Thread(target=self._upload_bg, args=(step,),
                                 daemon=True, name="remote-upload")
            self._upload_thread = t
            t.start()
        else:
            self.last_upload_stats = self.tier.upload_step(
                self.local.directory, step)
        return out

    def _upload_bg(self, step: int) -> None:
        try:
            self.last_upload_stats = self.tier.upload_step(
                self.local.directory, step)
        except BaseException as e:
            self._upload_error = e

    def wait(self) -> None:
        """Block until the in-flight upload lands; re-raises its error."""
        t = self._upload_thread
        if t is not None:
            t.join()
            self._upload_thread = None
        err, self._upload_error = self._upload_error, None
        if err is not None:
            raise err

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(set(self.local.all_steps())
                      | set(self.tier.committed_steps()))

    def restore(self, template=None, *, step: int | None = None, **kw):
        self.wait()
        local_steps = set(self.local.all_steps())
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(
                    f"no checkpoints under {self.local.directory} "
                    f"or the remote tier")
            step = steps[-1]
        if step in local_steps or self.restore_mode == "promote":
            out = self.local.restore(template, step=step, **kw)
            self.last_restore_metrics = self.local.last_restore_metrics
            return out
        return self._restore_stream(template, step, **kw)

    def _remote_mgr(self):
        """Lazy manager over a private metadata dir whose engine reads
        remote ranges; only manifests ever touch its directory. It restores
        onto the local manager's device (where a template leaf names
        none)."""
        if self._rmgr is None:
            from .checkpoint import CheckpointManager
            from .engines.remote import RemoteReadEngine
            mgr = CheckpointManager(
                os.path.join(self.local.directory, ".remote-meta"),
                engine="aggregated", streaming=True,
                verify_crc=self.local.verify_crc, device=self.local.device)
            mgr.engine.close()
            mgr.engine = RemoteReadEngine(self.store, self.cfg,
                                          config=mgr.config)
            self._rmgr = mgr
        return self._rmgr

    def _restore_stream(self, template, step: int, **kw):
        from .checkpoint import step_dir_name
        mgr = self._remote_mgr()
        step_key = self.tier.step_key(step)
        raw = self.store.get(join_key(step_key, MANIFEST_NAME))
        ckpt = os.path.join(mgr.directory, step_dir_name(step))
        os.makedirs(ckpt, exist_ok=True)
        with open(os.path.join(ckpt, MANIFEST_NAME), "wb") as f:
            f.write(raw)
        mgr.engine.step_prefix = step_key
        try:
            out = mgr.restore(template, step=step, **kw)
        finally:
            faults.rmtree(ckpt, ignore_errors=True)
        self.last_restore_metrics = mgr.last_restore_metrics
        return out

    def close(self) -> None:
        try:
            self.wait()
        # crlint: allow(CRL005): best-effort drain on close — the flush
        # error was already recorded/raised at wait()'s real call sites
        except BaseException:
            pass
        if self._rmgr is not None:
            self._rmgr.close()
            self._rmgr = None
        self.local.close()
