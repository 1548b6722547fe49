"""Remote-read engine: restore streams object-store ranges straight into
the pipeline (DESIGN.md §15).

``RemoteReadEngine`` adapts the remote range scheduler to the ``CREngine``
read surface, so ``CheckpointManager``'s streaming restore runs unmodified
against a level-2 checkpoint: the RestorePipeline declares its planned
``ReadReq``s (chunk refs already expanded), the stream splits them into
aligned ranges, keeps a window in flight under the staged-byte budget with
hedged re-issue masking stalls, and ``get`` hands each request's bytes to
decode/assemble/H2D as they land — no local copy of the checkpoint is ever
staged. ``step_prefix`` names the remote step; manifest-relative request
paths (including ``../chunkstore/<pack>`` chunk refs) resolve against it.

Save-side methods are intentionally absent: uploads go through
``remote.RemoteTier`` (dedup + manifest-last commit), not a write engine.

Module note: ``..remote`` is imported lazily — this module is imported by
``engines/__init__`` while ``core.remote`` (via ``core.delta``) imports the
engines package, and the lazy import breaks that cycle.
"""

from __future__ import annotations

import threading
import zlib

import numpy as np

from .. import trace
from ..buffers import StageBudget
from .base import ChecksumError, CREngine, IOStats, ReadReq, ReadStream


class RemoteReadEngine(CREngine):
    """Read-only engine whose backing tier is an object store."""

    name = "remote"
    supports_streaming_read = True

    def __init__(self, store, remote=None, config=None, pool=None):
        from ..remote import RangeScheduler, RemoteConfig, RangeStats
        super().__init__(config, pool)
        self.store = store
        self.rcfg = remote or RemoteConfig()
        self.sched = RangeScheduler(store, self.rcfg)
        self.step_prefix = ""          # remote key prefix of the step
        self.last_range_stats = RangeStats()

    def close(self) -> None:
        self.sched.close()
        super().close()

    # -------------------------------------------------------------- batch
    def read(self, ckpt_dir: str,
             reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        """Batch read (the lean-blob path): all ranges land before return."""
        from ..remote import _req_ranges
        t0 = trace.clock()
        bufs = {rq.key: bytearray(rq.nbytes) for rq in reqs}
        tasks = _req_ranges(reqs, self.step_prefix, self.rcfg.range_bytes)

        def deliver(r, data):
            rk, off = r.obj
            bufs[rk][off:off + len(data)] = data
            return False

        rstats = self.sched.run(tasks, deliver)
        self.last_range_stats = rstats
        self.last_restore_stats = IOStats(
            seconds=trace.clock() - t0,
            logical_bytes=rstats.bytes,
            io_requests=rstats.ranges,
            files=len({rq.path for rq in reqs}),
            io_seconds=rstats.seconds,
            peak_staged_bytes=rstats.peak_staged_bytes)
        return {k: np.frombuffer(bytes(v), dtype=np.uint8)
                for k, v in bufs.items()}

    # ---------------------------------------------------------- streaming
    def begin_restore(self, ckpt_dir: str, reqs: list[ReadReq], *,
                      crcs: dict[str, int] | None = None) -> ReadStream:
        return _RemoteReadStream(self, reqs, crcs)


class _RemoteReadStream(ReadStream):
    """Range scheduler on a background thread; ``get`` blocks per request.

    The scheduler owns the staged-byte budget single-threaded (the
    ``StageBudget`` contract): it adds bytes at issue, the consumer's
    ``get`` records consumed bytes under the stream lock, and the loop
    reclaims them between completions. A ``get`` for a request whose
    ranges have not been issued yet marks them demanded — they jump the
    issue queue and may exceed the budget by one range, so out-of-order
    consumption always makes progress."""

    def __init__(self, engine: RemoteReadEngine, reqs: list[ReadReq],
                 crcs: dict[str, int] | None):
        from ..remote import _req_ranges
        self.engine = engine
        self.reqs = {rq.key: rq for rq in reqs}
        self.crcs = dict(crcs) if (crcs and engine.config.checksum) else {}
        self.budget = StageBudget(engine.rcfg.inflight_bytes)
        self._cv = threading.Condition()
        self._bufs: dict[str, bytearray] = {}
        self._left: dict[str, int] = {}
        self._ready: dict[str, bytes] = {}
        self._rids: dict[str, list[int]] = {}
        self._demand: set[int] = set()
        self._consumed = 0
        self._err: BaseException | None = None
        self._rstats = None
        self._cancel = threading.Event()
        self._t0 = trace.clock()
        tasks = _req_ranges(reqs, engine.step_prefix,
                            engine.rcfg.range_bytes)
        for r in tasks:
            self._rids.setdefault(r.obj[0], []).append(r.rid)
        for rq in reqs:
            if rq.nbytes > 0:
                self._bufs[rq.key] = bytearray(rq.nbytes)
                self._left[rq.key] = rq.nbytes
            else:
                self._ready[rq.key] = b""
        self._thread = threading.Thread(target=self._run, args=(tasks,),
                                        daemon=True, name="remote-read")
        self._thread.start()

    def _run(self, tasks) -> None:
        def deliver(r, data):
            rk, off = r.obj
            with self._cv:
                buf = self._bufs.get(rk)
                if buf is None:
                    return False
                buf[off:off + len(data)] = data
                self._left[rk] -= len(data)
                if self._left[rk] == 0:
                    self._ready[rk] = bytes(self._bufs.pop(rk))
                    del self._left[rk]
                    self._cv.notify_all()
            return True       # staged until the consumer gets it

        def reclaim():
            with self._cv:
                n, self._consumed = self._consumed, 0
                return n

        def demand():
            with self._cv:
                return set(self._demand) if self._demand else None

        try:
            stats = self.engine.sched.run(
                tasks, deliver, budget=self.budget, demand=demand,
                reclaim=reclaim, cancel=self._cancel)
            with self._cv:
                self._rstats = stats
                self._cv.notify_all()
        except BaseException as e:
            with self._cv:
                self._err = e
                self._cv.notify_all()

    # ----------------------------------------------------------------- API
    def get(self, key: str) -> np.ndarray:
        rq = self.reqs[key]
        with self._cv:
            self._demand.update(self._rids.get(key, ()))
            while key not in self._ready and self._err is None:
                self._cv.wait(0.05)
            if key not in self._ready:
                raise self._err
            data = self._ready.pop(key)
            self._demand.difference_update(self._rids.get(key, ()))
            self._consumed += rq.nbytes
        if key in self.crcs:
            got = zlib.crc32(data)
            if got != self.crcs[key]:
                raise ChecksumError(key, rq.path, rq.offset,
                                    self.crcs[key], got)
        return np.frombuffer(data, dtype=np.uint8)

    def end_restore(self) -> IOStats:
        self._thread.join()
        if self._err is not None:
            raise self._err
        rstats = self._rstats
        stats = IOStats(
            seconds=trace.clock() - self._t0,
            logical_bytes=rstats.bytes,
            io_requests=rstats.ranges,
            files=len({rq.path for rq in self.reqs.values()}),
            io_seconds=rstats.seconds,
            peak_staged_bytes=rstats.peak_staged_bytes)
        self.engine.last_restore_stats = stats
        self.engine.last_range_stats = rstats
        return stats

    def abort(self) -> None:
        self._cancel.set()
        self._thread.join()
        with self._cv:
            self._ready.clear()
            self._bufs.clear()
            self._left.clear()
            self._demand.clear()
        self.budget.settle()
