"""DataStatesEngine — DataStates-LLM-faithful baseline (paper §2, §3.5).

Matches the behaviours the paper attributes to DataStates-LLM:
  · file-per-process layout ("file-per-shard" in DeepSpeed terms),
  · io_uring backend — the SAME backend as our AggregatedEngine,
  · but **per-object submission**: "coalesces objects into host buffers but
    submits I/O as soon as each object is available" — every object is its own
    write request; no cross-object coalescing into large transfers,
  · 64 MB chunking of large objects (paper §3.3),
  · buffered I/O (no O_DIRECT in its flush path),
  · restore issues a separate read *for every entry referenced in the
    metadata header* and allocates host memory for each read on the fly
    (paper Fig 13: allocation dominates restore). No native read stream:
    ``begin_restore`` is the validating buffered fallback (one batch read,
    CRC check per get, no read/consume overlap — DESIGN.md §10.3).

The deltas to AggregatedEngine are exactly the paper's findings; everything
else (ring, manifest) is shared, so benchmark gaps isolate the design axes.
"""

from __future__ import annotations


import numpy as np

from .. import trace
from ..aggregation import Strategy
from ..buffers import align_up
from ..io_engine import IORequest, OP_READ, OP_WRITE
from ..manifest import Manifest
from .base import CREngine, EngineConfig, IOStats, ReadReq, SaveItem, item_mv


class DataStatesEngine(CREngine):
    name = "datastates"

    def __init__(self, config: EngineConfig | None = None, pool=None):
        from dataclasses import replace
        cfg = replace(config) if config is not None else EngineConfig()
        cfg.backend = "auto"           # uring when the kernel has it
        cfg.strategy = Strategy.FILE_PER_PROCESS
        cfg.direct = False             # buffered flush path
        cfg.pooled_buffers = False     # dynamic allocation (paper Fig 13)
        super().__init__(cfg, pool)

    def save(self, ckpt_dir: str, items: list[SaveItem], *, step: int = 0,
             rank: int = 0, num_ranks: int = 1,
             rank_totals: list[int] | None = None) -> Manifest:
        cfg = self.config
        t0 = trace.clock()
        stats = IOStats()
        plan = self._plan(items, rank, rank_totals)
        by_key = {e.key: e for e in plan.extents}
        fds = self._open_files(ckpt_dir, plan, "w")
        stats.files = len(fds)
        io = self._make_io()
        inflight: dict[int, object] = {}
        token = 0

        def reap(block_min: int):
            for c in io.poll(min_n=block_min):
                buf = inflight.pop(c.user_data, None)
                if buf is not None:
                    buf.release()

        try:
            # per-OBJECT submission, in arrival order — no batch accumulation
            for it in items:
                e = by_key[it.key]
                mv = item_mv(it)
                pos = 0
                while pos < it.nbytes or (it.nbytes == 0 and pos == 0):
                    n = min(cfg.chunk_bytes, it.nbytes - pos)
                    ta = trace.clock()
                    buf = self.pool.get(max(n, 1))   # fresh buffer each time
                    tb = trace.clock()
                    buf.view(0, n)[:] = mv[pos:pos + n]
                    stats.alloc_seconds += tb - ta
                    stats.copy_seconds += trace.clock() - tb
                    token += 1
                    inflight[token] = buf
                    io.submit([IORequest(OP_WRITE, fds[e.path], e.offset + pos,
                                         buf, 0, max(n, 1), user_data=token)])
                    stats.io_requests += 1
                    pos += max(n, 1)
                    while io.inflight >= cfg.queue_depth:
                        reap(1)
            while io.inflight:
                reap(1)
            self._fsync_all(io, fds)
        finally:
            io.close()
            self._close_files(fds)
        stats.logical_bytes = plan.total_logical_bytes
        stats.seconds = trace.clock() - t0
        self.last_save_stats = stats
        return self._manifest_from(items, plan, step=step, num_ranks=num_ranks)

    def read(self, ckpt_dir: str, reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        """One read per metadata entry; per-read dynamic allocation."""
        cfg = self.config
        t0 = trace.clock()
        stats = IOStats()
        out: dict[str, np.ndarray] = {}
        fds = self._open_files(ckpt_dir, {r.path for r in reqs}, "r")
        stats.files = len(fds)
        io = self._make_io()
        handlers: dict[int, tuple] = {}
        token = 0

        def reap(block_min: int):
            for c in io.poll(min_n=block_min):
                buf, key, nbytes = handlers.pop(c.user_data)
                tb = trace.clock()
                arr = np.empty(nbytes, dtype=np.uint8)
                arr[:] = np.frombuffer(buf.view(0, nbytes), np.uint8)
                out[key] = arr
                stats.copy_seconds += trace.clock() - tb
                buf.release()   # pool disabled → munmap'd, next get() realloc

        try:
            for r in reqs:
                # NOTE: one request per manifest entry, even tiny ones
                ta = trace.clock()
                buf = self.pool.get(max(r.nbytes, 1))
                stats.alloc_seconds += trace.clock() - ta
                token += 1
                handlers[token] = (buf, r.key, r.nbytes)
                io.submit([IORequest(OP_READ, fds[r.path], r.offset, buf, 0,
                                     max(r.nbytes, 1), user_data=token)])
                stats.io_requests += 1
                while io.inflight >= cfg.queue_depth:
                    reap(1)
            while io.inflight:
                reap(1)
        finally:
            io.close()
            self._close_files(fds)
        stats.logical_bytes = sum(r.nbytes for r in reqs)
        stats.seconds = trace.clock() - t0
        self.last_restore_stats = stats
        return out
