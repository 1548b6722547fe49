"""SnapshotEngine — TorchSnapshot-faithful baseline (paper §2).

"Large objects and model states are subdivided into fixed size amounts (512 MB
by default), and each fixed-size chunk is flushed to a separate file inside a
deeply nested subdirectory, stressing all levels of the PFS."

Modeled faithfully:
  · every object is split into ``chunk_bytes`` pieces, chunk-per-file under
    ``data/rank_<r>/<key>/<idx>.bin`` (deep nesting → metadata pressure),
  · buffered I/O (its libaio backend predates O_DIRECT-friendly batching),
  · writes are dispatched to a small thread pool as each chunk is produced —
    per-object granularity, no cross-object coalescing,
  · restore is SERIAL per logical object: all chunks of object k are read and
    assembled before object k+1 starts (paper: "all checkpoint engines restore
    the M logical objects serially"), with dynamic allocation per read. No
    native read stream: ``begin_restore`` is the validating buffered fallback
    (DESIGN.md §10.3).
"""

from __future__ import annotations

import os

import numpy as np

from .. import faults, trace
from ..io_engine import IORequest, OP_READ, OP_WRITE
from ..manifest import Manifest, ShardEntry, BlobRecord
from ..aggregation import _sanitize
from .base import CREngine, EngineConfig, IOStats, ReadReq, SaveItem, item_mv


class SnapshotEngine(CREngine):
    name = "snapshot"

    def __init__(self, config: EngineConfig | None = None, pool=None):
        from dataclasses import replace
        cfg = replace(config) if config is not None else EngineConfig()
        cfg.backend = "threadpool"     # libaio-era stand-in
        cfg.direct = False             # buffered
        cfg.pooled_buffers = False     # dynamic allocation
        super().__init__(cfg, pool)

    def _obj_dir(self, rank: int, key: str) -> str:
        return f"data/rank_{rank:05d}/{_sanitize(key)}"

    def save(self, ckpt_dir: str, items: list[SaveItem], *, step: int = 0,
             rank: int = 0, num_ranks: int = 1,
             rank_totals: list[int] | None = None) -> Manifest:
        cfg = self.config
        t0 = trace.clock()
        stats = IOStats()
        io = self._make_io()
        inflight: dict[int, tuple] = {}  # token -> (fd, buf)
        token = 0

        def reap(block_min: int):
            for c in io.poll(min_n=block_min):
                fd, buf = inflight.pop(c.user_data)
                if cfg.fsync_on_save:
                    faults.fsync(fd)
                os.close(fd)
                buf.release()

        m = Manifest(step=step, num_ranks=num_ranks, strategy="snapshot")
        try:
            for it in items:
                mv = item_mv(it)
                obj_dir = self._obj_dir(rank, it.key)
                os.makedirs(os.path.join(ckpt_dir, obj_dir), exist_ok=True)
                pos, idx = 0, 0
                while pos < it.nbytes or (it.nbytes == 0 and idx == 0):
                    n = min(cfg.chunk_bytes, it.nbytes - pos)
                    rel = f"{obj_dir}/{idx:06d}.bin"
                    # one file PER CHUNK — opened, written, fsync'd, closed
                    fd = os.open(os.path.join(ckpt_dir, rel),
                                 os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
                    ta = trace.clock()
                    buf = self.pool.get(max(n, 1))
                    tb = trace.clock()
                    buf.view(0, n)[:] = mv[pos:pos + n]
                    stats.alloc_seconds += tb - ta
                    stats.copy_seconds += trace.clock() - tb
                    token += 1
                    inflight[token] = (fd, buf)
                    io.submit([IORequest(OP_WRITE, fd, 0, buf, 0, n,
                                         user_data=token)])
                    stats.io_requests += 1
                    stats.files += 1
                    pos += n
                    idx += 1
                    while io.inflight >= cfg.queue_depth:
                        reap(1)
                rkey = it.record_key or it.key
                if it.is_blob:
                    m.blobs[rkey] = BlobRecord(rkey, obj_dir, 0, it.nbytes)
                else:
                    index = it.index if it.index is not None else tuple(
                        (0, s) for s in (it.global_shape if it.global_shape is not None else ()))
                    m.add_shard(rkey, it.dtype or "uint8",
                                it.global_shape if it.global_shape is not None else (it.nbytes,),
                                ShardEntry(index, obj_dir, 0, it.nbytes))
            while io.inflight:
                reap(1)
        finally:
            io.close()
        stats.logical_bytes = sum(it.nbytes for it in items)
        stats.seconds = trace.clock() - t0
        self.last_save_stats = stats
        m.extra["engine"] = {"name": self.name, "chunk_bytes": cfg.chunk_bytes,
                             "chunked_dirs": True}
        return m

    def read(self, ckpt_dir: str, reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        """Serial, per-object, chunk-at-a-time restore with dynamic alloc."""
        cfg = self.config
        t0 = trace.clock()
        stats = IOStats()
        out: dict[str, np.ndarray] = {}
        for r in reqs:  # objects strictly one-after-another
            dest = np.empty(r.nbytes, dtype=np.uint8)
            pos = r.offset
            end = r.offset + r.nbytes
            while pos < end:
                idx = pos // cfg.chunk_bytes
                in_chunk = pos - idx * cfg.chunk_bytes
                n = min(end - pos, cfg.chunk_bytes - in_chunk)
                rel = f"{r.path}/{idx:06d}.bin"
                ta = trace.clock()
                buf = self.pool.get(n)          # fresh allocation per read
                try:
                    tb = trace.clock()
                    fd = os.open(os.path.join(ckpt_dir, rel), os.O_RDONLY)
                    total = 0
                    mv = buf.view(0, n)
                    try:
                        while total < n:
                            got = faults.preadv(fd, [mv[total:]],
                                                in_chunk + total)
                            if got == 0:
                                raise EOFError(rel)
                            total += got
                    finally:
                        os.close(fd)
                    tc = trace.clock()
                    dest[pos - r.offset:pos - r.offset + n] = np.frombuffer(mv, np.uint8)
                    stats.alloc_seconds += tb - ta
                    stats.io_seconds += tc - tb
                    stats.copy_seconds += trace.clock() - tc
                    stats.io_requests += 1
                    stats.files += 1
                finally:
                    buf.release()
                pos += n
            out[r.key] = dest
        stats.logical_bytes = sum(r.nbytes for r in reqs)
        stats.seconds = trace.clock() - t0
        self.last_restore_stats = stats
        return out
