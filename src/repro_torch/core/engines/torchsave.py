"""TorchSaveEngine — the ``torch.save`` baseline (paper §2, Fig 3).

"Synchronously and sequentially allocate host memory for all GPU resident data
structures, transfer them from GPU to the host memory, serialize the entire
logical object, and finally flush to disk."

Faithfully modeled: every tensor is *pickled* (full serialization cost, no
pre-serialized fast path), the pickle stream is written sequentially through
buffered POSIX I/O as one monolithic file per rank, then fsync'd. Restore
reads + unpickles the whole object even if one tensor is wanted; its
``begin_restore`` is the validating buffered fallback (DESIGN.md §10.3).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .. import faults, trace
from ..manifest import Manifest, ShardEntry, BlobRecord
from .base import CREngine, EngineConfig, IOStats, ReadReq, SaveItem, item_mv


class TorchSaveEngine(CREngine):
    name = "torchsave"

    def __init__(self, config: EngineConfig | None = None, pool=None):
        from dataclasses import replace
        cfg = replace(config) if config is not None else EngineConfig()
        cfg.backend = "posix"
        cfg.direct = False            # torch.save is buffered
        cfg.pooled_buffers = False
        super().__init__(cfg, pool)
        self._cache: dict[str, dict[str, np.ndarray]] = {}

    def _path(self, rank: int) -> str:
        return f"data/mp_rank_{rank:05d}.pt"

    def save(self, ckpt_dir: str, items: list[SaveItem], *, step: int = 0,
             rank: int = 0, num_ranks: int = 1,
             rank_totals: list[int] | None = None) -> Manifest:
        t0 = trace.clock()
        stats = IOStats()
        # Full-object serialization: tensors are materialized & pickled.
        tc0 = trace.clock()
        obj = {it.key: (bytes(item_mv(it)), it.dtype, it.global_shape,
                        it.index, it.is_blob) for it in items}
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        stats.copy_seconds = trace.clock() - tc0

        rel = self._path(rank)
        full = os.path.join(ckpt_dir, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        ti0 = trace.clock()
        with open(full, "wb") as f:
            f.write(payload)
            f.flush()
            if self.config.fsync_on_save:
                faults.fsync(f.fileno())
        stats.io_seconds = trace.clock() - ti0
        stats.io_requests = 1
        stats.files = 1
        stats.logical_bytes = sum(it.nbytes for it in items)
        stats.seconds = trace.clock() - t0
        self.last_save_stats = stats

        m = Manifest(step=step, num_ranks=num_ranks, strategy="torchsave")
        for it in items:
            rkey = it.record_key or it.key
            # packed format: address shards as "<file>::<item key>"
            addr = f"{rel}::{it.key}"
            if it.is_blob:
                m.blobs[rkey] = BlobRecord(rkey, addr, 0, it.nbytes)
            else:
                index = it.index if it.index is not None else tuple(
                        (0, s) for s in (it.global_shape if it.global_shape is not None else ()))
                m.add_shard(rkey, it.dtype or "uint8",
                            it.global_shape if it.global_shape is not None else (it.nbytes,),
                            ShardEntry(index, addr, 0, it.nbytes))
        m.extra["engine"] = {"name": self.name, "packed": True}
        return m

    def read(self, ckpt_dir: str, reqs: list[ReadReq]) -> dict[str, np.ndarray]:
        t0 = trace.clock()
        stats = IOStats()
        out: dict[str, np.ndarray] = {}
        for path in {r.path.partition("::")[0] for r in reqs}:
            full = os.path.join(ckpt_dir, path)
            if full not in self._cache:
                ti0 = trace.clock()
                with open(full, "rb") as f:
                    payload = f.read()       # opaque: reads EVERYTHING
                stats.io_seconds += trace.clock() - ti0
                stats.io_requests += 1
                tc0 = trace.clock()
                obj = pickle.loads(payload)
                self._cache[full] = {
                    k: np.frombuffer(v[0], dtype=np.uint8).copy()
                    for k, v in obj.items()}
                stats.copy_seconds += trace.clock() - tc0
            stats.files += 1
        for r in reqs:
            file_rel, _, item_key = r.path.partition("::")
            arr = self._cache[os.path.join(ckpt_dir, file_rel)][
                item_key or r.obj or r.key]
            out[r.key] = arr[:r.nbytes] if r.nbytes < arr.nbytes else arr
        stats.logical_bytes = sum(r.nbytes for r in reqs)
        stats.seconds = trace.clock() - t0
        self.last_restore_stats = stats
        self._cache.clear()
        return out
