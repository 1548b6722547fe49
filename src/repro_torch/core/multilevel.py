"""Multi-level checkpointing: local-first capture, async PFS flush, hedged
straggler mitigation.

Traditional HPC C/R frameworks (VELOC/FTI/SCR, paper §2) pre-coalesce to local
storage before flushing to the PFS. We adopt the same split for the LLM case:

  level 0 — node-local directory (fast, survives process crash, not node loss)
  level 1 — shared/parallel FS directory (slow, survives node loss)

``save`` returns as soon as level 0 committed; the level-1 flush runs in the
background. The flush executes through the tiered transfer engine
(DESIGN.md §8): extents stream through an io_engine backend (uring when the
kernel has it), and slow extents (stragglers — e.g. a contended OST) are
*hedged*: after a deadline a duplicate transfer is issued and the first to
finish wins — bounding the tail without failing the flush. Passing a
``copy_fn`` selects the legacy whole-file path with whole-file hedging.

Restore prefers level 0; a step only at level 1 is restored through
``RestorePrefetcher``, which pulls the planned extents into level 0 ahead of
tensor materialization and commits the step locally when fully covered.

``delta=True`` flushes only the store chunks a step actually references
(never re-flushing residents); the fp128 digest kind (DESIGN.md §14)
rides inside the manifest's chunk entries, so level-1 mirrors verify and
repair with the same digest the scrubber uses locally.
"""

from __future__ import annotations

import glob
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait, FIRST_COMPLETED
from dataclasses import dataclass, field

from . import delta as delta_mod
from . import faults, trace
from .checkpoint import CheckpointManager, replace_dir, step_dir_name
from .manifest import Manifest, ManifestError
from .tiered import RestorePrefetcher, TieredTransferEngine


@dataclass
class FlushStats:
    files: int = 0
    bytes: int = 0
    seconds: float = 0.0
    hedged: int = 0          # duplicate transfers issued
    hedge_wins: int = 0      # duplicates that beat the original
    extents: int = 0         # extent-granular segments (tiered path)
    chunks_flushed: int = 0  # delta store files copied to level 1 (§12)
    chunks_skipped: int = 0  # delta store files already resident at level 1
    backend: str = ""        # io_engine backend the flush executed on
    read_gbps: float = 0.0   # source tier (level 0) bandwidth
    write_gbps: float = 0.0  # destination tier (level 1) bandwidth
    per_tier: dict = field(default_factory=dict)  # EngineStats per tier

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0


def _default_copy(src: str, dst: str) -> None:
    tmp = dst + ".tmp"
    with open(src, "rb") as fi, open(tmp, "wb") as fo:
        shutil.copyfileobj(fi, fo, length=8 << 20)
        fo.flush()
        faults.fsync(fo.fileno())
    faults.replace(tmp, dst)


class MultiLevelCheckpointer:
    """CheckpointManager wrapper adding a second (remote) persistence level."""

    def __init__(self, local_dir: str, remote_dir: str, *,
                 engine: str = "aggregated", config=None,
                 hedge_after_s: float = 5.0, min_bw_bytes_s: float = 50e6,
                 flush_workers: int = 4, copy_fn=None,
                 transfer_backend: str = "auto", direct: bool = False,
                 chunk_bytes: int = 4 << 20, transfer=None,
                 stage_inflight_bytes: int | None = None, **mgr_kw):
        """``copy_fn=None`` (default) flushes through the tiered transfer
        engine; a callable selects the legacy per-file copy path with
        whole-file hedging. ``transfer`` injects a preconfigured
        TieredTransferEngine (tests, shared pools).
        ``stage_inflight_bytes`` caps the flush's staged bytes in flight —
        the same backpressure primitive the in-training SnapshotPipeline
        uses, so both capture and tier flush stage through one bounded
        pooled-buffer flow."""
        self.local = CheckpointManager(local_dir, engine=engine,
                                       config=config, **mgr_kw)
        self.remote_dir = os.path.abspath(remote_dir)
        os.makedirs(self.remote_dir, exist_ok=True)
        self.hedge_after_s = hedge_after_s
        self.min_bw_bytes_s = min_bw_bytes_s
        self.copy_fn = copy_fn
        self.transfer = transfer or TieredTransferEngine(
            transfer_backend, chunk_bytes=chunk_bytes, direct=direct,
            queue_depth=flush_workers * 4, hedge_after_s=hedge_after_s,
            min_bw_bytes_s=min_bw_bytes_s,
            inflight_bytes=stage_inflight_bytes)
        # restore-side: steps only at level 1 are prefetched extent-wise
        self.local.prefetcher = RestorePrefetcher(self.remote_dir,
                                                  self.transfer)
        self._pool = ThreadPoolExecutor(max_workers=flush_workers,
                                        thread_name_prefix="flush")
        self._flush_thread: threading.Thread | None = None
        self._flush_error: BaseException | None = None
        self.last_flush_stats = FlushStats()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, **kw):
        self.wait()
        metrics = self.local.save(step, state, **kw)   # level 0
        self.local.wait()
        th = threading.Thread(target=self._flush_guarded, args=(step,),
                              daemon=True, name=f"l1-flush-{step}")
        self._flush_thread = th
        th.start()
        return metrics

    def _flush_guarded(self, step: int) -> None:
        try:
            self.flush_to_remote(step)
        except BaseException as e:
            self._flush_error = e

    def flush_to_remote(self, step: int) -> FlushStats:
        """Copy a committed local step dir to the remote level, hedged."""
        with trace.span("flush.level1", tier="level1",
                        attrs={"step": step}):
            return self._flush_to_remote_traced(step)

    def _flush_to_remote_traced(self, step: int) -> FlushStats:
        stats = FlushStats()
        t0 = trace.clock()
        src_dir = os.path.join(self.local.directory, step_dir_name(step))
        dst_tmp = os.path.join(self.remote_dir,
                               f"{step_dir_name(step)}.tmp-flush")
        dst_fin = os.path.join(self.remote_dir, step_dir_name(step))
        faults.rmtree(dst_tmp, ignore_errors=True)

        files = []
        for root, _dirs, names in os.walk(src_dir):
            for n in names:
                full = os.path.join(root, n)
                rel = os.path.relpath(full, src_dir)
                files.append((full, rel, os.path.getsize(full)))
        # manifest last: its presence defines validity at level 1 too
        files.sort(key=lambda f: (f[1] == "manifest.json", f[1]))

        # delta composition (§12): chunkstore files the step references must
        # be resident at level 1 BEFORE the step publishes there — but a
        # chunk already flushed by an earlier step is never moved again
        # (that is most of the point of delta: clean bytes cross no tier).
        # Copies land under unique .tmp names and are renamed in, so a
        # crashed flush can never leave a full-sized-but-partial chunk file
        # that a later flush would wrongly skip.
        store_pairs: list[tuple[str, str, str]] = []   # (src, tmp, final)
        store_rels = self._store_files(src_dir)
        for rel in store_rels:
            local = os.path.join(self.local.directory,
                                 delta_mod.CHUNKSTORE_DIR, rel)
            remote = os.path.join(self.remote_dir,
                                  delta_mod.CHUNKSTORE_DIR, rel)
            if (os.path.exists(remote)
                    and os.path.getsize(remote) == os.path.getsize(local)):
                stats.chunks_skipped += 1
                continue
            # reap tmp copies a crashed earlier flush stranded (no manager
            # ever GCs the remote tier); age-guarded so a concurrent
            # flusher's live tmp is left alone
            for stale in glob.glob(f"{remote}.tmp-flush-*"):
                try:
                    # crlint: allow(CRL006): mtime age check is wall-clock
                    if time.time() - os.path.getmtime(stale) > 300.0:
                        os.remove(stale)
                except OSError:
                    pass
            store_pairs.append(
                (local, f"{remote}.tmp-flush-{os.getpid()}", remote))
            stats.chunks_flushed += 1

        if self.copy_fn is not None:
            # legacy path: one copy_fn call per file, whole-file hedging
            for src, tmp, _fin in store_pairs:
                os.makedirs(os.path.dirname(tmp), exist_ok=True)
                size = os.path.getsize(src)
                self._copy_hedged(src, tmp, size, stats)
                stats.files += 1
                stats.bytes += size
            for src, rel, size in files:
                dst = os.path.join(dst_tmp, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                self._copy_hedged(src, dst, size, stats)
                stats.files += 1
                stats.bytes += size
        else:
            # tiered path: extent streams through an io_engine backend
            pairs = [(src, tmp) for src, tmp, _fin in store_pairs]
            pairs += [(src, os.path.join(dst_tmp, rel))
                      for src, rel, _size in files]
            ts = self.transfer.transfer(pairs)
            stats.files = ts.files
            stats.bytes = ts.bytes
            stats.extents = ts.extents
            stats.hedged = ts.hedged
            stats.hedge_wins = ts.hedge_wins
            stats.backend = ts.backend
            stats.per_tier = ts.per_tier()
        for _src, tmp, fin in store_pairs:
            # crlint: allow(CRL002): pack bytes were fsync'd by the transfer
            # engine (or _copy_hedged) before the rename; dir sync is below
            faults.replace(tmp, fin)
        # chunk renames must be dir-durable BEFORE the step publishes at
        # level 1: a step whose manifest is visible but whose chunk entries
        # evaporated in a crash would restore torn (gap found by CRL002)
        for d in sorted({os.path.dirname(fin) for _s, _t, fin in store_pairs}):
            dfd = os.open(d, os.O_RDONLY)
            try:
                faults.fsync(dfd)
            finally:
                os.close(dfd)
        # the shared displaced-aside publish: a re-flush of an existing
        # remote step never leaves a window where the previous copy is gone
        # before the new one landed
        replace_dir(dst_tmp, dst_fin)
        stats.seconds = trace.clock() - t0
        if stats.seconds:
            stats.read_gbps = (stats.per_tier.get("source", {})
                               .get("bytes_read", 0) / stats.seconds / 1e9)
            stats.write_gbps = (stats.per_tier.get("destination", {})
                                .get("bytes_written", 0) / stats.seconds / 1e9)
        self.last_flush_stats = stats
        return stats

    @staticmethod
    def _store_files(src_dir: str) -> list[str]:
        """Store-relative chunkstore files the committed step references."""
        try:
            manifest = Manifest.load(src_dir)
        except ManifestError:
            return []
        return sorted(set(delta_mod.manifest_store_paths(manifest)))

    def _copy_hedged(self, src: str, dst: str, size: int,
                     stats: FlushStats) -> None:
        deadline = max(self.hedge_after_s, size / self.min_bw_bytes_s)
        attempts = {self._pool.submit(self.copy_fn, src, dst): "primary"}
        hedged = False
        while True:
            done, pending = wait(list(attempts), timeout=deadline,
                                 return_when=FIRST_COMPLETED)
            if done:
                winner = next(iter(done))
                err = winner.exception()
                if err is None:
                    if attempts[winner] == "hedge":
                        stats.hedge_wins += 1
                        faults.replace(dst + ".hedge", dst)
                    return
                del attempts[winner]
                if not attempts:  # all attempts failed
                    raise err
            elif not hedged:
                hedged = True
                stats.hedged += 1
                attempts[self._pool.submit(self.copy_fn, src,
                                           dst + ".hedge")] = "hedge"
                # a winning hedge is moved into place
                deadline = None
            if hedged and os.path.exists(dst + ".hedge"):
                faults.replace(dst + ".hedge", dst)
                return

    # --------------------------------------------------------------- restore
    def restore(self, state_template=None, *, step: int | None = None, **kw):
        """Prefer level 0; fall back to level 1 (node-loss recovery)."""
        self.wait()
        local_steps = self.local.all_steps()
        if step is None:
            remote_steps = self._remote_steps()
            all_steps = sorted(set(local_steps) | set(remote_steps))
            if not all_steps:
                raise FileNotFoundError("no checkpoints at any level")
            step = all_steps[-1]
        if step in local_steps:
            return self.local.restore(state_template, step=step, **kw)
        # level-1 only: the local manager's RestorePrefetcher stages the
        # manifest, then pulls exactly the planned extents ahead of tensor
        # materialization; full coverage commits the step at level 0
        src = os.path.join(self.remote_dir, step_dir_name(step))
        if not Manifest.exists(src):
            raise FileNotFoundError(f"step {step} not committed at level 1")
        return self.local.restore(state_template, step=step, **kw)

    def _remote_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.remote_dir):
            if name.startswith("step_") and ".tmp" not in name and \
                    Manifest.exists(os.path.join(self.remote_dir, name)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    @property
    def last_restore_metrics(self):
        """Restore attribution of the local manager (restores always run
        there — level-1-only steps are prefetched into it first)."""
        return self.local.last_restore_metrics

    def wait_snapshotted(self) -> None:
        """Barrier on the local manager's staged snapshot (see
        CheckpointManager.wait_snapshotted); the level-1 flush keeps going."""
        self.local.wait_snapshotted()

    def wait(self) -> None:
        th = self._flush_thread
        if th is not None:
            th.join()
            self._flush_thread = None
        if self._flush_error is not None:
            err, self._flush_error = self._flush_error, None
            raise RuntimeError("level-1 flush failed") from err

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
        self.transfer.close()
        self.local.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
