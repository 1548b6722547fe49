"""Two-level checkpointing of a ``torch.distributed`` group: one process per
rank, one group checkpoint at level 0, one flush of it to level 1.

``MultiLevelCheckpointer`` is one process's handle on a two-level
checkpoint. On a DeviceMesh of N processes (``Trainer(mesh=,
multilevel_remote=)``) each rank saves only its own windows, and the step
is a group checkpoint that rank 0 merge-publishes
(``multiwriter.process_group_manager``). Running N of the single-process
handles side by side would go wrong in four places, and
``GroupMultiLevelCheckpointer`` settles each over the group:

  · save and flush — the step dir is whole only after rank 0's
    merge-publish, so rank 0 alone flushes it, once per committed step, in
    the background; ``wait()`` agrees on the flush's outcome over the
    group, so every rank raises a failed flush or none does;
  · choosing the step — the newest step of level 0 ∪ level 1 is rank 0's
    view, agreed before any rank reads (``latest_step``);
  · restore from level 1 — ``GroupRestorePrefetcher``: rank 0 stages the
    manifest and the lean blob into ``<level 0>/step_N.tmp-prefetch``, every
    rank pulls the extents of its own windows into that one staging dir
    (files are opened without truncation, so the ranks' ranges land side by
    side), the ranks' fetched ranges are gathered, and rank 0 promotes the
    staging dir when their union covers the manifest. A rank whose restore
    failed joins the same exchange (``discard``), so the peers raise
    instead of waiting on it;
  · startup cleanup — the group manager's ``_gc_tmp`` runs on rank 0 alone
    and the ranks wait for it (``multiwriter.GroupCheckpointManager``), and
    retention runs once per step, in rank 0's publish.

Every method that talks to the group is called by all ranks together, as
``save`` is. Level 0 is one directory the ranks share (a node-local level
0 on each of several machines, with ranks reading their own machine's
copy, is not modelled); level 1 is a second shared directory.
"""

from __future__ import annotations

import os
import threading

from .checkpoint import step_dir_name
from .multilevel import FlushStats, MultiLevelCheckpointer
from .multiwriter import DistGroup, process_group_manager
from .tiered import RestorePrefetcher, TieredTransferEngine, _IntervalSet


class GroupRestorePrefetcher(RestorePrefetcher):
    """``RestorePrefetcher`` for the ranks of a group sharing one level-0
    directory: one staging dir, staged by rank 0, filled by every rank with
    its own planned extents, promoted by rank 0 on their union."""

    def __init__(self, remote_dir: str, group: DistGroup,
                 transfer: TieredTransferEngine | None = None):
        super().__init__(remote_dir, transfer)
        self.group = group

    def begin(self, step: int, local_dir: str) -> str | None:
        """Rank 0 stages the manifest and the blob extents; every rank
        returns the staging dir (or None: not at level 1) once they are
        there."""
        outcome = None
        if self.group.rank == 0:
            try:
                outcome = ("ok", super().begin(step, local_dir))
            except BaseException as e:  # every rank raises below
                err, outcome = e, ("failed", repr(e))
        status, value = self.group.agree(outcome)
        if status == "failed":
            if self.group.rank == 0:
                raise err
            raise RuntimeError(f"rank 0 could not stage step {step} from "
                               f"level 1: {value}")
        if value is not None and self.group.rank != 0:
            # the peers pull into rank 0's staging dir; rank 0 alone holds
            # the manifest and checks the coverage
            self._active[value] = {"src": os.path.join(
                self.remote_dir, step_dir_name(step)), "fetched": {}}
        return value

    def _exchange(self, staged: str, final: str | None) -> bool:
        """Gather every rank's fetched ranges onto rank 0, which promotes
        the staging dir to ``final`` when every rank restored (``final``
        None: this one failed) and the union covers the manifest, else
        deletes it; returns the agreed outcome."""
        state = self._active.get(staged)
        mine = None if final is None or state is None else {
            p: ivs._ivs for p, ivs in state["fetched"].items()}
        every = self.group.allgather(mine, self.group.rank)
        failed = [r for r, f in enumerate(every) if f is None]
        outcome = None
        if self.group.rank == 0:
            if failed:
                self._drop(staged)
                outcome = ("failed", failed)
            else:
                fetched = state["fetched"]
                for theirs in every[1:]:
                    for path, ivs in theirs.items():
                        merged = fetched.setdefault(path, _IntervalSet())
                        for lo, hi in ivs:
                            merged.add(lo, hi)
                outcome = ("promoted" if super().finish(staged, final)
                           else "partial", failed)
        else:
            self._active.pop(staged, None)
        status, failed = self.group.agree(outcome)
        if status == "failed" and final is not None:
            raise RuntimeError(f"the level-1 restore failed on rank(s) "
                               f"{failed}")
        return status == "promoted"

    def finish(self, staged: str, final: str) -> bool:
        return self._exchange(staged, final)

    def discard(self, staged: str) -> None:
        """This rank's restore failed: tell the peers (they raise), and
        rank 0 deletes the staging dir. Nothing to tell when the failure
        was the exchange's own (``finish`` raising a peer's failure)."""
        if staged in self._active:
            self._exchange(staged, None)

    def _drop(self, staged: str) -> None:
        self._active.pop(staged, None)
        if self.group.rank == 0:
            super().discard(staged)

    def close(self) -> None:
        """No collective here: rank 0 deletes what is still staged (a
        restore interrupted between ``begin`` and ``finish``)."""
        for staged in list(self._active):
            self._drop(staged)
        if self._owns_transfer:
            self.transfer.close()


class GroupMultiLevelCheckpointer(MultiLevelCheckpointer):
    """One rank's handle on a two-level checkpoint of a ``torch.distributed``
    group: level 0 is the group checkpoint of ``process_group_manager``,
    level 1 gets one flush per committed step, from rank 0. ``group``: the
    process group of the save (None: the default group); ``engine``,
    ``config`` and ``mgr_kw`` go to the level-0 manager."""

    def __init__(self, local_dir: str, remote_dir: str, group=None, *,
                 engine: str = "aggregated", config=None, **mgr_kw):
        # the base class's state around a group manager in place of its
        # single-process one (whose startup GC every rank would run), with
        # the base's default transfer engine; no copy_fn path
        self.local = process_group_manager(local_dir, group, engine=engine,
                                           config=config, **mgr_kw)
        self.group: DistGroup = self.local.coordinator.group
        self.remote_dir = os.path.abspath(remote_dir)
        if self.group.rank == 0:
            os.makedirs(self.remote_dir, exist_ok=True)
        self.group.barrier()
        self.copy_fn = None
        self.transfer = TieredTransferEngine()
        self.local.prefetcher = GroupRestorePrefetcher(
            self.remote_dir, self.group, self.transfer)
        self._flush_thread: threading.Thread | None = None
        self._flush_error: BaseException | None = None
        self._flush_pending = False     # the same on every rank
        self.last_flush_stats = FlushStats()

    def save(self, step: int, state, **kw):
        """Every rank saves its windows into the group checkpoint; once
        rank 0 has published it, rank 0 flushes it to level 1 in the
        background."""
        self.wait()
        metrics = self.local.save(step, state, **kw)   # level 0, all ranks
        self.local.wait()
        self._flush_pending = True
        if self.group.rank == 0:
            th = threading.Thread(target=self._flush_guarded, args=(step,),
                                  daemon=True, name=f"l1-flush-{step}")
            self._flush_thread = th
            th.start()
        return metrics

    def wait(self) -> None:
        """Wait for the level-1 flush; its outcome is agreed over the
        group, so a failed flush raises on every rank."""
        if not self._flush_pending:
            return
        self._flush_pending = False
        err = None
        if self.group.rank == 0:
            try:
                super().wait()
            except RuntimeError as e:
                err = e
        failed = self.group.agree(
            None if err is None else repr(err.__cause__ or err))
        if err is not None:
            raise err
        if failed is not None:
            raise RuntimeError(f"level-1 flush failed on rank 0: {failed}")

    def latest_step(self) -> int | None:
        """The newest step at either level, as rank 0 sees the shared
        directories, agreed by every rank."""
        newest = None
        if self.group.rank == 0:
            steps = set(self.local.all_steps()) | set(self._remote_steps())
            newest = max(steps) if steps else None
        return self.group.agree(newest)

    def restore(self, state_template=None, *, step: int | None = None, **kw):
        """Restore ``step`` (default: the agreed newest), from level 0 when
        it is there, else from level 1 through the group prefetcher;
        ``kw`` (``shardings=``, ``window_fn=``) goes to the manager."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoints at any level")
        return self.local.restore(state_template, step=step, **kw)

    def close(self) -> None:
        self.wait()
        self.transfer.close()
        self.local.close()
