"""Concurrent multi-writer checkpointing: N ranks, one directory, one commit.

Counterpart of ``repro.core.multiwriter`` (same protocol, same on-disk
result). The paper frames checkpointing as "many processes, each managing
numerous tensors" contending for the PFS — yet a single
``CheckpointManager`` only ever exercises one writer. This module runs the
concurrency scenario the engine stack was designed for, inside one process
(DESIGN.md §11):

  · ``MultiWriterCheckpointer`` drives N writer ranks as threads, each with
    its OWN ``CheckpointManager``/engine pair sharing one checkpoint
    directory and one shared staging dir per step,
  · ``InProcessGroup`` is the process-group shim: a reusable barrier plus an
    allgather that carries the SINGLE_FILE ``rank_totals`` prefix-sum
    exchange (paper §3.6) — so N ranks write disjoint regions of one file,
  · ``CommitCoordinator`` implements the two-phase rank-0 commit
    (ByteCheckpoint's decoupled per-rank-plan/global-commit): every rank
    flushes + fsyncs its shards and writes ``MANIFEST.rank-{r}``, barriers;
    then rank 0 alone merges the on-disk rank manifests (validated,
    idempotent — ``Manifest.merge``), writes the global ``manifest.json``,
    and atomically publishes the step dir exactly once,
  · elastic restore: an N-rank checkpoint restores bit-identically onto an
    M-rank mesh — ``restore_sharded`` hands each reader rank its
    row-partition window, assembled from the saved shards it intersects by
    the existing ``WindowAssembler`` machinery.

Snapshot semantics differ from the reference, whose ``shard_state`` pulls
every leaf to the host on the blocking path. Here a CUDA leaf is split into
row VIEWS (``t[lo:hi]``, no copy): each rank's manager streams its own D2H
and quantizes its own rows on the card, and with ``async_save``
``wait_snapshotted()`` blocks until every rank has staged its shards — the
barrier a caller honours before mutating the state in place. Host-resident
leaves are copied on the blocking path (async), as the reference does.
Replicated 0-d tensors become host scalars, which ride in the lean object
exactly as the reference's do.

Failure semantics: a rank failing before a barrier aborts the group — peers
unblock with ``MultiWriterAborted`` instead of hanging (a rank whose own
error is a ``MultiWriterAborted`` does not abort again: the reference does,
and can so break a peer still waking from a barrier it passed, losing
rank 0's error) — and the step is never published (the shared ``.tmp-*``
dir is owned by this process, so a later manager's GC leaves it alone until
the owner dies).

``DistGroup`` is the same shim over ``torch.distributed`` (one process per
rank, e.g. the owners of a DTensor's shards): ``process_group_manager``
gives each process a manager that commits through the same protocol.
``NestedDistGroup`` nests the two: N writer threads in each of M processes
(``MultiWriterCheckpointer(process_group=)``), M x N writers in one commit —
each process splits its own DTensor windows over its threads.

``delta=True`` composes per rank: each rank diffs its own shard windows
with the fp128 device fingerprint (DESIGN.md §14) against the prior
merged manifest's kind-matched index, so rank manifests carry the
digest-kind tag and the rank-0 merge preserves it into the v4 manifest.
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from . import faults, trace
from .aggregation import partition_spans
from .checkpoint import CheckpointManager, step_dir_name, write_owner
from .engines import EngineConfig
from .manifest import Manifest
from .pipeline import (dtensor_window, host_resident, is_dtensor,
                       snapshot_copy)
from .serialization import (LocalShard, path_str, tensor_to_numpy,
                            tree_leaves_with_path, tree_map_with_path)


class MultiWriterAborted(RuntimeError):
    """A peer rank failed; this rank's save was aborted, nothing committed."""


def _fanout(n: int, fn, name: str) -> tuple[list, list]:
    """Run ``fn(rank)`` on n threads; returns (results, exceptions) by rank."""
    outs: list = [None] * n
    errs: list[BaseException | None] = [None] * n

    def run(r: int) -> None:
        try:
            outs[r] = fn(r)
        except BaseException as e:
            errs[r] = e

    threads = [threading.Thread(target=run, args=(r,), name=f"{name}{r}")
               for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return outs, errs


class InProcessGroup:
    """Barrier + allgather for N thread-ranks (the process-group shim)."""

    def __init__(self, num_ranks: int):
        if num_ranks < 1:
            raise ValueError("num_ranks must be >= 1")
        self.num_ranks = num_ranks
        self.first_rank = 0
        self._barrier = threading.Barrier(num_ranks)
        self._vals: list = [None] * num_ranks

    def barrier(self) -> None:
        try:
            with trace.span("barrier", tier="commit",
                            attrs={"ranks": self.num_ranks}):
                self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MultiWriterAborted(
                "a peer writer rank failed before the barrier") from None

    def allgather(self, value, rank: int, num_ranks: int | None = None
                  ) -> list:
        """Every rank contributes ``value``; all receive the rank-ordered
        list. Two barrier phases make the exchange reusable round after
        round (no rank may overwrite its slot before all peers read it)."""
        if num_ranks is not None and num_ranks != self.num_ranks:
            raise ValueError(
                f"allgather across {num_ranks} ranks on a "
                f"{self.num_ranks}-rank group")
        self._vals[rank] = value
        self.barrier()
        out = list(self._vals)
        self.barrier()
        return out

    def agree(self, value):
        """The value every rank adopts (threads share one coordinator, so
        the first rank's proposal is already everyone's)."""
        return value

    def rank0_failed(self, failed: bool, rank: int) -> bool:
        """Rank 0's commit outcome, seen by ``rank`` after the phase-2
        barrier (threads share the coordinator's error slot)."""
        return failed

    def begin(self) -> None:
        pass

    def abort(self) -> None:
        """Break the barrier: peers blocked (or arriving) get
        ``MultiWriterAborted`` instead of hanging on a dead rank."""
        self._barrier.abort()

    def reset(self) -> None:
        self._barrier.reset()


class DistGroup:
    """The group shim over an initialised ``torch.distributed`` process
    group: one process per rank, each with its own coordinator. A peer
    that dies mid-save is seen as the backend's collective timeout, not as
    ``MultiWriterAborted``."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.pg = group
        self.num_ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def barrier(self) -> None:
        with trace.span("barrier", tier="commit",
                        attrs={"ranks": self.num_ranks}):
            self._dist.barrier(group=self.pg)

    def allgather(self, value, rank: int, num_ranks: int | None = None
                  ) -> list:
        if num_ranks is not None and num_ranks != self.num_ranks:
            raise ValueError(
                f"allgather across {num_ranks} ranks on a "
                f"{self.num_ranks}-rank group")
        out: list = [None] * self.num_ranks
        self._dist.all_gather_object(out, value, group=self.pg)
        return out

    def agree(self, value):
        return self.allgather(value, self.rank)[0]

    def rank0_failed(self, failed: bool, rank: int) -> bool:
        return bool(self.allgather(failed, rank)[0])

    def abort(self) -> None:
        pass

    def reset(self) -> None:
        pass


class NestedDistGroup:
    """N writer threads in each process of a ``torch.distributed`` group:
    writer rank = process rank x N + thread, ``num_ranks`` = M x N.

    Every group operation (barrier, allgather, ``rank0_failed``) is one
    round: the process's N threads meet at a thread barrier whose action —
    run by exactly one thread — issues one ``all_gather_object`` on the
    group, so each process issues its collectives in the same order. A
    round carries a failure flag: a thread that fails calls ``abort()``,
    which stands in for all its remaining rounds by arriving once as
    failed; every thread of every process then raises
    ``MultiWriterAborted`` from that same round, and none issues another
    collective, so the group stays usable for the next save. (A process
    that dies is seen as the backend's timeout, as in ``DistGroup``.)
    ``agree`` is a process-level call: the coordinator makes it once per
    step, from the thread that runs the save before its writer threads start
    (``MultiWriterCheckpointer._save_all``)."""

    def __init__(self, threads: int, group=None):
        if threads < 1:
            raise ValueError("threads must be >= 1")
        self.dist = DistGroup(group)
        self.threads = threads
        self.num_ranks = self.dist.num_ranks * threads
        self.first_rank = self.dist.rank * threads   # this process's thread 0
        self._lock = threading.Lock()
        self._vals: list = [None] * threads
        self._failed = False       # crlint: guarded-by(_lock)
        self._settled = False      # crlint: guarded-by(_lock)
        self._out: list = []
        self._barrier = threading.Barrier(threads, action=self._exchange)

    def _exchange(self) -> None:
        with self._lock:
            mine = (self._failed, list(self._vals))
            self._failed = False
        self._out = self.dist.allgather(mine, self.dist.rank)

    def _round(self, value=None, rank: int | None = None) -> list:
        """One round: every writer's ``value`` in writer-rank order (each
        thread reads the result before it can reach the next round, whose
        action alone replaces it)."""
        if rank is not None:
            self._vals[rank - self.first_rank] = value
        try:
            with trace.span("barrier", tier="commit",
                            attrs={"ranks": self.num_ranks}):
                self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MultiWriterAborted(
                "a writer thread's group collective failed") from None
        out = self._out
        if any(failed for failed, _ in out):
            raise MultiWriterAborted("a writer thread of the group failed")
        return [v for _, vals in out for v in vals]

    def begin(self) -> None:
        """A new save: its rounds are open again."""
        with self._lock:
            self._settled = False

    def barrier(self) -> None:
        self._round()

    def allgather(self, value, rank: int, num_ranks: int | None = None
                  ) -> list:
        if num_ranks is not None and num_ranks != self.num_ranks:
            raise ValueError(
                f"allgather across {num_ranks} ranks on a "
                f"{self.num_ranks}-rank group")
        return self._round(value, rank)

    def agree(self, value):
        return self.dist.agree(value)

    def rank0_failed(self, failed: bool, rank: int) -> bool:
        out = bool(self._round(failed, rank)[0])
        with self._lock:
            self._settled = True     # the commit's last round
        return out

    def abort(self) -> None:
        """A failed thread's stand-in for its remaining rounds: one round
        flagged as failed (none when the save's last round has passed)."""
        with self._lock:
            if self._settled:
                return
            self._failed = True
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            pass

    def reset(self) -> None:
        self._barrier.reset()
        with self._lock:
            self._failed = False


class CommitCoordinator:
    """Two-phase rank-0 commit over a shared per-step staging dir.

    Phase 1 (every rank, from ``CheckpointManager._commit``): the rank's
    shards are already flushed + fsync'd into the shared tmp dir; write
    ``MANIFEST.rank-{r}``; barrier.
    Phase 2 (rank 0): load the rank manifests OFF DISK (the only channel a
    real multi-host rank 0 has), merge with validation + per-rank
    idempotency, write the global ``manifest.json``, publish the step dir
    with the manager's atomic displaced-aside rename — exactly once — and GC
    old steps. A second barrier releases the peers only after the publish,
    so every rank's ``save`` returns with the checkpoint durable.
    """

    def __init__(self, group):
        self.group = group
        self._lock = threading.Lock()
        # crlint: guarded-by(_lock)
        self._tmp: dict[int, str] = {}          # step -> shared staging dir
        self._err: BaseException | None = None

    def tmp_dir(self, directory: str, step: int) -> str:
        """The step's shared staging dir; first rank in creates + owns it."""
        with self._lock:
            tmp = self._tmp.get(step)
            if tmp is None:
                tmp = os.path.join(directory, self.group.agree(
                    f"{step_dir_name(step)}.tmp-mw-{uuid.uuid4().hex[:8]}"))
                os.makedirs(tmp, exist_ok=True)
                write_owner(tmp)
                self._tmp[step] = tmp
            return tmp

    def discard(self, step: int) -> None:
        """Drop (and delete) a failed save's shared staging dir so a retry
        of the step starts clean instead of committing stale files."""
        with self._lock:
            tmp = self._tmp.pop(step, None)
        if tmp is not None:
            faults.rmtree(tmp, ignore_errors=True)

    def commit(self, mgr: CheckpointManager, manifest: Manifest, tmp: str,
               step: int, rank: int) -> None:
        with trace.span("commit.phase1", tier="commit",
                        attrs={"rank": rank, "step": step}):
            manifest.save_rank(tmp, rank)
            self.group.barrier()         # phase 1: all ranks durable
        if rank == 0:
            try:
                with trace.span("commit.merge", tier="commit",
                                attrs={"step": step}):
                    self._merge_publish(mgr, tmp, step)
            except BaseException as e:
                self._err = e
        self.group.barrier()             # phase 2: publish visible to all
        if self.group.rank0_failed(self._err is not None, rank):
            if rank == 0:
                raise self._err
            raise MultiWriterAborted("rank-0 commit failed") from self._err
        # drop the staging entry only on success — on failure it stays
        # registered so _save_all's discard() can reclaim it (every
        # process's coordinator holds one under a process group)
        with self._lock:
            self._tmp.pop(step, None)

    def _merge_publish(self, mgr: CheckpointManager, tmp: str,
                       step: int) -> None:
        merged = Manifest.load_rank(tmp, 0)
        for r in range(1, self.group.num_ranks):
            merged.merge(Manifest.load_rank(tmp, r), rank=r)
        merged.num_ranks = self.group.num_ranks
        saved = False
        if mgr.delta:
            # delta saves (§12): every rank's manifest described its fresh
            # chunks with step-dir-relative paths; rank 0 relocates the
            # shared data files into the chunkstore and rewrites the MERGED
            # manifest exactly once, before the only publish
            from .delta import publish_packs
            saved = publish_packs(merged, tmp, mgr.directory,
                                  step_dir_name(step))
        if not saved:
            merged.save(tmp)
        mgr._publish(tmp, step)
        mgr._gc_old()
        self._err = None


class GroupCheckpointManager(CheckpointManager):
    """The ``CheckpointManager`` of one rank of a group checkpoint. Its
    startup reap of stale staging dirs runs on rank 0 alone while the other
    ranks wait at a barrier: after the whole group was killed, N fresh
    managers would otherwise reap (and roll back) the same torn dirs at
    once. Retention needs no such care: it runs in rank 0's publish."""

    def __init__(self, directory: str, group: DistGroup, **kw):
        self._startup_group = group
        super().__init__(directory, **kw)

    def _gc_tmp(self) -> None:
        group = self._startup_group
        if group.rank == 0:
            super()._gc_tmp()
        if group.num_ranks > 1:
            group.barrier()


def process_group_manager(directory: str, group=None, *,
                          config: EngineConfig | None = None,
                          **kw) -> CheckpointManager:
    """A ``CheckpointManager`` for one process of an initialised
    ``torch.distributed`` group: every process saves its own shards (its
    DTensor local windows) into one shared checkpoint, and the step commits
    once through the two-phase protocol over ``DistGroup``. All processes
    must create it and call ``save`` together."""
    cfg = replace(config) if config is not None else EngineConfig()
    cfg.truncate = False        # ranks share files under SINGLE_FILE
    dist_group = DistGroup(group)
    mgr = GroupCheckpointManager(directory, dist_group, config=cfg, **kw)
    mgr.coordinator = CommitCoordinator(dist_group)
    mgr.allgather = dist_group.allgather
    return mgr


@dataclass
class MultiSaveMetrics:
    """Aggregate view over the N concurrent rank saves."""
    step: int
    num_ranks: int
    total_bytes: int = 0
    blocking_seconds: float = 0.0    # caller stall (partition + submit)
    end_to_end_seconds: float = 0.0  # slowest rank, incl. the shared commit
    mode: str = "blocking"           # blocking | async
    per_rank: list = field(default_factory=list)   # SaveMetrics per rank

    @property
    def aggregate_gbps(self) -> float:
        """Aggregate write throughput: all ranks' bytes over the concurrent
        wall — the paper's under-contention number."""
        return (self.total_bytes / self.end_to_end_seconds / 1e9
                if self.end_to_end_seconds else 0.0)


def shard_state(state, num_ranks: int, *, snapshot: bool = False
                ) -> list:
    """Partition a global state row-wise into N per-rank states.

    Tensor leaves whose leading dim holds ``num_ranks`` spans become
    ``LocalShard`` windows over row views (one per rank, no copy — each
    rank's save reads its rows, D2H included, on its own thread); short
    tensors are replicated (every rank saves the full window, restore
    dedupes identical windows like DP replicas) and 0-d tensors become host
    scalars, as in the reference. ``snapshot=True`` additionally copies
    every host-resident payload so an async caller may mutate it the moment
    ``save`` returns; device payloads stay views, protected by
    ``MultiWriterCheckpointer.wait_snapshotted``.

    A DTensor leaf contributes this process's window only
    (``pipeline.dtensor_window``): the rows of its LOCAL block are split
    the same way, each piece's index offset by the window's start. A
    replica that is not its window's writer, or an empty block, keeps the
    DTensor leaf, which saves no window.
    """
    flat = tree_leaves_with_path(state)
    per_rank: list[list] = [[] for _ in range(num_ranks)]
    for _path, leaf in flat:
        if not isinstance(leaf, (torch.Tensor, np.ndarray)):
            for lv in per_rank:
                lv.append(leaf)
            continue
        arr = leaf.detach() if isinstance(leaf, torch.Tensor) else leaf
        window = None
        if is_dtensor(arr):
            layout = dtensor_window(arr.device_mesh, arr.placements,
                                    arr.shape)
            local = arr.to_local()
            if arr.ndim and (layout is None or not layout[1]
                             or (not local.numel() and arr.numel())):
                for lv in per_rank:
                    lv.append(arr)     # no window of this process
                continue
            gs, arr = tuple(arr.shape), local
            if arr.ndim:
                window = layout[0]
        if arr.ndim == 0:
            scalar = arr
            if isinstance(arr, torch.Tensor):
                # a private host copy, read-only as ``np.asarray`` of a
                # device array is (the lean blob pickles the flag)
                scalar = np.array(tensor_to_numpy(arr), copy=True)
                scalar.flags.writeable = snapshot
            elif snapshot:
                scalar = np.array(arr, copy=True)
            for lv in per_rank:
                lv.append(scalar)  # rides in the lean object, as the ref's
            continue
        if snapshot and host_resident(arr):
            arr = snapshot_copy(arr)
        if window is None:
            gs = tuple(arr.shape)
            window = tuple((0, d) for d in gs)
        if arr.shape[0] < num_ranks:
            # replicated: the full window on every rank
            leaf = arr if tuple(arr.shape) == gs \
                else LocalShard(arr, window, gs)
            for lv in per_rank:
                lv.append(leaf)
            continue
        start = window[0][0]
        for r, (lo, hi) in enumerate(partition_spans(arr.shape[0],
                                                     num_ranks)):
            idx = ((start + lo, start + hi),) + window[1:]
            per_rank[r].append(LocalShard(arr[lo:hi], idx, gs))
    return [_unflatten(state, lv) for lv in per_rank]


def _unflatten(tree, leaves: list):
    """``tree`` with its leaves (flatten order) replaced by ``leaves``."""
    it = iter(leaves)
    return tree_map_with_path(lambda _p, _x: next(it), tree)


def _caller_stream(state):
    """The caller's current CUDA stream when ``state`` holds a CUDA tensor
    (the rank threads order their reads after it), else None."""
    for _p, leaf in tree_leaves_with_path(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return torch.cuda.current_stream(leaf.device)
    return None


class MultiWriterCheckpointer:
    """Run N writer ranks concurrently (thread-per-rank) over one directory.

    ``save`` takes the GLOBAL state, partitions it across ranks
    (``shard_state``), and drives one blocking ``CheckpointManager.save``
    per rank thread through the shared two-phase commit. ``restore`` runs on
    rank 0's manager with full template support (any single reader can
    restore an N-rank checkpoint — that is the point of the merged
    manifest); ``restore_sharded`` materializes per-reader-rank windows on
    an M-rank mesh. ``mgr_kw`` (``device=`` among them) goes to every
    rank's manager, and to the fresh readers of ``restore_sharded``.

    With ``process_group`` (a ``torch.distributed`` group, e.g. a gloo
    group beside a DeviceMesh's) every process of the group runs its own
    checkpointer of ``num_ranks`` writer threads over its share of the
    state (its DTensor windows) and calls ``save`` together with the
    others: M x N writer ranks commit one step (``NestedDistGroup``), and
    each process's ``restore`` reads its own windows.
    """

    def __init__(self, directory: str, num_ranks: int, *,
                 engine: str = "aggregated",
                 config: EngineConfig | None = None,
                 async_save: bool = False, keep: int = 3,
                 verify_crc: bool = True, streaming: bool = True,
                 process_group=None, **mgr_kw):
        self.directory = os.path.abspath(directory)
        self.num_ranks = num_ranks
        self.async_save = async_save
        self.engine_name = engine
        self.group = (InProcessGroup(num_ranks) if process_group is None
                      else NestedDistGroup(num_ranks, process_group))
        self.coordinator = CommitCoordinator(self.group)
        base = config if config is not None else EngineConfig()
        self._base_config = replace(base)
        self.managers: list[CheckpointManager] = []
        for _r in range(num_ranks):
            cfg = replace(base)
            # ranks share files under SINGLE_FILE: nobody truncates a peer's
            # extents (the tmp dir is fresh per step, so nothing is stale)
            cfg.truncate = False
            kw = dict(engine=engine, config=cfg, async_save=False,
                      keep=keep, verify_crc=verify_crc, streaming=streaming,
                      **mgr_kw)
            # across processes, the startup reap runs on process 0 alone
            mgr = (CheckpointManager(directory, **kw)
                   if process_group is None else
                   GroupCheckpointManager(directory, self.group.dist, **kw))
            mgr.coordinator = self.coordinator
            mgr.allgather = self.group.allgather
            self.managers.append(mgr)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._staged: list[threading.Event] = []
        self.last_save_metrics: MultiSaveMetrics | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state) -> MultiSaveMetrics:
        """Checkpoint the global ``state`` through N concurrent writers.

        The partition (and, async, a stable copy of every host payload)
        happens on the blocking path; with ``async_save`` the N rank flushes
        and the two-phase commit then drain on a driver thread, and device
        payloads are read until ``wait_snapshotted()`` returns."""
        self.wait()
        t0 = trace.clock()
        shards = shard_state(state, self.num_ranks,
                             snapshot=self.async_save)
        stream = _caller_stream(state)
        self._staged = [threading.Event() for _ in range(self.num_ranks)]
        metrics = MultiSaveMetrics(
            step=step, num_ranks=self.group.num_ranks,
            mode="async" if self.async_save else "blocking")
        self.last_save_metrics = metrics
        if self.async_save:
            metrics.blocking_seconds = trace.clock() - t0
            self._error = None
            th = threading.Thread(
                target=self._run_guarded,
                args=(step, shards, metrics, t0, stream),
                daemon=True, name=f"mw-driver-{step}")
            self._thread = th
            th.start()
        else:
            self._save_all(step, shards, metrics, t0, stream)
            metrics.blocking_seconds = metrics.end_to_end_seconds
        return metrics

    def _run_guarded(self, step, shards, metrics, t0, stream) -> None:
        try:
            self._save_all(step, shards, metrics, t0, stream)
        except BaseException as e:
            self._error = e

    def _save_all(self, step, shards, metrics, t0, stream=None) -> None:
        n, base = self.group.num_ranks, self.group.first_rank
        staged = self._staged
        self.group.begin()
        try:
            # the shared staging dir, agreed (a collective under a process
            # group) before any writer thread starts
            self.coordinator.tmp_dir(self.directory, step)
        except BaseException:
            for ev in staged:
                ev.set()
            raise

        def save_rank(t: int):
            # the rank's manager records its producer event on the caller's
            # stream, so its reads of device views follow the caller's work
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            try:
                with ctx:
                    return self.managers[t].save(
                        step, shards[t], rank=base + t, num_ranks=n,
                        on_staged=staged[t].set)
            except MultiWriterAborted:
                # the group knows already (a broken barrier, or rank 0's
                # failed commit seen after the last barrier): aborting
                # again would break a peer still waking from that barrier,
                # and rank 0's own error would be lost
                raise
            except BaseException:
                self.group.abort()   # unblock peers stuck on a barrier
                raise
            finally:
                staged[t].set()      # never leave wait_snapshotted() hanging

        outs, errs = _fanout(self.num_ranks, save_rank, f"mw-rank-{step}")
        if any(errs):
            self.group.reset()       # repair the barrier for the next save
            self.coordinator.discard(step)   # stale staging must not commit
            primary = next((e for e in errs
                            if not isinstance(e, MultiWriterAborted)),
                           next(e for e in errs if e is not None))
            raise RuntimeError(
                f"multi-writer save of step {step} failed") from primary
        metrics.per_rank = [m for m in outs]
        metrics.total_bytes = sum(m.total_bytes for m in outs)
        metrics.end_to_end_seconds = trace.clock() - t0

    def wait_snapshotted(self) -> None:
        """Block until every rank of the in-flight save has staged (copied
        out) its shards: from then on no rank reads the caller's tensors,
        which may be mutated in place while the flushes and the commit
        drain. (The reference needs no barrier: it copies every payload to
        the host on the blocking path.)"""
        for ev in self._staged:
            ev.wait()

    def wait(self) -> None:
        """Block until an in-flight async multi-writer save committed."""
        th = self._thread
        if th is not None:
            th.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async multi-writer save failed") from err

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return self.managers[0].all_steps()

    def latest_step(self) -> int | None:
        return self.managers[0].latest_step()

    @property
    def last_restore_metrics(self):
        return self.managers[0].last_restore_metrics

    def restore(self, state_template=None, *, step: int | None = None, **kw):
        """Single-reader restore of the merged checkpoint (full template /
        DTensor support of ``CheckpointManager.restore``)."""
        self.wait()
        return self.managers[0].restore(state_template, step=step, **kw)

    def restore_sharded(self, num_ranks: int | None = None, *,
                        step: int | None = None):
        """Elastic N→M restore: M reader ranks, each materializing its
        row-partition windows from whatever saved shards intersect them
        (``WindowAssembler`` under the hood), on the managers' device.
        Returns M states whose tensor leaves are ``LocalShard``s (replicated
        leaves come back whole). Readers run concurrently — the
        restore-side contention scenario."""
        self.wait()
        m = num_ranks if num_ranks is not None else self.num_ranks
        outs, errs = _fanout(m, lambda r: self._restore_rank(r, m, step),
                             "mw-read-rank")
        for e in errs:
            if e is not None:
                raise e
        return outs

    def _restore_rank(self, rank: int, num_ranks: int, step: int | None):
        windows: dict[str, tuple] = {}   # key -> (window, global_shape)

        def window_fn(rec):
            gs = tuple(rec.global_shape)
            if len(gs) == 0 or gs[0] < num_ranks:
                w = tuple((0, d) for d in gs)    # replicated: full window
            else:
                lo, hi = partition_spans(gs[0], num_ranks)[rank]
                w = ((lo, hi),) + tuple((0, d) for d in gs[1:])
            windows[rec.key] = (w, gs)
            return [(w, None)]

        # reader ranks beyond the writer count get a fresh manager/engine
        # pair (M > N) on the writers' device; writer ranks reuse their own
        # (restores don't touch the coordinator)
        if rank < len(self.managers):
            mgr, temp = self.managers[rank], False
        else:
            first = self.managers[0]
            mgr, temp = CheckpointManager(
                self.directory, engine=self.engine_name,
                config=replace(self._base_config), async_save=False,
                verify_crc=first.verify_crc, streaming=first.streaming,
                device=first.device), True
        try:
            tree = mgr.restore(step=step, window_fn=window_fn)
        finally:
            if temp:
                mgr.close()
        leaves = []
        for path, leaf in tree_leaves_with_path(tree):
            info = windows.get(path_str(path))
            if info is None or not isinstance(leaf, torch.Tensor):
                leaves.append(leaf)
                continue
            w, gs = info
            if w == tuple((0, d) for d in gs):
                leaves.append(leaf)              # replicated: whole tensor
            else:
                leaves.append(LocalShard(leaf, w, gs))
        return _unflatten(tree, leaves)

    # --------------------------------------------------------------- plumbing
    def close(self) -> None:
        self.wait()
        for mgr in self.managers:
            mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
