"""CheckpointManager — the framework-level checkpoint/restore API.

Implements the paper's full C/R pipeline for states of PyTorch tensors (the
counterpart of ``repro.core.checkpoint``; same on-disk format, one process
on one card in this package):

  save:  tensor extraction + lean-object serialization  (§2 stage 1)
         → device-to-host transfer                      (§2 stage 2)
         → engine flush (async-capable)                 (§2 stage 3)
         → manifest + atomic commit                     (§2 stage 4)

Stages 2–4 run as a STREAMING pipeline (core.pipeline.SnapshotPipeline,
DESIGN.md §9): shards are declared by size, then snapshotted chunk-by-chunk
into pooled aligned buffers and flushed as each extent lands, so D2H,
quant-packing, CRC, and storage writes overlap instead of serializing.
Async saves return after submission — blocking time is planning, not
copying. ``streaming=False`` keeps the legacy full-copy path (benchmarks
compare the two).

  restore: manifest read → lean object → planned (coalesced) tensor reads
           → host-to-device with target sharding (elastic resharding).

The restore runs as the mirror-image STREAMING pipeline
(core.pipeline.RestorePipeline, DESIGN.md §10): extents surface from the
engine's ReadStream as they land and flow through dequantize → window
assembly → device_put per tensor while later tensors' reads are still in
flight, with CRCs verified inside the stream and peak host staging bounded
by ``EngineConfig.inflight_bytes``. ``streaming=False`` keeps the monolithic
read-everything-then-assemble path for A/B.

Versioned layout::

    <root>/step_00000100/manifest.json
                         data/...
    <root>/step_00000200/...

A step directory is valid iff its manifest exists (manifests are written last,
fsync'd, atomically renamed). Crash mid-save leaves a ``.tmp-*`` dir that is
garbage-collected, never restored from.
"""

from __future__ import annotations

import os
import re
import threading
import time
import uuid
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from . import delta as delta_mod
from . import faults, trace
from .aggregation import ObjectSpec, Strategy, rank_padded_total
from .engines import (ChecksumError, EngineConfig, ReadReq, SaveItem,
                      make_cr_engine)
from .manifest import Manifest, ManifestError, crc32_of
from .pipeline import (HostStaging, RestorePipeline, RestoreTask,
                       SnapshotPipeline, build_save_puts, dtensor_window,
                       host_bytes, host_resident, is_dtensor,
                       iter_host_shards)
from .resharding import WindowAssembler, dedupe_shards, plan_window
from .serialization import (LEAN_KEY, deserialize_lean, dtype_name,
                            extract_tensors, is_float_kind, iter_stubs,
                            np_to_torch, reinsert_tensors, serialize_lean,
                            tensor_nbytes, tree_leaves_with_path,
                            tree_map_with_path, path_str)

_STEP_RE = re.compile(r"^step_(\d{8})$")
_ASIDE_RE = re.compile(r"^(step_\d{8})\.tmp-old-")

# in-flight ownership marker inside a .tmp-* dir: "<pid> <epoch>". A tmp dir
# whose owner process is alive is a LIVE save — a second manager (or rank)
# starting up must not GC it out from under the flush.
OWNER_NAME = ".owner.pid"
# ownerless tmp dirs younger than this are assumed mid-creation, not stale
TMP_GRACE_S = 300.0


def step_dir_name(step: int) -> str:
    return f"step_{step:08d}"


def replace_dir(tmp: str, final: str) -> None:
    """Atomically swap ``tmp`` in as ``final`` (the crash-safe publish).

    ``os.replace`` cannot rename over a non-empty dir, and a naive
    rmtree-then-replace leaves a window where a crash loses the PREVIOUS
    version. The old version is renamed aside (still ``.tmp-``-patterned,
    so aside dirs are GC-able), the new one renamed in — retried when a
    concurrent starter's ``_gc_tmp`` rolls a displaced version back in
    between — the parent dir fsync'd, and only then are the displaced
    copies deleted: every point of the sequence leaves a restorable
    version on disk."""
    asides = []
    for _attempt in range(5):
        if os.path.exists(final):
            aside = f"{final}.tmp-old-{uuid.uuid4().hex[:8]}"
            faults.replace(final, aside)
            asides.append(aside)
        try:
            # the publish sources (data files, then manifest) were fsync'd
            # by the engine and Manifest._write before any caller reaches
            # this leaf; only the dir fsync lives here
            # crlint: allow(CRL002): sources fsync'd upstream of this leaf
            faults.replace(tmp, final)
            break
        except (faults.InjectedCrash, faults.InjectedIOError):
            raise      # injected faults must not be absorbed by the retry
        except OSError:
            continue
    else:
        raise OSError(f"could not publish {tmp} over {final}")
    fd = os.open(os.path.dirname(final) or ".", os.O_RDONLY)
    try:
        faults.fsync(fd)
    finally:
        os.close(fd)
    for aside in asides:
        faults.rmtree(aside, ignore_errors=True)


def write_owner(tmp: str) -> None:
    import socket
    with open(os.path.join(tmp, OWNER_NAME), "w") as f:
        # crlint: allow(CRL006): pidfile epoch must be wall-clock (compared
        # against /proc btime by readers on other boots/hosts)
        f.write(f"{os.getpid()} {time.time():.3f} {socket.gethostname()}")


def _proc_start_time(pid: int) -> float | None:
    """Epoch seconds the process with ``pid`` started, via /proc (Linux).
    None when unknowable (no procfs, pid gone, unparsable)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        btime = None
        with open("/proc/stat", "rb") as f:
            for line in f:
                if line.startswith(b"btime "):
                    btime = int(line.split()[1])
                    break
        if btime is None:
            return None
        # split after the last ')': the comm field may itself hold spaces
        fields = stat[stat.rindex(b")") + 2:].split()
        ticks = int(fields[19])           # starttime: overall field 22
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _dir_is_young(path: str) -> bool:
    try:
        # crlint: allow(CRL006): mtime comparison needs the wall clock
        return time.time() - os.path.getmtime(path) < TMP_GRACE_S
    except OSError:
        return False       # vanished concurrently


def tmp_in_flight(path: str) -> bool:
    """True when a .tmp-* dir belongs to a live in-flight save."""
    import socket
    try:
        with open(os.path.join(path, OWNER_NAME)) as f:
            parts = f.read().split()
        pid = int(parts[0])
        host = parts[2] if len(parts) > 2 else None
    except (OSError, ValueError, IndexError):
        # no/illegible owner record: fall back to age
        return _dir_is_young(path)
    if host is not None and host != socket.gethostname():
        # shared-FS dir owned by ANOTHER host: its pids mean nothing to this
        # kernel, so liveness is unknowable here — age is the only signal
        return _dir_is_young(path)
    if pid == os.getpid():
        return True        # another manager/rank in THIS process
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False       # owner died: stale, safe to reap
    except PermissionError:
        pass               # exists, owned by another user: check recycling
    # the pid is alive — but pids recycle. A process that STARTED after the
    # owner record was written cannot be the writer: the owner died and an
    # unrelated process inherited its pid. Only claim staleness when procfs
    # gives a definitive start time; otherwise stay conservative (spare).
    try:
        recorded = float(parts[1])
    except (ValueError, IndexError):
        recorded = None
    if recorded is not None:
        started = _proc_start_time(pid)
        if started is not None and started > recorded + 1.0:
            return False   # recycled pid: the recording save is long dead
    return True


def _dist():
    """``torch.distributed`` when a process group is initialised, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


@dataclass
class SaveMetrics:
    step: int
    total_bytes: int = 0
    written_bytes: int = 0         # bytes submitted to storage (< total when
    #                                delta saves skip clean chunks, §12)
    extract_seconds: float = 0.0   # tensor extraction + lean serialization
    fingerprint_seconds: float = 0.0  # delta: digest every chunk (worker-side)
    diff_seconds: float = 0.0      # delta: diff digests + build chunk refs
    d2h_seconds: float = 0.0       # device→host (staging copy when streaming)
    stage_copy_seconds: float = 0.0  # streaming: memcpy into pooled buffers
    stage_crc_seconds: float = 0.0   # streaming: CRC32 of the put payloads
    d2h_bytes: int = 0             # delta fp128: device bytes that crossed —
    #                                digest tables + dirty-chunk gathers only
    #                                (0 for host-resident sources, whose
    #                                "gathers" are free views)
    flush_seconds: float = 0.0     # engine write + fsync
    commit_seconds: float = 0.0
    blocking_seconds: float = 0.0  # time the training loop was stalled
    end_to_end_seconds: float = 0.0
    chunks_total: int = 0          # delta saves: chunk grid size
    chunks_dirty: int = 0          # delta saves: chunks actually written
    mode: str = "blocking"         # blocking | pipelined | legacy[-async]
    #                                (delta saves get a "delta-" prefix)

    @property
    def hash_seconds(self) -> float:
        """Back-compat: the PR-5 hash+diff wall, now split into
        ``fingerprint_seconds`` + ``diff_seconds``."""
        return self.fingerprint_seconds + self.diff_seconds

    @property
    def flush_gbps(self) -> float:
        return (self.total_bytes / self.flush_seconds / 1e9
                if self.flush_seconds else 0.0)


@dataclass
class RestoreMetrics:
    """Per-stage restore attribution.

    Streaming restores OVERLAP the stages, so the per-stage seconds no
    longer sum to ``end_to_end_seconds`` — ``read_seconds`` is the wall-clock
    span of the read stage (which runs under everything else), while
    ``read_stall_seconds`` is the time the consumer actually waited on
    extents. ``stage_seconds`` and ``overlap_seconds`` report both views.
    """
    step: int
    total_bytes: int = 0
    read_bytes: int = 0             # bytes of the extents this restore read
    read_seconds: float = 0.0       # wall span of the read stage
    read_stall_seconds: float = 0.0  # consumer blocked waiting on extents
    decode_seconds: float = 0.0     # int8 → float dequantization
    assemble_seconds: float = 0.0
    h2d_seconds: float = 0.0        # host→device copies as each extent is
    #                                 fed (not counted under assemble)
    h2d_bytes: int = 0              # bytes those copies moved
    read_copy_seconds: float = 0.0  # streaming: memcpy out of read buffers
    read_crc_seconds: float = 0.0   # streaming: CRC32 of the landed extents
    prefetch_seconds: float = 0.0   # tier-1 → tier-0 extent staging
    end_to_end_seconds: float = 0.0
    peak_staged_bytes: int = 0      # max host bytes staged by the read stream
    mode: str = "monolithic"        # monolithic | streaming

    @property
    def stage_seconds(self) -> float:
        """Sum of the stage walls; exceeds end_to_end when stages overlap."""
        return (self.read_seconds + self.decode_seconds
                + self.assemble_seconds + self.h2d_seconds)

    @property
    def overlap_seconds(self) -> float:
        return max(0.0, self.stage_seconds - self.end_to_end_seconds)


class CheckpointManager:
    """Versioned, engine-pluggable, async-capable checkpointing for states
    of PyTorch tensors (nested dicts / lists / tuples)."""

    def __init__(self, directory: str, engine: str = "aggregated",
                 config: EngineConfig | None = None, *,
                 async_save: bool = False, keep: int | None = 3,
                 verify_crc: bool = True,
                 quantize_prefixes: tuple[str, ...] = (),
                 quantize_min_bytes: int = 1 << 16,
                 streaming: bool = True,
                 eager_snapshot: bool = False,
                 delta: bool = False,
                 delta_chunk_bytes: int = delta_mod.DEFAULT_CHUNK_BYTES,
                 device_fingerprint: bool = True,
                 device="cuda"):
        """``keep``: retain the newest N committed steps (N >= 1); ``None``
        retains every step. ``keep=0`` is rejected — it used to silently
        mean "keep everything", which is what ``None`` now says out loud.

        ``quantize_prefixes``: tensor keys starting with any of these are
        int8-packed on save (e.g. ("opt/mu", "opt/nu") halves AdamW-moment
        flush volume ~4x — see core.quant_codec).

        ``streaming``: route saves through the SnapshotPipeline (D2H, pack,
        CRC and writes overlap; async saves return after submission) and
        restores through the RestorePipeline (read, dequant, assembly and
        H2D overlap; host staging bounded by ``config.inflight_bytes``).
        ``streaming=False`` keeps the legacy full-copy paths on both sides.
        ``eager_snapshot``: async streaming saves clone ALL sources on the
        blocking path (on their own devices); by default only host-resident
        sources (CPU tensors, numpy) are copied, and CUDA tensors are read
        by the pipeline worker — ordered after the caller's stream by a CUDA
        event — until ``wait_snapshotted()`` returns. Torch tensors are
        mutated in place, so a caller must honour that barrier.

        ``delta``: content-addressed delta checkpointing (DESIGN.md §12) —
        each tensor shard is chunked into ``delta_chunk_bytes`` extents and
        hashed on the pipeline worker; only chunks that changed since the
        previous step are written (into the shared ``chunkstore/``), clean
        chunks become manifest references. Requires ``streaming=True``.
        Caveat: the hash/diff pass holds host views of every tensor with a
        dirty chunk until its chunks are staged, so delta-save host
        residency tracks the dirty payload volume rather than the
        ``config.inflight_bytes`` staging bound (free for host-resident
        arrays, a real D2H copy per device array — same as a legacy save).

        ``device_fingerprint`` (delta saves only): fingerprint chunks with
        the fp128 digest where the bytes live (the CUDA kernels for CUDA
        tensors, their plain PyTorch versions for CPU tensors, the
        bit-identical numpy twin for numpy arrays — DESIGN.md §14) and
        D2H-copy only
        dirty chunks, instead of resolving every payload to the host and
        blake2b-hashing it there. Steps written by the two settings key
        the delta index with different digest kinds, so flipping the flag
        mid-run degrades to one full write — never a wrong delta.

        ``device``: where restored tensors go when no template tensor names
        a device (default ``"cuda"``; the CPU only when asked for).
        """
        self.device = torch.device(device)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.engine_name = engine
        # copy on ingest: two managers sharing one config object must not
        # see each other's checksum/strategy mutations
        self.config = replace(config) if config is not None else EngineConfig()
        if verify_crc:
            self.config.checksum = True
        if keep is not None and keep < 1:
            raise ValueError(
                f"keep={keep} would delete every checkpoint as soon as it "
                f"commits; use keep=None to retain all steps, or keep >= 1")
        if delta and not streaming:
            raise ValueError("delta=True requires the streaming save path "
                             "(streaming=True)")
        if delta and delta_chunk_bytes < 1:
            raise ValueError(f"delta_chunk_bytes must be >= 1, "
                             f"got {delta_chunk_bytes}")
        self.engine = make_cr_engine(engine, self.config)
        self.async_save = async_save
        self.keep = keep
        self.verify_crc = verify_crc
        self.delta = delta
        self.delta_chunk_bytes = delta_chunk_bytes
        self.device_fingerprint = device_fingerprint
        # test hook: how long an unreferenced store file is spared by the
        # refcount GC (a publish may not have landed its manifest yet)
        self.delta_gc_grace_s = delta_mod.GC_GRACE_S
        self.last_gc_stats: delta_mod.StoreGCStats | None = None
        self.quantize_prefixes = tuple(quantize_prefixes)
        self.quantize_min_bytes = quantize_min_bytes
        self.streaming = streaming
        self.eager_snapshot = eager_snapshot
        self._staging = HostStaging()
        self._side_stream = None        # (device, worker CUDA stream), lazy
        # Optional tiered.RestorePrefetcher: when set, restore of a step not
        # committed here is staged from the remote tier extent-by-extent.
        self.prefetcher = None
        # Optional multiwriter.CommitCoordinator: when set, _commit runs the
        # two-phase rank-0 protocol (per-rank manifests, merge, one rename)
        # instead of publishing per manager (DESIGN.md §11).
        self.coordinator = None
        # Optional allgather shim: (value, rank, num_ranks) -> list[int],
        # overriding the torch.distributed exchange for in-process writer
        # ranks.
        self.allgather = None
        self._flush_thread: threading.Thread | None = None
        self._flush_error: BaseException | None = None
        self._snapshot_staged: threading.Event | None = None
        self.last_save_metrics: SaveMetrics | None = None
        self.last_restore_metrics: RestoreMetrics | None = None
        self._gc_tmp()

    # ---------------------------------------------------------------- steps
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and Manifest.exists(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _gc_tmp(self) -> None:
        """Reap stale ``.tmp-*`` dirs — but never a live in-flight save's.

        Two guards close the startup races: (1) a displaced previous version
        (``.tmp-old-*``, see ``_publish``) whose final step dir never landed
        is RECOVERED, not deleted — a crash inside the publish window cannot
        lose the prior checkpoint; (2) a tmp dir owned by a live process
        (ownership pidfile; young-dir age as fallback) is another manager's
        or rank's save mid-flush and is left alone."""
        for name in os.listdir(self.directory):
            if ".tmp-" not in name:
                continue
            full = os.path.join(self.directory, name)
            m = _ASIDE_RE.match(name)
            if m:
                final = os.path.join(self.directory, m.group(1))
                if Manifest.exists(full) and not os.path.exists(final):
                    try:
                        # rollback of an already-durable displaced aside;
                        # recovery is idempotent — a crash here just re-runs
                        # this scan on the next startup
                        # crlint: allow(CRL002): idempotent startup rollback
                        faults.replace(full, final)  # publish crashed: roll back
                        continue
                    except (faults.InjectedCrash, faults.InjectedIOError):
                        raise   # never absorb injected faults (PR-6 class)
                    except OSError:
                        # a LIVE publisher landed the new version between our
                        # exists() check and the rename; if final is still
                        # missing, keep the aside for the next startup
                        if not os.path.exists(final):
                            continue
            elif tmp_in_flight(full):
                continue
            faults.rmtree(full, ignore_errors=True)

    def _make_tmp(self, step: int) -> str:
        """Create (or join, under a coordinator) the step's staging dir."""
        if self.coordinator is not None:
            return self.coordinator.tmp_dir(self.directory, step)
        tmp = os.path.join(
            self.directory,
            f"{step_dir_name(step)}.tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp, exist_ok=True)
        write_owner(tmp)
        return tmp

    def _gc_old(self) -> None:
        """Retention GC: drop steps beyond ``keep`` (None = retain all),
        then reap chunkstore files no kept step references (refcount-aware,
        DESIGN.md §12 — runs whenever a store exists, so a non-delta manager
        sharing the directory still converges it).

        The store pass walks every pack and re-parses every kept manifest,
        so it only runs when it can have new work: a step was dropped just
        now, or this manager's first pass (converging orphans a crashed
        publish left behind) — not on every commit of a ``keep=None`` run.
        """
        dropped = 0
        if self.keep is not None:
            for s in self.all_steps()[:-self.keep]:
                faults.rmtree(os.path.join(self.directory, step_dir_name(s)),
                              ignore_errors=True)
                dropped += 1
        if (dropped or self.last_gc_stats is None) and (
                self.delta or os.path.isdir(
                    os.path.join(self.directory, delta_mod.CHUNKSTORE_DIR))):
            self.last_gc_stats = delta_mod.gc_store(
                self.directory, grace_s=self.delta_gc_grace_s)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, *, rank: int | None = None,
             num_ranks: int | None = None, on_staged=None) -> SaveMetrics:
        """Checkpoint ``state``.

        Streaming (default): D2H snapshot, quant-packing, CRC and storage
        writes overlap per extent; async mode returns after submission.
        Legacy (``streaming=False``): full host copy first, flush after.

        ``on_staged()`` is called once the save no longer reads ``state``
        (every source byte staged or copied) — the multi-writer snapshot
        barrier waits on it for every rank."""
        self.wait()  # at most one checkpoint in flight
        t_start = trace.clock()
        dist = _dist()
        if rank is None:
            rank = dist.get_rank() if dist is not None else 0
        if num_ranks is None:
            num_ranks = dist.get_world_size() if dist is not None else 1
        if self.streaming:
            mode = "pipelined" if self.async_save else "blocking"
            if self.delta:
                mode = f"delta-{mode}"
        else:
            mode = "legacy-async" if self.async_save else "legacy"
        metrics = SaveMetrics(step=step, mode=mode)

        # Stage 1: tensor extraction + lean-object serialization.
        t0 = trace.clock()
        tensors, lean_tree = extract_tensors(state)
        lean_blob = serialize_lean(lean_tree)
        t1 = trace.clock()
        metrics.extract_seconds = t1 - t0
        trace.complete("extract", t0, t1, attrs={"step": step})

        if self.streaming:
            self._save_streaming(step, tensors, lean_blob, rank, num_ranks,
                                 metrics, t_start, on_staged)
        else:
            self._save_legacy(step, tensors, lean_blob, rank, num_ranks,
                              metrics, t_start, on_staged)
        self.last_save_metrics = metrics
        return metrics

    def _save_streaming(self, step, tensors, lean_blob, rank, num_ranks,
                        metrics, t_start, on_staged=None) -> None:
        """Pipelined save: declare sizes, then snapshot→stage→flush overlap.

        Blocking portion = spec building + prefix-sum + (for async) eager
        copies of in-place-mutable sources; every byte of D2H and packing
        runs on the pipeline worker, interleaved with the engine's writes.
        """
        puts, quantized_keys = build_save_puts(
            tensors, lean_blob,
            quantize_prefixes=self.quantize_prefixes,
            quantize_min_bytes=self.quantize_min_bytes,
            copy_mutable=self.async_save,
            copy_all=self.async_save and self.eager_snapshot)
        metrics.total_bytes = sum(p.spec.nbytes for p in puts)

        # Cross-rank prefix sum for the single-file layout (paper §3.6) —
        # spec sizes are exact (packed sizes are deterministic), so the
        # exchange happens before any payload is materialized. Delta saves
        # only know their dirty set after the worker-side hash pass, so the
        # exchange moves into the worker (every rank reaches it from its own
        # save thread, DESIGN.md §12).
        rank_totals = None
        if not self.delta:
            rank_totals = self._single_file_totals(puts, rank, num_ranks)

        tmp = self._make_tmp(step)
        pipeline = SnapshotPipeline(self.engine, self._staging)
        produced = self._producer_event(tensors)

        staged = threading.Event()

        def mark_staged():
            staged.set()
            if on_staged is not None:
                on_staged()

        def run():
            try:
                with trace.span("save", nbytes=metrics.total_bytes,
                                attrs={"step": step, "mode": metrics.mode}), \
                        self._worker_stream(produced):
                    self._run_streaming_flush(step, puts, rank, num_ranks,
                                              rank_totals, metrics, t_start,
                                              quantized_keys, tmp, pipeline,
                                              mark_staged)
            finally:
                mark_staged()  # never leave wait_snapshotted() hanging

        if self.async_save:
            metrics.blocking_seconds = trace.clock() - t_start
            self._flush_error = None
            self._snapshot_staged = staged
            th = threading.Thread(target=self._guard(run), daemon=True,
                                  name=f"ckpt-pipeline-{step}")
            self._flush_thread = th
            th.start()
        else:
            run()
            metrics.blocking_seconds = metrics.end_to_end_seconds

    def _producer_event(self, tensors):
        """(event, device): a CUDA event recorded on the caller's current
        stream, so the worker reads CUDA sources only after the work that
        produced them (None when the state holds no CUDA tensor)."""
        dev = next((t.device for t in tensors.values()
                    if isinstance(t, torch.Tensor) and t.is_cuda), None)
        if dev is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev, dev

    def _worker_stream(self, produced):
        """Context for the pipeline worker: its own CUDA stream, waiting on
        the producer's event. Every D2H copy on it is synchronised before
        its bytes are used, so ``staged`` fires only after the snapshot is
        complete."""
        import contextlib
        if produced is None:
            return contextlib.nullcontext()
        ev, dev = produced
        if self._side_stream is None or self._side_stream[0] != dev:
            self._side_stream = (dev, torch.cuda.Stream(device=dev))
        stream = self._side_stream[1]
        stream.wait_event(ev)
        return torch.cuda.stream(stream)

    def _run_streaming_flush(self, step, puts, rank, num_ranks, rank_totals,
                             metrics, t_start, quantized_keys, tmp, pipeline,
                             mark_staged) -> None:
        run_puts, plan = puts, None
        totals = rank_totals
        if self.delta:
            # fingerprint + diff on the worker: zero blocking cost
            plan = delta_mod.plan_delta(
                puts, self._load_delta_index(),
                chunk_bytes=self.delta_chunk_bytes,
                checksum=self.config.checksum,
                device_fingerprint=self.device_fingerprint)
            metrics.fingerprint_seconds = plan.fingerprint_seconds
            metrics.diff_seconds = plan.diff_seconds
            metrics.d2h_bytes = plan.d2h_bytes
            metrics.chunks_total = plan.chunks_total
            metrics.chunks_dirty = plan.chunks_dirty
            run_puts = plan.puts
            totals = self._single_file_totals(run_puts, rank, num_ranks)
        t1 = trace.clock()
        manifest = pipeline.run(tmp, run_puts, step=step, rank=rank,
                                num_ranks=num_ranks, rank_totals=totals,
                                on_staged=mark_staged)
        metrics.flush_seconds = trace.clock() - t1
        st = self.engine.last_save_stats
        metrics.d2h_seconds = st.copy_seconds + st.alloc_seconds
        metrics.stage_copy_seconds = st.copy_seconds
        metrics.stage_crc_seconds = getattr(st, "crc_seconds", 0.0)
        if plan is not None:
            manifest = delta_mod.apply_plan(manifest, plan)
            metrics.written_bytes = plan.written_bytes
        else:
            metrics.written_bytes = metrics.total_bytes
        self._commit(manifest, tmp, step, quantized_keys, metrics, t_start,
                     rank=rank)

    def _save_legacy(self, step, tensors, lean_blob, rank, num_ranks,
                     metrics, t_start, on_staged=None) -> None:
        """Monolithic save: full host copy (and quant-packing) inline on the
        blocking path, then a one-shot engine flush (async: on a thread).
        Kept for A/B benchmarking against the pipelined path."""
        # Stage 2: device→host. Shards owned by this process; DP replicas
        # deduplicated by replica_id == 0.
        t0 = trace.clock()
        items: list[SaveItem] = []
        quantized_keys: list[str] = []
        for key, t in tensors.items():
            quant = (any(key.startswith(p) for p in self.quantize_prefixes)
                     and tensor_nbytes(t) >= self.quantize_min_bytes
                     and is_float_kind(t.dtype))
            if quant:
                quantized_keys.append(key)
            for n, (data, index) in enumerate(iter_host_shards(t)):
                if quant:
                    from . import quant_codec
                    payload = quant_codec.pack(data)
                else:
                    payload = host_bytes(data)
                    if self.async_save and host_resident(data):
                        payload = payload.copy()  # stable snapshot
                items.append(SaveItem(f"{key}#{n}", payload,
                                      dtype_name(data.dtype), tuple(t.shape),
                                      index, record_key=key))
        items.append(SaveItem(LEAN_KEY, lean_blob, is_blob=True))
        metrics.d2h_seconds = trace.clock() - t0
        if on_staged is not None:
            on_staged()             # every payload is a host copy now
        metrics.total_bytes = sum(it.nbytes for it in items)
        metrics.written_bytes = metrics.total_bytes

        # Cross-rank prefix sum for the single-file layout (paper §3.6).
        rank_totals = None
        if Strategy.parse(self.config.strategy) is Strategy.SINGLE_FILE:
            local_total = rank_padded_total(
                [ObjectSpec(i.key, i.nbytes) for i in items], self.config.align)
            rank_totals = self._allgather_totals(local_total, rank, num_ranks)

        tmp = self._make_tmp(step)

        def flush():
            with trace.span("save", nbytes=metrics.total_bytes,
                            attrs={"step": step, "mode": metrics.mode}):
                t1 = trace.clock()
                with trace.span("flush", tier="level0",
                                nbytes=metrics.total_bytes):
                    manifest = self.engine.save(tmp, items, step=step,
                                                rank=rank,
                                                num_ranks=num_ranks,
                                                rank_totals=rank_totals)
                metrics.flush_seconds = trace.clock() - t1
                self._commit(manifest, tmp, step, quantized_keys, metrics,
                             t_start, rank=rank)

        if self.async_save:
            metrics.blocking_seconds = trace.clock() - t_start
            self._flush_error = None
            th = threading.Thread(target=self._guard(flush), daemon=True,
                                  name=f"ckpt-flush-{step}")
            self._flush_thread = th
            th.start()
        else:
            flush()
            metrics.blocking_seconds = metrics.end_to_end_seconds

    def _commit(self, manifest, tmp, step, quantized_keys, metrics,
                t_start, rank: int = 0) -> None:
        """Manifest write + atomic publish + GC (paper §2 stage 4).

        Under a multi-writer ``coordinator`` this becomes phase 1 + the
        rank-0 phase 2 of the two-phase commit (DESIGN.md §11); the step dir
        is renamed exactly once, by rank 0."""
        t2 = trace.clock()
        with trace.span("commit", tier="level0", attrs={"step": step}):
            manifest.extra["save_metrics"] = {
                "total_bytes": metrics.total_bytes,
                "written_bytes": metrics.written_bytes,
                "flush_seconds": metrics.flush_seconds,
            }
            if quantized_keys:
                manifest.extra["quantized"] = quantized_keys
            if self.coordinator is not None:
                self.coordinator.commit(self, manifest, tmp, step, rank)
            else:
                saved = False
                if self.delta:
                    # relocate fresh chunk/blob files into the shared store
                    # and rewrite the manifest's references BEFORE it is
                    # written — a published manifest never points into a
                    # GC-able step dir
                    saved = delta_mod.publish_packs(manifest, tmp,
                                                    self.directory,
                                                    step_dir_name(step))
                if not saved:
                    manifest.save(tmp)
                self._publish(tmp, step)
                self._gc_old()
        metrics.commit_seconds = trace.clock() - t2
        metrics.end_to_end_seconds = trace.clock() - t_start

    def _publish(self, tmp: str, step: int) -> None:
        """Atomically swap ``tmp`` in as the step dir (``replace_dir``;
        ``_gc_tmp`` rolls a displaced-but-never-replaced version back, so a
        crash anywhere in the sequence leaves a restorable checkpoint)."""
        try:
            os.remove(os.path.join(tmp, OWNER_NAME))
        except OSError:
            pass
        replace_dir(tmp, os.path.join(self.directory, step_dir_name(step)))

    def _guard(self, fn):
        def wrapped():
            try:
                fn()
            except BaseException as e:  # surfaced on next wait()/save()
                self._flush_error = e
        return wrapped

    def wait_snapshotted(self) -> None:
        """Block until the in-flight async save holds a stable snapshot —
        every source byte staged into pooled buffers (or copied). Callers
        that mutate IN PLACE or DONATE the arrays they saved must call this
        before doing so; the flush keeps draining in the background.
        Torch tensors are mutated in place, so a trainer calls this before
        every ``optimizer.step()`` that follows an async save."""
        ev = self._snapshot_staged
        if ev is not None:
            ev.wait()

    def wait(self) -> None:
        """Block until any in-flight async flush committed."""
        th = self._flush_thread
        if th is not None:
            th.join()
            self._flush_thread = None
        self._snapshot_staged = None
        if self._flush_error is not None:
            err, self._flush_error = self._flush_error, None
            raise RuntimeError("async checkpoint flush failed") from err

    # -------------------------------------------------------------- restore
    def restore(self, state_template=None, *, step: int | None = None,
                shardings=None, window_fn=None):
        """Restore a checkpoint.

        ``state_template``: a state of like-shaped tensors whose devices
        define where each restored tensor goes (a leaf that is no tensor, or
        a ``meta`` tensor, goes to the manager's ``device``; a DTensor
        leaf gets this rank's window, as a DTensor of its layout). When
        None, every tensor goes to the manager's ``device``, in the saved
        tree structure (using the lean object).

        ``shardings``: {``path_str`` key: layout} — a layout is anything
        with ``mesh`` and ``placements`` (``sharding.partition.Layout``),
        or a ``(DeviceMesh, placements)`` pair. A key's layout takes precedence
        over its template leaf's: this rank's window of it is read and
        comes back as a DTensor of that layout (so a ``meta`` template with
        ``shardings`` restores straight into DTensors).

        ``window_fn(record) -> [(window, device_or_None), ...]`` overrides
        the per-tensor wanted windows of every key that ``shardings`` does
        not name: with both, a server swaps in a training checkpoint's
        params at its own layouts (``shardings``, each rank reading only its
        windows) while ``window_fn`` gives the rest (the optimizer moments)
        empty windows, so none of their bytes are read. The reference's
        ``window_fn`` overrides every key (``repro/core/checkpoint.py:732``).

        When ``step`` is None, a step whose manifest is truncated/corrupt
        (``ManifestError``) is skipped and the next-older step restored; an
        explicitly requested step propagates the error.
        """
        if step is not None:
            return self._restore_step(step, state_template, shardings,
                                      window_fn)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: ManifestError | None = None
        for s in reversed(steps):
            try:
                return self._restore_step(s, state_template, shardings,
                                          window_fn)
            except ManifestError as e:
                last_err = e   # corrupt manifest: fall back to older step
        raise last_err

    def _restore_step(self, step: int, state_template, shardings,
                      window_fn):
        t_start = trace.clock()
        ckpt = os.path.join(self.directory, step_dir_name(step))
        prefetch = None
        if self.prefetcher is not None and not Manifest.exists(ckpt):
            # level-1 → level-0 prefetch: stage manifest + lean extents now,
            # tensor extents once the read plan is known (DESIGN.md §8.3)
            staged = self.prefetcher.begin(step, self.directory)
            if staged is not None:
                ckpt, prefetch = staged, self.prefetcher
        try:
            with trace.span("restore", attrs={"step": step}):
                return self._restore_from(ckpt, step, state_template,
                                          prefetch, t_start, shardings,
                                          window_fn)
        except BaseException:
            if prefetch is not None:
                prefetch.discard(ckpt)
            raise

    def _restore_from(self, ckpt, step, state_template, prefetch, t_start,
                      shardings=None, window_fn=None):
        manifest = Manifest.load(ckpt)
        faults.check_quarantined(ckpt, manifest)
        metrics = RestoreMetrics(
            step=step, mode="streaming" if self.streaming else "monolithic")

        # lean object first (its stubs define the saved tree)
        lean_rec = manifest.blobs[LEAN_KEY]
        lean_raw = self.engine.read(
            ckpt, [ReadReq(LEAN_KEY, lean_rec.path, lean_rec.offset,
                           lean_rec.nbytes)])[LEAN_KEY]
        self._check_crc(lean_rec.crc32, lean_raw, LEAN_KEY,
                        lean_rec.path, lean_rec.offset)
        lean_tree = deserialize_lean(lean_raw.tobytes())

        # decide the wanted windows per tensor
        wanted: dict[str, list[tuple]] = {}   # key -> [(window, device|None)]
        template_by_key: dict[str, object] = {}
        if state_template is not None:
            template_by_key = _template_tensors(state_template)
        # key -> (mesh, placements) of every leaf restored as a DTensor
        layouts = {k: (t.device_mesh, t.placements)
                   for k, t in template_by_key.items() if is_dtensor(t)}
        named = {k: _layout_of(v) for k, v in (shardings or {}).items()}
        layouts.update(named)
        # the leaves read at a layout, and restored as DTensors of it
        laid = named if window_fn is not None else layouts
        for stub in iter_stubs(lean_tree):
            rec = manifest.tensors[stub.key]
            if window_fn is not None and stub.key not in named:
                shard_list = [(w, torch.device(d) if d is not None
                               else self.device) for w, d in window_fn(rec)]
            else:
                shard_list = self._target_windows(
                    rec, template_by_key.get(stub.key), laid.get(stub.key))
            wanted[stub.key] = shard_list

        qset = set(manifest.extra.get("quantized", ()))
        if self.streaming:
            out_tensors = self._restore_streaming(
                ckpt, manifest, lean_tree, wanted, qset, prefetch, metrics)
        else:
            out_tensors = self._restore_monolithic(
                ckpt, manifest, lean_tree, wanted, qset, prefetch, metrics)

        metrics.total_bytes = sum(
            s.nbytes for r in manifest.tensors.values() for s in r.shards)
        if prefetch is not None:
            # full-coverage prefetch commits the step at this tier; a
            # partial (resharded) one stays staged and is discarded
            prefetch.finish(ckpt, os.path.join(self.directory,
                                               step_dir_name(step)))
        for key, layout in laid.items():
            if key in out_tensors:
                out_tensors[key] = _as_dtensor(
                    out_tensors[key], *layout,
                    manifest.tensors[key].global_shape)
        metrics.end_to_end_seconds = trace.clock() - t_start
        self.last_restore_metrics = metrics
        state = reinsert_tensors(lean_tree, out_tensors)
        if template_by_key or layouts:
            state = tree_map_with_path(
                lambda p, x: self._lean_as_template(
                    x, template_by_key.get(path_str(p)),
                    layouts.get(path_str(p))), state)
        return state

    def _lean_as_template(self, leaf, tmpl, layout=None):
        """A 0-d array that rode in the lean object (the multi-writer
        save's replicated scalars, as in the reference) comes back as a
        tensor where the template holds one, on the template's device — or
        as a DTensor where ``layout`` (mesh, placements) is given."""
        if not isinstance(leaf, (np.ndarray, np.generic)):
            return leaf
        if layout is not None:
            arr = np.asarray(leaf)
            return _as_dtensor(np_to_torch(arr, mesh_device(layout[0])),
                               *layout, arr.shape)
        if not isinstance(tmpl, torch.Tensor) or is_dtensor(tmpl):
            return leaf
        device = tmpl.device if tmpl.device.type != "meta" else self.device
        return np_to_torch(np.asarray(leaf), device)

    def _restore_streaming(self, ckpt, manifest, lean_tree, wanted, qset,
                           prefetch, metrics) -> dict[str, object]:
        """Pipelined restore (DESIGN.md §10): extents stream per tensor
        through dequant → window assembly → device placement while later
        tensors' reads are in flight; CRCs verify inside the stream."""
        tasks = []
        crcs: dict[str, int] | None = None
        for stub in iter_stubs(lean_tree):
            rec = _deduped(manifest.tensors[stub.key])
            tasks.append(RestoreTask(stub.key, rec, wanted[stub.key],
                                     quantized=stub.key in qset))
        if self.verify_crc:
            # chunked shards (delta, §12) verify per chunk in-stream, plus a
            # whole-payload CRC under the entry's synthetic key (checked by
            # the pipeline after reassembly)
            crcs = {}
            for t in tasks:
                for sh in t.record.shards:
                    refs = (sh.chunks or ()) if delta_mod.is_chunked(sh) \
                        else (sh,)
                    for r in refs:
                        if r.crc32 is not None:
                            crcs[f"{t.key}@{r.path}@{r.offset}"] = r.crc32
                    if delta_mod.is_chunked(sh) and sh.crc32 is not None:
                        crcs[f"{t.key}@{sh.path}@{sh.offset}"] = sh.crc32
        def on_reqs(reqs):
            metrics.read_bytes = sum(r.nbytes for r in reqs)
            if prefetch is not None:   # pull exactly the planned extents
                t0 = trace.clock()
                prefetch.fetch_extents(ckpt, reqs)
                metrics.prefetch_seconds = trace.clock() - t0
        return RestorePipeline(self.engine).run(
            ckpt, tasks, crcs=crcs, place=self._place, on_reqs=on_reqs,
            metrics=metrics)

    def _place(self, task: RestoreTask, windows: dict) -> object:
        """Final leaf from assembled windows: each window was assembled on
        its device already; the first one is the leaf (a process holds one
        window of a tensor — its DTensor local shard, wrapped after)."""
        return windows[tuple(task.windows[0][0])]

    def _restore_monolithic(self, ckpt, manifest, lean_tree, wanted, qset,
                            prefetch, metrics) -> dict[str, object]:
        """Legacy restore: every extent materialized in host memory (peak =
        full checkpoint), then verify → assemble → H2D serially. Kept as
        ``streaming=False`` for A/B benchmarking."""
        t0 = trace.clock()
        extent_reqs: dict[tuple[str, str, int], ReadReq] = {}
        chunked: dict[tuple[str, str, int], object] = {}  # delta entries
        for key, windows in wanted.items():
            rec = _deduped(manifest.tensors[key])
            for window, _dev in windows:
                for piece in plan_window(rec, window):
                    sh = piece.shard
                    if delta_mod.is_chunked(sh):
                        # chunk-reference shard (§12): read the real chunk
                        # extents; the payload is reassembled below under
                        # the entry's synthetic (path, offset) identity
                        chunked.setdefault((key, sh.path, sh.offset), sh)
                        for r in sh.chunks or ():
                            extent_reqs.setdefault(
                                (key, r.path, r.offset),
                                ReadReq(f"{key}@{r.path}@{r.offset}", r.path,
                                        r.offset, r.nbytes, obj=key))
                        continue
                    extent_reqs.setdefault(
                        (key, sh.path, sh.offset),
                        ReadReq(f"{key}@{sh.path}@{sh.offset}", sh.path,
                                sh.offset, sh.nbytes, obj=key))
        if prefetch is not None:   # pull exactly the planned extents
            tp = trace.clock()
            prefetch.fetch_extents(ckpt, list(extent_reqs.values()))
            metrics.prefetch_seconds = trace.clock() - tp
            t0 = trace.clock()
        raw = self.engine.read(ckpt, list(extent_reqs.values()))
        metrics.read_bytes = sum(r.nbytes for r in extent_reqs.values())
        metrics.read_seconds = trace.clock() - t0
        metrics.read_stall_seconds = metrics.read_seconds
        metrics.peak_staged_bytes = sum(
            req.nbytes for req in extent_reqs.values())
        extent_bytes = {eo: raw[req.key] for eo, req in extent_reqs.items()}
        for (key, spath, soff), sh in chunked.items():
            extent_bytes[(key, spath, soff)] = delta_mod.reassemble_payload(
                sh,
                lambda r, k=key: extent_bytes[(k, r.path, r.offset)],
                lambda r, b, k=key: self._check_crc(r.crc32, b, k, r.path,
                                                    r.offset))
        if self.verify_crc:
            self._verify_extents(manifest, extent_bytes)

        # assemble + device placement
        t0 = trace.clock()
        out_tensors: dict[str, object] = {}
        for stub in iter_stubs(lean_tree):
            rec = _deduped(manifest.tensors[stub.key])
            out_tensors[stub.key] = self._materialize(
                rec, wanted[stub.key], extent_bytes, metrics,
                quantized=stub.key in qset)
        metrics.assemble_seconds = (trace.clock() - t0
                                    - metrics.h2d_seconds
                                    - metrics.decode_seconds)
        return out_tensors

    # ------------------------------------------------------------- internals
    def _single_file_totals(self, puts, rank: int,
                            num_ranks: int) -> list[int] | None:
        """SINGLE_FILE prefix-sum exchange over the declared put sizes
        (paper §3.6); None for the other layouts."""
        if Strategy.parse(self.config.strategy) is not Strategy.SINGLE_FILE:
            return None
        local_total = rank_padded_total(
            [ObjectSpec(p.spec.key, p.spec.nbytes) for p in puts],
            self.config.align)
        return self._allgather_totals(local_total, rank, num_ranks)

    def _load_delta_index(self) -> "delta_mod.DeltaIndex":
        """Chunk index of the newest committed step (empty when there is
        none, its manifest is unreadable, or it predates delta — every
        chunk then hashes dirty, i.e. the save degrades to a full write).
        Reloaded per save rather than cached: the newest committed manifest
        is the authority on chunkstore paths."""
        step = self.latest_step()
        if step is None:
            return delta_mod.DeltaIndex()
        try:
            m = Manifest.load(os.path.join(self.directory,
                                           step_dir_name(step)))
        except ManifestError:
            return delta_mod.DeltaIndex()
        return delta_mod.DeltaIndex.from_manifest(m)

    def _allgather_totals(self, local_total: int, rank: int,
                          num_ranks: int) -> list[int]:
        """Cross-rank padded-total exchange for SINGLE_FILE (paper §3.6).

        ``self.allgather`` (an in-process shim under the multi-writer
        harness) overrides the ``torch.distributed`` exchange."""
        if self.allgather is not None:
            return [int(x) for x in self.allgather(local_total, rank,
                                                   num_ranks)]
        if num_ranks == 1:
            return [local_total]
        dist = _dist()
        if dist is None:
            raise RuntimeError(
                f"num_ranks={num_ranks} needs an initialised "
                f"torch.distributed process group")
        gathered = [None] * num_ranks
        dist.all_gather_object(gathered, int(local_total))
        return [int(x) for x in gathered]

    def _target_windows(self, rec, tmpl, layout=None):
        """(window, device) pairs this process must materialize: for a
        ``layout`` (mesh, placements: the ``shardings`` entry or the DTensor
        template's), this rank's local window, on the mesh's device type;
        otherwise the whole tensor, on the template tensor's device (else
        the manager's)."""
        if layout is not None:
            win = dtensor_window(*layout, tuple(rec.global_shape))
            if win is None:
                raise ValueError(f"{rec.key}: this rank is not in the "
                                 f"layout's device mesh")
            return [(win[0], mesh_device(layout[0]))]
        device = self.device
        if isinstance(tmpl, torch.Tensor) and tmpl.device.type != "meta":
            device = tmpl.device
        return [(tuple((0, s) for s in rec.global_shape), device)]

    def _materialize(self, rec, windows, extent_bytes, metrics,
                     quantized: bool = False):
        device = windows[0][1]
        if quantized:
            from . import quant_codec
            cache: dict = {}

            def lookup(sh):
                k = (rec.key, sh.path, sh.offset)
                if k not in cache:
                    td = trace.clock()
                    cache[k] = quant_codec.unpack(extent_bytes[k], rec.dtype,
                                                  device)
                    metrics.decode_seconds += trace.clock() - td
                return cache[k]
        else:
            lookup = lambda sh: extent_bytes[(rec.key, sh.path, sh.offset)]
        asm = WindowAssembler(rec, windows[0][0], device)
        for sh in asm.pending_shards():
            asm.feed(sh, lookup(sh))
        metrics.h2d_seconds += asm.h2d_seconds
        metrics.h2d_bytes += asm.h2d_bytes
        return asm.result()

    def _check_crc(self, expect, raw, key, path: str = "",
                   offset: int = 0) -> None:
        if self.verify_crc and expect is not None:
            got = crc32_of(raw)
            if got != expect:
                raise ChecksumError(key, path, offset, expect, got)

    def _verify_extents(self, manifest, extent_bytes) -> None:
        by_extent = {}
        for rec in manifest.tensors.values():
            for sh in rec.shards:
                by_extent[(rec.key, sh.path, sh.offset)] = (sh.crc32, rec.key)
        for eo, raw in extent_bytes.items():
            expect, key = by_extent.get(eo, (None, None))
            self._check_crc(expect, raw, key, eo[1], eo[2])

    def close(self) -> None:
        self.wait()
        if self.prefetcher is not None:
            self.prefetcher.close()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _deduped(rec):
    import copy
    out = copy.copy(rec)
    out.shards = dedupe_shards(rec)
    return out


def mesh_device(mesh) -> torch.device:
    """This process's device of a ``DeviceMesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    accel = getattr(torch, mesh.device_type)
    return torch.device(mesh.device_type, accel.current_device())


def _layout_of(layout) -> tuple:
    """(DeviceMesh, placements) of a ``shardings`` entry."""
    if isinstance(layout, tuple):
        mesh, placements = layout
    else:
        mesh, placements = layout.mesh, layout.placements
    return mesh, tuple(placements)


def _as_dtensor(local, mesh, placements, shape):
    """This rank's assembled window of a tensor of ``shape`` as a DTensor
    of layout (``mesh``, ``placements``)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                   for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _template_tensors(state_template) -> dict[str, object]:
    """key -> template leaf (anything with .shape/.dtype)."""
    return {path_str(path): leaf
            for path, leaf in tree_leaves_with_path(state_template)
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype")}
