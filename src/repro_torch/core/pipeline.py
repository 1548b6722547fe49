"""Streaming checkpoint pipelines: SnapshotPipeline (save, DESIGN.md §9)
and RestorePipeline (load, DESIGN.md §10).

The legacy save materialized a full host copy of EVERY shard — plus inline
int8 quant-packing — on the blocking path before the first byte hit storage,
so async mode only hid the final flush stage. This module decomposes the save
into stages that overlap at sub-tensor granularity (DataStates-LLM's lazy
multi-stage pipeline, ByteCheckpoint's decomposed save; DESIGN.md §9):

  1. declare   — ``build_save_puts`` walks the extracted tensors and emits
                 ``SaveSpec``s (sizes only — quantized payload sizes are
                 deterministic via ``quant_codec.packed_nbytes``) plus lazy
                 ``resolve`` callables that materialize payload bytes.
  2. plan      — ``CREngine.begin_save`` maps every spec to file extents
                 before any payload exists; the cross-rank prefix sum runs
                 on spec sizes, so it too leaves the blocking path early.
  3. snapshot  — each ``resolve()`` produces host bytes (device→host view,
                 quant pack) which the engine stream memcpys chunk-by-chunk
                 into pooled ``AlignedBuffer``s — the staging copy IS the
                 snapshot, double-buffered against the writes in flight.
  4. flush     — every staged extent is submitted to the io_engine the
                 moment it lands; ``EngineConfig.inflight_bytes`` caps the
                 staged bytes in flight (``StageBudget`` backpressure).

Mutation safety: torch tensors are updated in place (``optimizer.step()``),
so holding a reference is NOT a snapshot. Host-resident sources (CPU tensors,
``np.ndarray``) are eagerly copied on the blocking path when ``copy_mutable``
is set (async saves). CUDA sources are read by the pipeline worker, ordered
after the producer's stream by a CUDA event, and every D2H copy completes
before ``on_staged`` fires — ``CheckpointManager.wait_snapshotted()`` is the
barrier a caller honours before mutating them. ``copy_all`` instead clones
every source (on its own device) on the blocking path.

D2H copies of CUDA sources land in pinned host staging (``HostStaging``)
that the engine's ``put`` copies out of before the next put is resolved.

``RestorePipeline`` is the load-path twin: the monolithic restore
materialized EVERY extent in host memory before the first H2D copy, so
restore wall-clock was read + decode + assemble + H2D summed and peak host
memory was the full checkpoint. The pipeline instead consumes a streaming
``ReadStream`` (``CREngine.begin_restore``): as each tensor's extents land
they are dequantized, fed to incremental ``WindowAssembler``s, and placed on
device while the reads for later tensors are still in flight — peak host
staging stays bounded by ``EngineConfig.inflight_bytes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from . import trace
from .engines import ChecksumError, ReadReq, SaveSpec
from .manifest import CHUNK_KIND, Manifest, TensorRecord, crc32_of
from .resharding import WindowAssembler, normalize_index, record_dtype
from .serialization import (LEAN_KEY, LocalShard, as_bytes_view, dtype_name,
                            is_float_kind, tensor_nbytes, to_numpy_view)


@dataclass
class PendingPut:
    """One declared object plus the deferred materialization of its bytes.

    ``source`` keeps the origin tensor alongside the resolve closure so
    delta planning can fingerprint the bytes where they live — on the card
    for CUDA sources — instead of forcing the full D2H materialization that
    ``resolve()`` implies (DESIGN.md §14). ``quant`` marks puts whose
    resolved payload is the int8 quant-packed stream (``spec.nbytes`` is the
    packed size, not the source's).

    ``resolve(staging=None)``: with a ``HostStaging``, a CUDA source's bytes
    land in its reused pinned buffer — valid only until the next resolve, so
    only the snapshot pipeline (which puts each payload at once) passes one.
    """
    spec: SaveSpec
    resolve: Callable[..., object]  # -> buffer-protocol of spec.nbytes bytes
    source: object = None           # origin array (None: opaque/blob put)
    quant: bool = False


class HostStaging:
    """One reused pinned host buffer for D2H snapshots (grown on demand).

    Pinned memory makes the copy a DMA at full link rate, and pinning is
    costly, so one buffer serves every put in turn: a payload resolved into
    it is valid until the next ``take``."""

    def __init__(self):
        self._buf: torch.Tensor | None = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None
            self._buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def host_bytes(t, staging: HostStaging | None = None) -> np.ndarray:
    """Flat uint8 host view of a tensor's bytes: zero-copy for host-resident
    sources, a completed D2H copy (into ``staging`` when given) for device
    tensors."""
    if isinstance(t, np.ndarray) or t.device.type == "cpu":
        return as_bytes_view(to_numpy_view(t))
    src = t.contiguous().reshape(-1).view(torch.uint8)
    if staging is None:
        return src.to("cpu").numpy()
    dst = staging.take(src.numel())
    dst.copy_(src, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return dst.numpy()


def host_resident(t) -> bool:
    return isinstance(t, np.ndarray) or t.device.type == "cpu"


def snapshot_copy(t):
    """A private copy of a source, on its own device."""
    if isinstance(t, np.ndarray):
        return np.array(t, copy=True)
    return t.detach().clone()


def iter_host_shards(t):
    """Yield (tensor, global_index) for the shards this process owns.

    No host copy happens here — materialization is deferred to stream time
    (``PendingPut.resolve``) so the D2H lands directly in staging order.
    """
    if isinstance(t, LocalShard):
        # multi-writer rank leaf: the window was declared by the caller
        yield t.data, normalize_index(t.index, t.global_shape)
    elif is_dtensor(t):
        raise NotImplementedError(
            "DTensor leaves are saved by the multi-writer path, which this "
            "package does not have yet")
    else:
        yield t, tuple((0, s) for s in t.shape)


def _n_elems(arr) -> int:
    return int(np.prod(arr.shape, dtype=np.int64))


def build_save_puts(tensors: dict, lean_blob: bytes, *,
                    quantize_prefixes: tuple[str, ...] = (),
                    quantize_min_bytes: int = 1 << 16,
                    copy_mutable: bool = False,
                    copy_all: bool = False
                    ) -> tuple[list[PendingPut], list[str]]:
    """Turn extracted tensors + the lean blob into declared pipeline puts.

    Returns ``(puts, quantized_keys)``. Quant-packing and device→host
    materialization are captured in the resolve closures, NOT executed —
    they run on the pipeline worker, off the training loop's blocking path.

    The quantize test is numpy's ``dtype.kind == "f"`` (``is_float_kind``):
    bfloat16 is NOT quantized, exactly as in the JAX package.
    """
    from . import quant_codec
    puts: list[PendingPut] = []
    quantized: list[str] = []
    for key, t in tensors.items():
        quant = (any(key.startswith(p) for p in quantize_prefixes)
                 and tensor_nbytes(t) >= quantize_min_bytes
                 and is_float_kind(t.dtype))
        if quant:
            quantized.append(key)
        for n, (arr, index) in enumerate(iter_host_shards(t)):
            if copy_all or (copy_mutable and host_resident(arr)):
                # in-place-mutable source: stable pre-mutation snapshot now
                arr = snapshot_copy(arr)
            if quant:
                nbytes = quant_codec.packed_nbytes(_n_elems(arr))
                resolve = (lambda staging=None, a=arr, m=nbytes:
                           quant_codec.pack(
                               a, None if staging is None or host_resident(a)
                               else staging.take(m)))
            else:
                nbytes = tensor_nbytes(arr)
                resolve = (lambda staging=None, a=arr:
                           host_bytes(a, staging))
            puts.append(PendingPut(
                SaveSpec(f"{key}#{n}", nbytes, dtype_name(arr.dtype),
                         tuple(t.shape), index, record_key=key), resolve,
                source=arr, quant=quant))
    puts.append(PendingPut(SaveSpec(LEAN_KEY, len(lean_blob), is_blob=True),
                           lambda staging=None: lean_blob))
    return puts, quantized


class SnapshotPipeline:
    """Drives declared puts through an engine's streaming save.

    With a ``supports_streaming`` engine (aggregated), resolve → stage →
    submit run interleaved: while the io backend writes extent k, the worker
    resolves and stages extent k+1. Engines without a native stream degrade
    to the buffered batch path behind the same API.
    """

    def __init__(self, engine, staging: HostStaging | None = None):
        self.engine = engine
        self.staging = staging

    def run(self, ckpt_dir: str, puts: list[PendingPut], *, step: int = 0,
            rank: int = 0, num_ranks: int = 1,
            rank_totals: list[int] | None = None,
            on_staged: Callable[[], None] | None = None) -> Manifest:
        """``on_staged`` fires once every put has been resolved and staged —
        from then on the save no longer reads any caller-owned memory, so
        callers may mutate or donate their arrays while the flush drains
        (CheckpointManager.wait_snapshotted)."""
        with trace.span("plan", nbytes=sum(p.spec.nbytes for p in puts)):
            stream = self.engine.begin_save(
                ckpt_dir, [p.spec for p in puts], step=step, rank=rank,
                num_ranks=num_ranks, rank_totals=rank_totals)
        try:
            for p in puts:
                # the resolve IS the snapshot: D2H view + quant pack
                with trace.span("snapshot", nbytes=p.spec.nbytes,
                                attrs={"key": p.spec.key}):
                    payload = p.resolve(self.staging)
                stream.put(p.spec.key, payload)
            if on_staged is not None:
                on_staged()
            return stream.end_save()
        except BaseException:
            stream.abort()
            raise


@dataclass
class RestoreTask:
    """One tensor to materialize from the read stream.

    ``windows`` lists the (window, device) pairs this process must build;
    each window is assembled on its device, and quantized payloads are
    decoded on the first window's device. The caller's ``place`` callable
    turns the assembled windows into the final leaf.
    """
    key: str
    record: TensorRecord            # shards already deduped (DP replicas)
    windows: list[tuple] = field(default_factory=list)
    quantized: bool = False


def _decode_device(task: RestoreTask):
    return (task.windows[0][1] if task.windows else None) or "cpu"


def _extent_req_key(task_key: str, path: str, offset: int) -> str:
    return f"{task_key}@{path}@{offset}"


class RestorePipeline:
    """Drives RestoreTasks through an engine's streaming read.

    With a ``supports_streaming_read`` engine (aggregated), the four restore
    stages overlap per tensor: while the io backend reads the extents of
    tensor k+1, the consumer thread dequantizes (on the card) and
    window-assembles tensor k into its device tensor (the H2D copy happens
    as each extent is fed, so it is timed under assemble). Engines without
    a native stream degrade to the buffered batch path behind the same API
    (decode/assemble/H2D still pipeline against each other, reads do not).
    """

    def __init__(self, engine):
        self.engine = engine

    def run(self, ckpt_dir: str, tasks: list[RestoreTask], *,
            crcs: dict[str, int] | None = None,
            place: Callable | None = None,
            metrics=None) -> dict[str, object]:
        """Materialize every task; returns ``{task.key: leaf}``.

        ``place(task, windows)`` turns the assembled ``{window: tensor}``
        dict into the final leaf; ``crcs`` maps request keys to expected
        crc32s for in-stream verification.
        ``metrics`` (RestoreMetrics-shaped) gains stall/decode/assemble/h2d
        seconds and the engine's peak staged bytes."""
        from . import quant_codec
        if place is None:
            place = lambda task, windows: next(iter(windows.values()))
        if metrics is None:
            metrics = SimpleNamespace(
                read_seconds=0.0, read_stall_seconds=0.0, decode_seconds=0.0,
                assemble_seconds=0.0, h2d_seconds=0.0, peak_staged_bytes=0)

        # Plan: per task, one assembler per distinct window and the ordered
        # set of extents feeding them (a resharded restore reads a subset of
        # the saved shards — only intersecting extents are requested). A
        # chunk-reference shard (delta, DESIGN.md §12) contributes its real
        # chunk extents and sorts by its FIRST chunk's location — the
        # synthetic entry path names nothing on disk.
        def _loc(sh):
            if sh.kind == CHUNK_KIND:
                return ((sh.chunks[0].path, sh.chunks[0].offset)
                        if sh.chunks else ("", -1))
            return (sh.path, sh.offset)

        plans = []
        for task in tasks:
            asms: dict[tuple, WindowAssembler] = {}
            for window, device in task.windows:
                wkey = tuple(window)
                if wkey not in asms:
                    asms[wkey] = WindowAssembler(task.record, window,
                                                 device or "cpu")
            extents = {}
            for asm in asms.values():
                for sh in asm.pending_shards():
                    extents[(sh.path, sh.offset)] = sh
            ordered = sorted(extents.values(), key=_loc)
            plans.append((task, asms, ordered))
        # consume in layout order so the stream's staged-byte budget admits
        # reads exactly as earlier results drain (no over-budget escapes)
        plans.sort(key=lambda p: _loc(p[2][0]) if p[2] else ("", -1))
        reqs = []
        for task, _asms, ordered in plans:
            for sh in ordered:
                if sh.kind == CHUNK_KIND:
                    reqs += [ReadReq(_extent_req_key(task.key, r.path,
                                                     r.offset),
                                     r.path, r.offset, r.nbytes, obj=task.key)
                             for r in sh.chunks or ()]
                else:
                    reqs.append(ReadReq(
                        _extent_req_key(task.key, sh.path, sh.offset),
                        sh.path, sh.offset, sh.nbytes, obj=task.key))

        stream = self.engine.begin_restore(ckpt_dir, reqs, crcs=crcs)
        out: dict[str, object] = {}
        try:
            for task, asms, ordered in plans:
                for sh in ordered:
                    t0 = trace.clock()
                    if sh.kind == CHUNK_KIND:
                        # reassemble the shard payload from its chunk refs
                        # as they land; per-chunk CRCs were verified inside
                        # the stream, the whole-payload CRC (under the
                        # entry's synthetic key) guards the concatenation
                        from .delta import reassemble_payload
                        raw = reassemble_payload(
                            sh, lambda r: stream.get(_extent_req_key(
                                task.key, r.path, r.offset)))
                        expect = (crcs or {}).get(_extent_req_key(
                            task.key, sh.path, sh.offset))
                        if expect is not None:
                            got = crc32_of(raw)
                            if got != expect:
                                raise ChecksumError(task.key, sh.path,
                                                    sh.offset, expect, got)
                    else:
                        raw = stream.get(
                            _extent_req_key(task.key, sh.path, sh.offset))
                    t1 = trace.clock()
                    metrics.read_stall_seconds += t1 - t0
                    trace.complete("read.stall", t0, t1, nbytes=sh.nbytes)
                    if task.quantized:
                        raw = quant_codec.unpack(raw,
                                                 record_dtype(task.record),
                                                 _decode_device(task))
                        t2 = trace.clock()
                        metrics.decode_seconds += t2 - t1
                        trace.complete("decode", t1, t2, nbytes=sh.nbytes)
                    else:
                        t2 = t1
                    for asm in asms.values():
                        asm.feed(sh, raw)
                    t_asm = trace.clock()
                    metrics.assemble_seconds += t_asm - t2
                    trace.complete("assemble", t2, t_asm, nbytes=sh.nbytes)
                windows = {wkey: asm.result() for wkey, asm in asms.items()}
                t3 = trace.clock()
                out[task.key] = place(task, windows)
                t4 = trace.clock()
                metrics.h2d_seconds += t4 - t3
                trace.complete("h2d", t3, t4, tier="device")
            stats = stream.end_restore()
            metrics.read_seconds = stats.seconds
            metrics.peak_staged_bytes = stats.peak_staged_bytes
            return out
        except BaseException:
            # abort releases pooled buffers and settles the staged-byte
            # books — a failed restore must not wedge the engine
            stream.abort()
            raise
