"""Content-addressed delta checkpointing (DESIGN.md §12).

Every save in this repo used to persist the full byte image of every tensor
at every step. When optimizer slots, frozen layers, embeddings, or quantized
weights change sparsely between steps, most of those bytes are identical to
the previous step — the paper's *volume* axis multiplied by training length
for no information gain. This module decouples *what state is* from *which
bytes must move* (ByteCheckpoint's decomposition, DataStates-LLM's
composable state providers):

  chunking        every tensor shard's snapshot payload is split into fixed,
                  alignment-friendly extents and hashed (blake2b-128) on the
                  pipeline worker — never on the training loop's blocking
                  path,
  dirty detection the hashes are diffed against the previous step's chunk
                  index (recovered from the prior manifest's chunk entries);
                  only dirty chunks are declared and submitted through the
                  existing streaming save path (``CREngine.begin_save/put``),
                  so they ride the same coalescing/backpressure machinery as
                  a full save,
  chunk store     at publish, the step's freshly written data files are
                  renamed into ``<root>/chunkstore/packs/<step>-<uuid>/`` and
                  the manifest's chunk references rewritten to
                  ``../chunkstore/...`` paths — resolvable from ANY step
                  directory by the unchanged engine path join. Clean chunks
                  are recorded as references into packs written by earlier
                  steps,
  retention GC    ``CheckpointManager._gc_old`` becomes refcount-aware: a
                  store file is deleted only when no kept step (and no live
                  in-flight save's staged manifest) references it. Refcounts
                  are recomputed from manifests on every pass — no mutable
                  counter files to corrupt, so the GC is crash-safe and
                  self-healing; packs younger than a grace period are never
                  reaped (they may belong to a publish in flight).

Restore resolves chunk references back through the streaming read path
(``begin_restore/get``) with per-chunk CRCs verified in-stream, reassembles
each shard payload in order, and verifies the whole-payload CRC —
bit-exactly equal to a full-save restore.
"""

from __future__ import annotations

import hashlib
import os
import posixpath
import threading
import time
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from . import faults, trace
from .engines import SaveSpec
from .engines.base import as_u8
from .manifest import (CHUNK_KIND, DIGEST_BLAKE2B, DIGEST_FP128, ChunkRef,
                       Manifest, ManifestError, MANIFEST_NAME, ShardEntry,
                       _RANK_MANIFEST_RE)
from .pipeline import HostStaging, PendingPut, host_bytes
from .serialization import is_float_kind

CHUNKSTORE_DIR = "chunkstore"
PACK_SUBDIR = "packs"
# how store-resident refs appear relative to a step directory: one level up,
# into the checkpoint root's store (engines join paths against the step dir)
STORE_PREFIX = "../" + CHUNKSTORE_DIR + "/"
DEFAULT_CHUNK_BYTES = 256 << 10
# store files younger than this are never reaped: they may belong to a
# publish (or a cross-tier fetch) that has not landed its manifest yet
GC_GRACE_S = 300.0

# host-fallback fingerprint thread pool (DESIGN.md §14): per-put digest
# jobs fan out across a few threads — the numpy uint32 matmul releases the
# GIL, so multi-core hosts overlap the per-tensor passes instead of
# serializing them on the one pipeline worker
FP_POOL_WORKERS = min(4, os.cpu_count() or 1)
_fp_pool: ThreadPoolExecutor | None = None
_fp_pool_lock = threading.Lock()


def _host_fp_pool() -> ThreadPoolExecutor:
    global _fp_pool
    if _fp_pool is None:
        with _fp_pool_lock:
            if _fp_pool is None:
                _fp_pool = ThreadPoolExecutor(
                    max_workers=FP_POOL_WORKERS,
                    thread_name_prefix="fp128-host")
    return _fp_pool


def chunk_hash(mv) -> str:
    """Content address of one chunk: blake2b-128 hex digest."""
    return hashlib.blake2b(mv, digest_size=16).hexdigest()


def chunk_spans(nbytes: int, chunk_bytes: int):
    """Fixed chunk grid over a payload: (pos, n) pairs, last one ragged."""
    pos = 0
    while pos < nbytes:
        n = min(chunk_bytes, nbytes - pos)
        yield pos, n
        pos += n


def is_chunked(sh: ShardEntry) -> bool:
    return getattr(sh, "kind", None) == CHUNK_KIND


def reassemble_payload(sh: ShardEntry, fetch, check_chunk=None) -> np.ndarray:
    """Concatenate a chunk-reference shard's chunks back into its payload.

    ``fetch(ref)`` returns each chunk's uint8 bytes in declaration order;
    ``check_chunk(ref, bytes)`` optionally verifies each as it lands. Both
    restore paths (streaming pipeline and monolithic) reassemble through
    this one implementation so they cannot drift apart on chunk ordering
    (test_delta_monolithic_restore_parity guards the equivalence)."""
    payload = np.empty(sh.nbytes, np.uint8)
    pos = 0
    for r in sh.chunks or ():
        b = fetch(r)
        if check_chunk is not None:
            check_chunk(r, b)
        payload[pos:pos + r.nbytes] = b
        pos += r.nbytes
    if pos != sh.nbytes:
        # a parseable manifest whose chunk list lost a trailing ref must
        # fail loudly, not hand back uninitialized tail bytes (the
        # whole-payload CRC would also catch this, but only when CRCs are on)
        raise ManifestError(
            f"chunk refs cover {pos} of {sh.nbytes} payload bytes "
            f"({sh.path!r})")
    return payload


def store_rel(path: str) -> str:
    """Normalize a step-relative store ref to a store-relative path."""
    return posixpath.normpath(path[len(STORE_PREFIX):])


class DeltaIndex:
    """Chunk index of the previous step, recovered from its manifest.

    Keyed by (record_key, shard index window, payload nbytes): a shard whose
    tensor, window, or size changed gets no match and is fully dirty —
    which also makes resharding, chunk-size changes, and delta-over-non-delta
    transitions trivially correct (everything rewrites once). Each entry
    carries its manifest's digest kind; ``lookup`` only matches when the
    caller diffs with the same kind, so a blake2b-keyed index under an
    fp128 planner (or vice versa) degrades to a full write — content
    addresses of different digest functions must never compare equal.
    Only references already resident in the chunkstore are indexed; a fresh
    save must never point at bytes inside a GC-able step directory.
    """

    def __init__(self):
        # key -> (digest kind, chunk refs)
        self._by_shard: dict[tuple, tuple[str, tuple[ChunkRef, ...]]] = {}

    @staticmethod
    def from_manifest(manifest: Manifest | None) -> "DeltaIndex":
        idx = DeltaIndex()
        if manifest is None:
            return idx
        for rec in manifest.tensors.values():
            for sh in rec.shards:
                if not is_chunked(sh) or sh.chunks is None:
                    continue
                if not all(r.path.startswith(STORE_PREFIX)
                           for r in sh.chunks):
                    continue
                idx._by_shard.setdefault(
                    (rec.key, tuple(sh.index), sh.nbytes),
                    (sh.digest_kind, sh.chunks))
        return idx

    def lookup(self, record_key: str, index, nbytes: int, *,
               digest: str = DIGEST_BLAKE2B
               ) -> tuple[ChunkRef, ...] | None:
        e = self._by_shard.get((record_key, tuple(index or ()), nbytes))
        if e is None or e[0] != digest:
            return None
        return e[1]

    def __len__(self) -> int:
        return len(self._by_shard)


@dataclass
class _ShardChunks:
    """One original tensor-shard put, decomposed into chunk references.

    ``refs`` holds, per chunk in payload order, either a ``ChunkRef`` (clean
    — points into the store) or a ``(put_key, hash)`` pair (dirty — resolved
    against the stream manifest after the flush lands)."""
    spec: SaveSpec
    refs: list
    payload_crc: int | None


@dataclass
class DeltaPlan:
    """Output of the fingerprint/diff pass: what to write, how to describe
    it, and where the planning time went (SaveMetrics feeds off the phase
    timers and the D2H ledger)."""
    puts: list[PendingPut] = field(default_factory=list)
    shards: list[_ShardChunks] = field(default_factory=list)
    total_bytes: int = 0       # logical tensor + blob bytes of the state
    dirty_bytes: int = 0       # chunk bytes actually submitted
    blob_bytes: int = 0        # lean-object bytes (always written)
    chunks_total: int = 0
    chunks_dirty: int = 0
    digest_kind: str = DIGEST_BLAKE2B
    fingerprint_seconds: float = 0.0   # phase A: digest every chunk
    diff_seconds: float = 0.0          # phase B: diff + build refs
    d2h_bytes: int = 0         # device bytes that (will) cross to the host

    @property
    def written_bytes(self) -> int:
        return self.dirty_bytes + self.blob_bytes


def quant_write_spans(packed_nbytes: int, chunk_bytes: int,
                      header_bytes: int):
    """Write spans for a quant-packed payload under fp128 digests.

    The fp128 digest domain is ``packed[header_bytes:]`` (the q rows + f32
    scales stream) on the plain ``chunk_spans`` grid: the 20-byte header is
    a pure function of the element count, which is already part of the
    delta index key, so fingerprinting it would only re-dirty chunk 0 of
    every save. The WRITE spans merge the header into the first chunk so
    the refs still concatenate back to the exact packed payload:
    span_0 = packed[0 : header+c], span_j = packed[header + j*c :][:n].
    """
    first = True
    for pos, n in chunk_spans(packed_nbytes - header_bytes, chunk_bytes):
        if first:
            yield 0, n + header_bytes
            first = False
        else:
            yield pos + header_bytes, n


@dataclass
class _FpJob:
    """Phase-A fingerprint result for one tensor put (fp128 planner)."""
    kind: str                     # "host" | "device" | "qhost" | "qdevice"
    spans: list                   # write spans [(pos, n)] in payload order
    digests: np.ndarray | None = None   # (n_chunks, 4) uint32
    future: object = None               # pending host digest job
    payload: np.ndarray | None = None   # host payload (host / qhost)
    flat: object = None                 # device 1-D array (device)
    header: bytes = b""                 # packed header (qdevice)
    qbytes: object = None               # int8 q stream as uint8 (qdevice)
    sbytes: object = None               # f32 scales as uint8 (qdevice)


def _gather_host(ck: str, chunk: np.ndarray) -> np.ndarray:
    faults.gather(ck)
    return chunk


def _gather_device(ck: str, flat: torch.Tensor, pos: int, n: int,
                   staging: HostStaging | None = None) -> np.ndarray:
    """D2H-copy one dirty span of a tensor's bytes (``flat``: its uint8
    view) — the only payload bytes of a clean-mostly tensor that ever cross
    the link — into ``staging`` when given."""
    faults.gather(ck)
    with trace.span("gather", tier="device", nbytes=n, attrs={"key": ck}):
        return host_bytes(flat[pos:pos + n], staging)


def _gather_quant_device(ck: str, job: _FpJob, pos: int, n: int,
                         staging: HostStaging | None = None) -> np.ndarray:
    """Assemble one dirty span of a quant-packed payload from its device
    pieces (header is host bytes; q / scales byte slices are copied D2H
    straight into their places in ``staging`` when given, with one stream
    sync for the span)."""
    faults.gather(ck)
    dev = job.qbytes.device
    pinned = staging is not None and dev.type == "cuda"
    out = staging.take(n) if pinned else torch.empty(n, dtype=torch.uint8)
    hb = len(job.header)
    filled = 0
    if pos < hb:                                  # chunk 0 carries the header
        k = min(hb - pos, n)
        out[:k] = torch.frombuffer(bytearray(job.header[pos:pos + k]),
                                   dtype=torch.uint8)
        filled = k
    a = pos + filled - hb                         # qs-stream byte range
    b = pos + n - hb
    qb = int(job.qbytes.shape[0])
    if a < qb and b > a:
        k = min(qb, b) - a
        out[filled:filled + k].copy_(job.qbytes[a:a + k], non_blocking=pinned)
        filled += k
        a += k
    if b > qb:
        out[filled:].copy_(job.sbytes[a - qb:b - qb], non_blocking=pinned)
    if pinned:
        torch.cuda.current_stream(dev).synchronize()
    return out.numpy()


def _device_digestable(src, chunk_bytes: int) -> bool:
    """Can this put's bytes be fingerprinted where they live?

    Needs a torch tensor of any dtype (on the card: the kernels; on the
    CPU: their plain versions, so CPU runs take the same plan) — the digest
    reads the raw little-endian bytes, so it is the same for every dtype
    — and a lane-aligned chunk grid so per-chunk digest domains tile the
    global lane stream."""
    return isinstance(src, torch.Tensor) and chunk_bytes % 4 == 0


def plan_delta(puts: list[PendingPut], index: DeltaIndex, *,
               chunk_bytes: int = DEFAULT_CHUNK_BYTES,
               checksum: bool = True,
               device_fingerprint: bool = False) -> DeltaPlan:
    """Fingerprint, diff, and re-declare every put as its dirty chunks.

    Runs on the pipeline worker (async saves pay zero blocking time for the
    digest pass). Blob puts (the lean object) pass through unchanged; tensor
    puts are replaced by one put per DIRTY chunk — a clean chunk becomes a
    reference to the previous step's store extent.

    ``device_fingerprint=False`` is the PR-5 path: resolve every payload to
    host bytes and blake2b-hash each chunk — every byte crosses the link
    just to be diffed. ``device_fingerprint=True`` computes fp128 digests
    where the bytes live (the CUDA kernels for CUDA tensors, their plain
    PyTorch versions for CPU tensors, the numpy host twin for numpy arrays,
    all bit-identical — kernels/fingerprint.py) and D2H-copies only the chunks
    the diff proves dirty, so clean bytes never cross PCIe; quantized puts
    run the fused quantize+fingerprint pass and gather dirty spans of the
    packed stream. The two paths key the delta index with their own digest
    kind, so flipping the flag (or restoring onto an old blake2b index)
    degrades to one full write — never a wrong delta.

    Memory: dirty-chunk puts hold VIEWS of resolved host payloads (free for
    host arrays — they alias the caller's state) or deferred D2H gathers
    for device arrays, which the pipeline worker materializes one chunk at
    a time in staging order.
    """
    if device_fingerprint:
        return _plan_delta_fp128(puts, index, chunk_bytes=chunk_bytes)
    plan = DeltaPlan()
    t0 = trace.clock()
    for p in puts:
        if p.spec.is_blob:
            plan.puts.append(p)
            plan.blob_bytes += p.spec.nbytes
            plan.total_bytes += p.spec.nbytes
            continue
        payload = np.frombuffer(as_u8(p.resolve()), np.uint8)
        if payload.nbytes != p.spec.nbytes:
            raise ValueError(
                f"declared {p.spec.nbytes} bytes for {p.spec.key!r}, "
                f"resolved {payload.nbytes}")
        plan.total_bytes += payload.nbytes
        rkey = p.spec.record_key or p.spec.key
        prior = index.lookup(rkey, p.spec.index, p.spec.nbytes,
                             digest=DIGEST_BLAKE2B)
        crc = 0 if checksum else None
        refs: list = []
        for j, (pos, n) in enumerate(chunk_spans(p.spec.nbytes, chunk_bytes)):
            chunk = payload[pos:pos + n]
            h = chunk_hash(chunk)
            if checksum:
                crc = zlib.crc32(chunk, crc) & 0xFFFFFFFF
            plan.chunks_total += 1
            pr = prior[j] if prior is not None and j < len(prior) else None
            if pr is not None and pr.hash == h and pr.nbytes == n:
                refs.append(pr)                       # clean: reference
                continue
            ck = f"{p.spec.key}.c{j:05d}"
            plan.puts.append(PendingPut(
                SaveSpec(ck, n, "uint8", (n,), ((0, n),), record_key=ck),
                (lambda staging=None, c=chunk, k=ck: _gather_host(k, c))))
            refs.append((ck, h))                      # dirty: write
            plan.chunks_dirty += 1
            plan.dirty_bytes += n
        plan.shards.append(_ShardChunks(p.spec, refs, crc))
    plan.fingerprint_seconds = trace.clock() - t0
    trace.complete("fingerprint", t0, nbytes=plan.total_bytes,
                   attrs={"chunks": plan.chunks_total})
    return plan


def _plan_delta_fp128(puts: list[PendingPut], index: DeltaIndex, *,
                      chunk_bytes: int) -> DeltaPlan:
    """The device-fingerprint planner (DESIGN.md §14).

    Phase A fingerprints every put where its bytes live — tensor digests
    via kernels.fingerprint (16 B/chunk crossing D2H; the ``device`` and
    ``qdevice`` jobs launch the kernels for a CUDA tensor and run their
    plain versions for a CPU one), host fallbacks for numpy sources fanned
    across the fp128 thread pool. Phase B diffs the digest tables
    against the previous index and declares one put per dirty chunk whose
    resolve D2H-gathers exactly that span.

    fp128 shard entries carry NO whole-payload CRC: per-chunk CRCs (fresh
    from the write stream for dirty chunks, inherited with the store ref
    for clean ones) already cover every payload byte, and the whole-payload
    pass would re-read on the host the very bytes this path exists to keep
    off it.
    """
    from ..kernels import fingerprint as fpk
    from . import quant_codec
    plan = DeltaPlan(digest_kind=DIGEST_FP128)
    hb = quant_codec.HEADER.size
    t0 = trace.clock()
    jobs: list[_FpJob | None] = []
    pool = _host_fp_pool()
    for p in puts:
        if p.spec.is_blob:
            jobs.append(None)
            continue
        if p.quant and _device_digestable(p.source, chunk_bytes) \
                and is_float_kind(p.source.dtype):
            src = p.source
            n_elems = src.numel()
            rows = quant_codec.packed_rows(n_elems)
            flat = src.reshape(-1).to(torch.float32).contiguous()
            # zero-extension to the row grid is virtual on the card
            q, s, dig = fpk.quant_fingerprint(flat, rows, chunk_bytes)
            header = quant_codec.header(n_elems)
            assert hb + rows * quant_codec.GROUP_COLS + rows * 4 \
                == p.spec.nbytes
            jobs.append(_FpJob(
                "qdevice", list(quant_write_spans(p.spec.nbytes, chunk_bytes,
                                                  hb)),
                digests=dig, header=header,
                qbytes=q.reshape(-1).view(torch.uint8),
                sbytes=s.view(torch.uint8)))
            plan.d2h_bytes += dig.nbytes
        elif p.quant:
            payload = np.frombuffer(as_u8(p.resolve()), np.uint8)
            _check_resolved(p, payload)
            jobs.append(_FpJob(
                "qhost", list(quant_write_spans(p.spec.nbytes, chunk_bytes,
                                                hb)),
                future=pool.submit(fpk.fingerprint_chunks_host,
                                   payload[hb:], chunk_bytes),
                payload=payload))
        elif _device_digestable(p.source, chunk_bytes) and p.spec.nbytes:
            flat = p.source.contiguous().reshape(-1)
            dig = fpk.fingerprint_digests(flat, chunk_bytes)
            jobs.append(_FpJob(
                "device", list(chunk_spans(p.spec.nbytes, chunk_bytes)),
                digests=dig, flat=flat.view(torch.uint8)))
            plan.d2h_bytes += dig.nbytes
        else:
            payload = np.frombuffer(as_u8(p.resolve()), np.uint8)
            _check_resolved(p, payload)
            jobs.append(_FpJob(
                "host", list(chunk_spans(p.spec.nbytes, chunk_bytes)),
                future=pool.submit(fpk.fingerprint_chunks_host,
                                   payload, chunk_bytes),
                payload=payload))
    for job in jobs:
        if job is not None and job.future is not None:
            job.digests = job.future.result()
            job.future = None
    plan.fingerprint_seconds = trace.clock() - t0
    trace.complete("fingerprint", t0, tier="device",
                   attrs={"puts": len(puts)})

    t1 = trace.clock()
    for p, job in zip(puts, jobs):
        if job is None:                               # blob passthrough
            plan.puts.append(p)
            plan.blob_bytes += p.spec.nbytes
            plan.total_bytes += p.spec.nbytes
            continue
        plan.total_bytes += p.spec.nbytes
        rkey = p.spec.record_key or p.spec.key
        prior = index.lookup(rkey, p.spec.index, p.spec.nbytes,
                             digest=DIGEST_FP128)
        hexes = fpk.digests_hex(job.digests)
        assert len(hexes) == len(job.spans), (p.spec.key, len(hexes),
                                              len(job.spans))
        refs: list = []
        for j, (pos, n) in enumerate(job.spans):
            h = hexes[j]
            plan.chunks_total += 1
            pr = prior[j] if prior is not None and j < len(prior) else None
            if pr is not None and pr.hash == h and pr.nbytes == n:
                refs.append(pr)                       # clean: reference
                continue
            ck = f"{p.spec.key}.c{j:05d}"
            if job.kind == "device":
                resolve = (lambda staging=None, k=ck, f=job.flat, o=pos, m=n:
                           _gather_device(k, f, o, m, staging))
                plan.d2h_bytes += n
            elif job.kind == "qdevice":
                resolve = (lambda staging=None, k=ck, jb=job, o=pos, m=n:
                           _gather_quant_device(k, jb, o, m, staging))
                plan.d2h_bytes += n
            else:
                chunk = job.payload[pos:pos + n]
                resolve = (lambda staging=None, k=ck, c=chunk:
                           _gather_host(k, c))
            plan.puts.append(PendingPut(
                SaveSpec(ck, n, "uint8", (n,), ((0, n),), record_key=ck),
                resolve))
            refs.append((ck, h))                      # dirty: write
            plan.chunks_dirty += 1
            plan.dirty_bytes += n
        plan.shards.append(_ShardChunks(p.spec, refs, None))
    plan.diff_seconds = trace.clock() - t1
    trace.complete("diff", t1, nbytes=plan.dirty_bytes,
                   attrs={"dirty": plan.chunks_dirty,
                          "total": plan.chunks_total})
    return plan


def _check_resolved(p: PendingPut, payload: np.ndarray) -> None:
    if payload.nbytes != p.spec.nbytes:
        raise ValueError(
            f"declared {p.spec.nbytes} bytes for {p.spec.key!r}, "
            f"resolved {payload.nbytes}")


def apply_plan(stream_manifest: Manifest, plan: DeltaPlan) -> Manifest:
    """Fold the flushed stream manifest back into chunked shard entries.

    The stream manifest maps each dirty-chunk put to its file extent; the
    returned manifest replaces those per-chunk records with one
    ``kind="chunks"`` entry per original tensor shard, mixing fresh extents
    (still step-dir-relative — relocated by ``publish_packs``) with the
    plan's clean store references. Blobs and extra metadata ride through.
    """
    out = Manifest(stream_manifest.step, stream_manifest.num_ranks,
                   stream_manifest.strategy)
    out.blobs = stream_manifest.blobs
    out.extra = stream_manifest.extra
    for sc in plan.shards:
        spec = sc.spec
        chunks: list[ChunkRef] = []
        for r in sc.refs:
            if isinstance(r, ChunkRef):
                chunks.append(r)
                continue
            ck, h = r
            ext = stream_manifest.tensors[ck].shards[0]
            chunks.append(ChunkRef(h, ext.path, ext.offset, ext.nbytes,
                                   ext.crc32))
        index = spec.index
        if index is None:
            index = tuple((0, s) for s in (spec.global_shape or ()))
        gshape = (spec.global_shape if spec.global_shape is not None
                  else (spec.nbytes,))
        out.add_shard(
            spec.record_key or spec.key, spec.dtype or "uint8", gshape,
            ShardEntry(tuple(index), f"<chunks:{uuid.uuid4().hex[:12]}>", 0,
                       spec.nbytes, sc.payload_crc, CHUNK_KIND,
                       tuple(chunks),
                       digest=(plan.digest_kind
                               if plan.digest_kind != DIGEST_BLAKE2B
                               else None)))
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        faults.fsync(fd)
    finally:
        os.close(fd)


def publish_packs(manifest: Manifest, tmp: str, root: str, tag: str) -> bool:
    """Relocate the step's freshly written data files into the chunkstore.
    Returns True when the rewritten manifest was already written into
    ``tmp`` (callers must not redundantly re-serialize it).

    Every file referenced by a step-dir-relative path (fresh dirty chunks
    AND the lean blob — under single-file layouts they share one file) is
    renamed from ``tmp`` into ``<root>/chunkstore/packs/<tag>-<uuid>/`` and
    the manifest rewritten to ``../chunkstore/...`` references, so the bytes
    survive the step directory's eventual ``rmtree``.

    Ordering closes the GC race: the REWRITTEN manifest is written into the
    (pidfile-owned, GC-pinning) staging dir BEFORE any file is renamed into
    the store, so the moment a pack file becomes visible there, a live
    manifest referencing it already exists — a concurrent refcount GC
    (which snapshots its candidate list before computing refs) can never
    see it as an orphan. A crash mid-sequence leaves either a doomed tmp
    dir (reaped by ``_gc_tmp``) or unreferenced store files (reaped after
    the grace period) — never a committed manifest pointing at missing
    bytes, because the commit rename happens strictly after the moves.
    """
    fresh: set[str] = set()
    for rec in manifest.tensors.values():
        for sh in rec.shards:
            if is_chunked(sh) and sh.chunks:
                fresh.update(r.path for r in sh.chunks
                             if not r.path.startswith(STORE_PREFIX))
            elif not is_chunked(sh) and not sh.path.startswith(STORE_PREFIX):
                fresh.add(sh.path)
    fresh.update(b.path for b in manifest.blobs.values()
                 if not b.path.startswith(STORE_PREFIX))
    fresh = {p for p in fresh if os.path.exists(os.path.join(tmp, p))}
    if not fresh:
        return False
    pack = f"{tag}-{uuid.uuid4().hex[:8]}"
    pack_dir = os.path.join(root, CHUNKSTORE_DIR, PACK_SUBDIR, pack)
    moved = {rel: posixpath.join(STORE_PREFIX.rstrip("/"), PACK_SUBDIR,
                                 pack, rel)
             for rel in sorted(fresh)}
    # 1. rewrite references (ShardEntry/ChunkRef are frozen: rebuild)
    for rec in manifest.tensors.values():
        new_shards = []
        for sh in rec.shards:
            if is_chunked(sh) and sh.chunks:
                refs = tuple(
                    replace(r, path=moved[r.path]) if r.path in moved else r
                    for r in sh.chunks)
                sh = replace(sh, chunks=refs)
            elif sh.path in moved:
                sh = replace(sh, path=moved[sh.path])
            new_shards.append(sh)
        rec.shards = new_shards
    for key, b in list(manifest.blobs.items()):
        if b.path in moved:
            manifest.blobs[key] = replace(b, path=moved[b.path])
    # 2. land the rewritten manifest in the pinning tmp dir FIRST: the refs
    # exist on disk before any file they name becomes reapable
    manifest.save(tmp)
    # 3. now move the payload files into the store. A concurrent gc_store
    # prunes EMPTY pack dirs (os.rmdir), so the freshly made dir can vanish
    # between makedirs and replace — retry until the rename lands; once the
    # first file is in, the dir is non-empty and unprunable, so this
    # converges (the retry bound only guards against programming errors).
    dirs_to_sync = set()
    for rel in sorted(fresh):
        src = os.path.join(tmp, rel)
        dst = os.path.join(pack_dir, rel)
        for _ in range(100):
            try:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                faults.replace(src, dst)
                break
            except FileNotFoundError:
                if not os.path.exists(src):
                    raise
        else:
            raise OSError(f"pack dir kept vanishing under {dst!r}")
        dirs_to_sync.add(os.path.dirname(dst))
    for d in sorted(dirs_to_sync, reverse=True):
        _fsync_dir(d)
    _fsync_dir(os.path.join(root, CHUNKSTORE_DIR, PACK_SUBDIR))
    # drop now-empty data dirs so the published step holds only metadata
    for rel in sorted(fresh, reverse=True):
        d = os.path.dirname(os.path.join(tmp, rel))
        while len(d) > len(tmp):
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)
    return True


# ------------------------------------------------------------ retention GC
@dataclass
class StoreGCStats:
    scanned: int = 0
    kept: int = 0
    deleted: int = 0
    bytes_freed: int = 0
    refcounts: dict = field(default_factory=dict)  # store-rel path -> refs


def manifest_store_paths(m: Manifest):
    """Store-relative paths this manifest references."""
    for rec in m.tensors.values():
        for sh in rec.shards:
            if is_chunked(sh) and sh.chunks:
                for r in sh.chunks:
                    if r.path.startswith(STORE_PREFIX):
                        yield store_rel(r.path)
            elif sh.path.startswith(STORE_PREFIX):
                yield store_rel(sh.path)
    for b in m.blobs.values():
        if b.path.startswith(STORE_PREFIX):
            yield store_rel(b.path)


def _scan_store_refs(root: str) -> tuple[dict[str, int], bool]:
    """One refcount pass; also reports whether a listed manifest or
    ``.tmp-`` dir vanished mid-scan (a concurrent publish renaming ``tmp``
    → step dir between our ``listdir`` and the read, or the liveness check
    — the refs exist but under a name this pass never visited, so the
    caller must rescan)."""
    from .checkpoint import _STEP_RE, tmp_in_flight  # runtime: avoid cycle
    counts: dict[str, int] = {}
    vanished = False
    try:
        names = os.listdir(root)
    except OSError:
        return counts, False
    for name in names:
        full = os.path.join(root, name)
        if not os.path.isdir(full):
            # a listed .tmp- dir gone by now was committed (or reaped): its
            # refs may live on under a step name this pass never listed
            vanished |= ".tmp-" in name and not os.path.exists(full)
            continue
        mpaths = []
        if _STEP_RE.match(name):
            mpaths = [os.path.join(full, MANIFEST_NAME)]
        elif ".tmp-" in name:
            if not tmp_in_flight(full):
                # not live — or renamed away while its owner was read
                vanished |= not os.path.exists(full)
                continue
            try:
                inner = os.listdir(full)
            except OSError:
                vanished = True
                continue
            mpaths = [os.path.join(full, n) for n in inner
                      if n == MANIFEST_NAME or _RANK_MANIFEST_RE.match(n)]
        for mp in mpaths:
            try:
                m = Manifest._read(mp)
            except ManifestError:
                if not os.path.exists(mp):
                    vanished = True   # dir renamed away under us
                continue   # truly corrupt/foreign manifest pins nothing
            for rel in manifest_store_paths(m):
                counts[rel] = counts.get(rel, 0) + 1
    return counts, vanished


def referenced_store_paths(root: str) -> dict[str, int]:
    """Refcount every store file referenced by manifests under ``root``.

    Committed step dirs count via their ``manifest.json``; ``.tmp-*`` dirs
    belonging to a LIVE save (ownership pidfile / young-dir age — the same
    machinery that protects in-flight saves from ``_gc_tmp``) pin whatever
    their staged ``manifest.json`` / ``MANIFEST.rank-*`` files reference, so
    a concurrent manager's GC cannot reap chunks a peer's in-flight save
    has already committed to referencing. Rescans when a publish renames a
    manifest out from under the pass; raises ``InterruptedError`` if it
    never stabilizes (callers skip deletions and converge next pass).
    """
    for _ in range(5):
        counts, vanished = _scan_store_refs(root)
        if not vanished:
            return counts
    raise InterruptedError(
        "store refcount scan kept racing concurrent publishes")


def gc_store(root: str, *, grace_s: float = GC_GRACE_S) -> StoreGCStats:
    """Reap store files unreferenced by any kept step (refcounted GC).

    Crash-safe by construction: refcounts are recomputed from the manifests
    actually on disk, so an interrupted GC (or publish) converges on the
    next pass; files younger than ``grace_s`` are spared because their
    referencing manifest may not have landed yet. The candidate file list
    is snapshotted BEFORE refs are computed — a pack that appears mid-pass
    is not a candidate, and ``publish_packs`` writes its referencing
    manifest before moving any file, so the two passes can interleave
    freely without reaping a just-published chunk.
    """
    stats = StoreGCStats()
    store = os.path.join(root, CHUNKSTORE_DIR)
    if not os.path.isdir(store):
        return stats
    candidates: list[str] = []
    dirs: list[str] = []
    for dirpath, _dirnames, filenames in os.walk(store, topdown=False):
        candidates += [os.path.join(dirpath, fn) for fn in filenames]
        if dirpath != store:
            dirs.append(dirpath)
    try:
        stats.refcounts = referenced_store_paths(root)
    except InterruptedError:
        # publishes kept racing the ref scan: skip deletions this pass (the
        # next GC converges) rather than risk reaping a live chunk
        stats.scanned = stats.kept = len(candidates)
        return stats
    # crlint: allow(CRL006): GC grace compares against file mtimes
    now = time.time()
    for fp in candidates:
        rel = posixpath.normpath(os.path.relpath(fp, store))
        stats.scanned += 1
        if stats.refcounts.get(rel):
            stats.kept += 1
            continue
        try:
            st = os.stat(fp)
        except OSError:
            continue   # vanished concurrently
        if now - st.st_mtime < grace_s:
            stats.kept += 1
            continue
        try:
            os.remove(fp)
        except OSError:
            continue
        stats.deleted += 1
        stats.bytes_freed += st.st_size
    for d in dirs:
        try:
            os.rmdir(d)   # prune empty pack dirs
        except OSError:
            pass
    return stats
