"""Checkpoint manifest: the metadata header mapping tensors to file extents.

Paper §2 stage (4): "Metadata headers map tensors to offsets in files for
reconstruction during the restore." Ours additionally records the *global*
shape and per-shard index windows so restore can reshard elastically (restore
onto a different mesh than the one that saved — DESIGN.md §2 extension 4).

The manifest is a single JSON document per checkpoint version, written last and
fsync'd, then the version directory is atomically committed via rename. A
checkpoint without a committed manifest is invalid by definition (crash
consistency).
"""

from __future__ import annotations

import json
import os
import re
import zlib
from dataclasses import dataclass, field, asdict

MANIFEST_NAME = "manifest.json"
# Ceiling this reader accepts / writes. Version 3 added the chunk-reference
# shard entry kind (content-addressed delta checkpoints, DESIGN.md §12);
# version 4 adds per-shard chunk digest *kinds* (on-device fp128
# fingerprints, DESIGN.md §14). The written version floats with content —
# a manifest without chunk entries stays at BASE_FORMAT_VERSION, blake2b
# chunk manifests at CHUNK_FORMAT_VERSION — so older readers keep loading
# everything they can actually interpret and refuse (loudly) what they
# can't: a v3 reader must never scrub/diff fp128 refs as if they were
# blake2b content addresses.
FORMAT_VERSION = 4
CHUNK_FORMAT_VERSION = 3
BASE_FORMAT_VERSION = 2

# shard entry kinds: "extent" = bytes at (path, offset); "chunks" = the
# payload is the concatenation of content-addressed ChunkRefs into the
# chunkstore. An unknown kind raises typed ManifestError (old readers must
# not misread a chunk entry as a raw extent).
EXTENT_KIND = "extent"
CHUNK_KIND = "chunks"
_SHARD_KINDS = (EXTENT_KIND, CHUNK_KIND)

# chunk digest kinds: which function produced ``ChunkRef.hash``. Content
# addresses of different kinds never compare equal — the delta planner
# treats a kind mismatch exactly like a chunk-grid change (full write).
DIGEST_BLAKE2B = "blake2b128"   # host blake2b-128 (PR 5, implicit default)
DIGEST_FP128 = "fp128"          # on-device multilinear digest (DESIGN.md §14)

_RANK_MANIFEST_RE = re.compile(r"^MANIFEST\.rank-(\d+)$")


def rank_manifest_name(rank: int) -> str:
    """Per-rank manifest file in a (tmp) step dir — phase 1 of the
    multi-writer commit (DESIGN.md §11). ``manifest.json`` remains the one
    and only name that makes a checkpoint valid."""
    return f"MANIFEST.rank-{rank}"


class ManifestError(ValueError):
    """Manifest missing, truncated, corrupt, or semantically invalid."""


class ManifestMergeError(ManifestError):
    """Per-rank manifests disagree (step / strategy / tensor shape)."""


@dataclass(frozen=True)
class ChunkRef:
    """One content-addressed chunk of a shard's payload bytes.

    ``hash`` is the blake2b-128 hex digest of the chunk bytes (the content
    address); ``path`` is step-dir-relative like every other manifest path —
    chunks resident in the store use ``../chunkstore/packs/...`` so the same
    engine path-join resolves them from any step directory.
    """
    hash: str
    path: str
    offset: int
    nbytes: int
    crc32: int | None = None

    def to_json(self):
        return {"hash": self.hash, "path": self.path, "offset": self.offset,
                "nbytes": self.nbytes, "crc32": self.crc32}

    @staticmethod
    def from_json(d) -> "ChunkRef":
        return ChunkRef(d["hash"], d["path"], d["offset"], d["nbytes"],
                        d.get("crc32"))


@dataclass(frozen=True)
class ShardEntry:
    """One saved shard of one global tensor.

    ``kind == EXTENT_KIND``: the payload is the bytes at (path, offset).
    ``kind == CHUNK_KIND``: the payload is the in-order concatenation of
    ``chunks`` (content-addressed delta entries, DESIGN.md §12); ``path`` is
    then a synthetic unique identifier (never opened), ``offset`` is 0, and
    ``crc32`` — when present — covers the whole reassembled payload (fp128
    shards omit it: per-chunk CRCs already cover every byte, and skipping
    the extra host pass is half the point of device fingerprints).
    ``digest`` names the digest kind of the ``ChunkRef.hash`` values
    (``None`` means DIGEST_BLAKE2B, the pre-v4 implicit default).
    """
    index: tuple[tuple[int, int], ...]  # (start, stop) per dim, global coords
    path: str                           # file path relative to ckpt dir
    offset: int                         # byte offset in file
    nbytes: int                         # logical bytes
    crc32: int | None = None
    kind: str = EXTENT_KIND
    chunks: tuple[ChunkRef, ...] | None = None
    digest: str | None = None

    @property
    def digest_kind(self) -> str:
        return self.digest or DIGEST_BLAKE2B

    def to_json(self):
        d = {"index": [list(p) for p in self.index], "path": self.path,
             "offset": self.offset, "nbytes": self.nbytes, "crc32": self.crc32}
        if self.kind != EXTENT_KIND:
            d["kind"] = self.kind
            d["chunks"] = [c.to_json() for c in (self.chunks or ())]
            if self.digest is not None and self.digest != DIGEST_BLAKE2B:
                d["digest"] = self.digest
        return d

    @staticmethod
    def from_json(d) -> "ShardEntry":
        kind = d.get("kind", EXTENT_KIND)
        if kind not in _SHARD_KINDS:
            raise ManifestError(
                f"unknown shard entry kind {kind!r} (this reader understands "
                f"{_SHARD_KINDS}); refusing to misread the entry")
        chunks = None
        if kind == CHUNK_KIND:
            chunks = tuple(ChunkRef.from_json(c) for c in d.get("chunks", ()))
        return ShardEntry(tuple(tuple(p) for p in d["index"]), d["path"],
                          d["offset"], d["nbytes"], d.get("crc32"),
                          kind, chunks, d.get("digest"))


@dataclass
class TensorRecord:
    key: str
    dtype: str           # numpy dtype string, e.g. 'bfloat16', 'float32'
    global_shape: tuple[int, ...]
    shards: list[ShardEntry] = field(default_factory=list)

    def to_json(self):
        return {"key": self.key, "dtype": self.dtype,
                "global_shape": list(self.global_shape),
                "shards": [s.to_json() for s in self.shards]}

    @staticmethod
    def from_json(d) -> "TensorRecord":
        return TensorRecord(d["key"], d["dtype"], tuple(d["global_shape"]),
                            [ShardEntry.from_json(s) for s in d["shards"]])


@dataclass
class BlobRecord:
    """A serialized non-tensor byte object (e.g. the 'lean' pytree)."""
    key: str
    path: str
    offset: int
    nbytes: int
    crc32: int | None = None

    def to_json(self):
        return asdict(self)

    @staticmethod
    def from_json(d) -> "BlobRecord":
        return BlobRecord(d["key"], d["path"], d["offset"], d["nbytes"],
                          d.get("crc32"))


@dataclass
class Manifest:
    step: int
    num_ranks: int
    strategy: str
    format_version: int = BASE_FORMAT_VERSION
    tensors: dict[str, TensorRecord] = field(default_factory=dict)
    blobs: dict[str, BlobRecord] = field(default_factory=dict)
    extra: dict = field(default_factory=dict)  # engine config, mesh, timings

    # ---- construction helpers -------------------------------------------
    def add_shard(self, key: str, dtype: str, global_shape: tuple[int, ...],
                  entry: ShardEntry) -> None:
        rec = self.tensors.get(key)
        if rec is None:
            rec = self.tensors[key] = TensorRecord(key, dtype, tuple(global_shape))
        else:
            if rec.dtype != dtype or rec.global_shape != tuple(global_shape):
                raise ValueError(f"inconsistent tensor record for {key}")
        rec.shards.append(entry)

    def merge(self, other: "Manifest", *, rank: int | None = None) -> None:
        """Merge a per-rank manifest into this (global) one — rank-0 commit.

        Raises ``ManifestMergeError`` when the two manifests describe
        different checkpoints (step, strategy) or disagree on a tensor's
        dtype/global_shape. Idempotent: re-merging a rank already merged
        (``rank`` arg, or the manifest's recorded ``extra["rank"]``) is a
        no-op, and an exact-duplicate ``ShardEntry`` is skipped — a retried
        commit cannot accumulate duplicates that corrupt restore windows.
        Blobs keep the first writer's copy (every rank's lean object is
        equivalent)."""
        if other.step != self.step:
            raise ManifestMergeError(
                f"cannot merge manifests of different steps: "
                f"{self.step} vs {other.step}")
        if other.strategy != self.strategy:
            raise ManifestMergeError(
                f"cannot merge manifests of different strategies: "
                f"{self.strategy!r} vs {other.strategy!r}")
        if rank is None:
            rank = other.extra.get("rank")
        merged = self.extra.setdefault("merged_ranks", [])
        own = self.extra.get("rank")
        if own is not None and own not in merged:
            merged.append(own)
        if rank is not None and rank in merged:
            return
        # validate EVERYTHING before mutating anything: a mid-merge raise
        # must not leave this manifest half-merged yet marked as merged
        for key, rec in other.tensors.items():
            mine = self.tensors.get(key)
            if mine is not None and (
                    mine.dtype != rec.dtype
                    or tuple(mine.global_shape) != tuple(rec.global_shape)):
                raise ManifestMergeError(
                    f"tensor {key!r} disagrees across ranks: "
                    f"{mine.dtype}{tuple(mine.global_shape)} vs "
                    f"{rec.dtype}{tuple(rec.global_shape)}")
        for key, rec in other.tensors.items():
            mine = self.tensors.get(key)
            for s in rec.shards:
                if mine is not None and s in mine.shards:
                    continue   # already merged (re-merge / retry)
                self.add_shard(key, rec.dtype, rec.global_shape, s)
                mine = self.tensors[key]
        for k, b in other.blobs.items():
            self.blobs.setdefault(k, b)
        if rank is not None:
            merged.append(rank)
        q = set(self.extra.get("quantized", ())) \
            | set(other.extra.get("quantized", ()))
        if q:
            self.extra["quantized"] = sorted(q)

    @property
    def total_bytes(self) -> int:
        return (sum(s.nbytes for r in self.tensors.values() for s in r.shards)
                + sum(b.nbytes for b in self.blobs.values()))

    # ---- (de)serialization ------------------------------------------------
    def to_json(self) -> dict:
        # version floats with content: chunk-reference entries need the v3
        # reader, non-blake2b digest kinds the v4 reader; everything else
        # stays loadable by pre-delta readers
        fv = self.format_version
        shards = [sh for rec in self.tensors.values() for sh in rec.shards]
        if any(sh.kind != EXTENT_KIND for sh in shards):
            fv = max(fv, CHUNK_FORMAT_VERSION)
        if any(sh.kind == CHUNK_KIND and sh.digest_kind != DIGEST_BLAKE2B
               for sh in shards):
            fv = max(fv, FORMAT_VERSION)
        return {"format_version": fv, "step": self.step,
                "num_ranks": self.num_ranks, "strategy": self.strategy,
                "tensors": {k: v.to_json() for k, v in self.tensors.items()},
                "blobs": {k: v.to_json() for k, v in self.blobs.items()},
                "extra": self.extra}

    def dumps(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    @staticmethod
    def loads(data: bytes) -> "Manifest":
        """Parse manifest bytes; any structural defect (truncated JSON,
        missing fields, malformed records) raises ``ManifestError`` so
        callers can fall back to an older checkpoint instead of dying on a
        raw ``JSONDecodeError``/``KeyError``."""
        try:
            d = json.loads(data)
            if d["format_version"] > FORMAT_VERSION:
                raise ManifestError(
                    f"manifest from the future: {d['format_version']}")
            m = Manifest(d["step"], d["num_ranks"], d["strategy"],
                         d["format_version"])
            m.tensors = {k: TensorRecord.from_json(v)
                         for k, v in d["tensors"].items()}
            m.blobs = {k: BlobRecord.from_json(v)
                       for k, v in d["blobs"].items()}
            m.extra = d.get("extra", {})
            return m
        except ManifestError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise ManifestError(f"corrupt manifest: {e}") from e

    def _write(self, path: str) -> None:
        from . import faults   # runtime: faults imports ManifestError above
        payload = self.dumps()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            faults.file_write(f, payload)
            f.flush()
            faults.fsync(f.fileno())
        faults.replace(tmp, path)

    def save(self, ckpt_dir: str) -> None:
        self._write(os.path.join(ckpt_dir, MANIFEST_NAME))

    def save_rank(self, ckpt_dir: str, rank: int) -> None:
        """Write this rank's manifest as ``MANIFEST.rank-{r}`` (fsync'd,
        atomically renamed). Does NOT make the checkpoint valid — only the
        merged ``manifest.json`` does."""
        self._write(os.path.join(ckpt_dir, rank_manifest_name(rank)))

    @staticmethod
    def _read(path: str) -> "Manifest":
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ManifestError(f"unreadable manifest {path}: {e}") from e
        return Manifest.loads(data)

    @staticmethod
    def load(ckpt_dir: str) -> "Manifest":
        return Manifest._read(os.path.join(ckpt_dir, MANIFEST_NAME))

    @staticmethod
    def load_rank(ckpt_dir: str, rank: int) -> "Manifest":
        return Manifest._read(
            os.path.join(ckpt_dir, rank_manifest_name(rank)))

    @staticmethod
    def rank_manifests(ckpt_dir: str) -> list[int]:
        """Ranks that completed phase 1 (their ``MANIFEST.rank-{r}`` is on
        disk) in a step dir."""
        out = []
        for name in os.listdir(ckpt_dir):
            m = _RANK_MANIFEST_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    @staticmethod
    def exists(ckpt_dir: str) -> bool:
        return os.path.exists(os.path.join(ckpt_dir, MANIFEST_NAME))


def crc32_of(mv) -> int:
    return zlib.crc32(mv) & 0xFFFFFFFF
