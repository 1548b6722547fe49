"""Fault injection at the engine/OS boundary (DESIGN.md §13).

PRs 4–5 closed publish/GC/torn-manifest crash windows that were found by
hand-auditing the commit protocol. This module systematizes that auditing
into a permanent, deterministic fault-injection layer:

  FaultPlan       a one-shot schedule of faults, armed via ``inject(plan)``.
                  Every instrumented syscall site in the checkpoint stack
                  (``io_engine`` pwrite/preadv/fdatasync, ``engines/base``
                  fallocate, ``manifest`` write/fsync/replace,
                  ``checkpoint.replace_dir``, ``delta.publish_packs``,
                  ``multilevel`` flush renames) consults the active plan and
                  can crash (``InjectedCrash``), raise an errno
                  (ENOSPC/EIO), tear a write (persist a prefix, then crash),
                  or short-write (persist a prefix and return — exercising
                  the engines' retry loops).
  corruptors      filesystem-level post-commit damage: bit-flips, truncation,
                  zeroing — aimed at chunkstore files and manifests.
  scrub_store     CRC walk of the refcounted chunkstore driven by the kept
                  steps' manifests: corrupt files are repaired from a level-1
                  mirror when one is given, quarantined otherwise; a restore
                  that would touch a quarantined chunk fails with the typed
                  ``QuarantinedChunkError`` (a ``ManifestError``, so the
                  latest-step fallback can still try an older step).

The shims are pass-throughs (one ``is None`` check) when no plan is active;
production code pays nothing for the instrumentation. The module must stay
import-light — ``io_engine`` imports it — so anything touching the
checkpoint/delta layers is imported at call time.

This is the PyTorch package's copy of ``repro.core.faults``. The seeded
chaos campaign that drives it has not been carried over yet; the scrubber
verifies fp128 spans with the numpy host twin in ``kernels.fingerprint``.
"""

from __future__ import annotations

import errno as _errno
import os
import shutil
import threading
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field

from . import trace

from .manifest import ManifestError

# syscall kinds an instrumented site reports
OP_WRITE = "write"
OP_READ = "read"
OP_FSYNC = "fsync"
OP_RENAME = "rename"
OP_FALLOCATE = "fallocate"
# not a syscall: the D2H gather of one dirty chunk between the
# fingerprint-diff and its put submission (DESIGN.md §14) — the window in
# which a crash must not commit a manifest referencing never-copied chunks
OP_GATHER = "gather"
# object-store requests (core/remote.py): ranged GET / PUT against the
# level-2 tier — not syscalls, but the same one-shot schedule drives them
OP_RGET = "rget"
OP_RPUT = "rput"
# recursive delete of a staging/aside/retired checkpoint dir — one consult
# per tree, carrying the root path; a torn rmtree leaves a half-deleted tree
OP_RMTREE = "rmtree"
OP_KINDS = (OP_WRITE, OP_READ, OP_FSYNC, OP_RENAME, OP_FALLOCATE, OP_GATHER,
            OP_RGET, OP_RPUT, OP_RMTREE)

# fault actions
A_CRASH = "crash"    # simulate process death at the syscall
A_ERRNO = "errno"    # raise OSError(err) from the syscall
A_TORN = "torn"      # persist a prefix of the write, then crash
A_SHORT = "short"    # persist a prefix and return its length (no crash)
A_CALL = "call"      # run a callback at the syscall, then perform it
A_STALL = "stall"    # delay the op by ``delay_s``, then perform it
ACTIONS = (A_CRASH, A_ERRNO, A_TORN, A_SHORT, A_CALL, A_STALL)

QUARANTINE_SUBDIR = "quarantine"


class InjectedCrash(RuntimeError):
    """Simulated process death at an instrumented syscall.

    In-process crash simulation: the exception unwinds the save/restore
    (running ``finally`` cleanup a real SIGKILL would skip — which releases
    buffers but does not change what already reached the filesystem), and
    the campaign then abandons the manager, marks its staging-dir owner
    dead (``simulate_owner_death``), and verifies recovery from a fresh
    manager, exactly as a restarted trainer would."""


class InjectedIOError(OSError):
    """Injected errno fault — distinguishable from a real I/O error."""


class QuarantinedChunkError(ManifestError):
    """A restore touched a chunk the scrubber quarantined as corrupt.

    Subclasses ``ManifestError`` so a latest-step restore falls back to an
    older step (which may succeed if it does not share the chunk); an
    explicitly requested step propagates the error, naming the chunk."""

    def __init__(self, store_path: str, key: str, chunk_hash: str | None):
        self.store_path = store_path
        self.key = key
        self.chunk_hash = chunk_hash
        h = f" hash={chunk_hash}" if chunk_hash else ""
        super().__init__(
            f"chunk {store_path!r} (ref by {key!r}{h}) is quarantined as "
            f"corrupt; restore cannot proceed from this step")


@dataclass
class Fault:
    """Fire ``action`` at the ``at``-th eligible syscall of kind ``op``.

    Eligibility: the op kind matches AND, when ``path_contains`` is set,
    the syscall carries a path containing it (fd-only ops never match a
    path-filtered fault). Each fault keeps its own counter and fires once.
    """
    op: str
    at: int = 1
    action: str = A_CRASH
    err: int = _errno.EIO
    frac: float = 0.5               # fraction of bytes persisted (torn/short)
    delay_s: float = 0.25           # stall duration (action="stall")
    path_contains: str | None = None
    callback: object = None         # for action="call"
    seen: int = 0                   # eligible syscalls observed so far
    done: bool = False

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.op!r}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}")
        if self.at < 1:
            raise ValueError("at is 1-based")

    def describe(self) -> str:
        where = f"@{self.path_contains}" if self.path_contains else ""
        return f"{self.action}:{self.op}#{self.at}{where}"


class FaultPlan:
    """A schedule of one-shot faults plus counters, armed via ``inject``.

    Thread-safe: engine worker threads, pipeline workers, and flush threads
    all consult the same plan. Counters are deterministic whenever the
    instrumented code path is (single-writer posix-backend schedules are;
    multiwriter rank threads interleave, which only moves WHERE a fault
    lands — the invariants must hold at every site, so any interleaving is
    a valid trial)."""

    def __init__(self, faults=()):
        self._lock = threading.Lock()
        self.faults: list[Fault] = list(faults)
        self.counts: dict[str, int] = {k: 0 for k in OP_KINDS}
        self.fired: list[str] = []    # Fault.describe() of each fired fault

    def add(self, fault: Fault) -> "FaultPlan":
        with self._lock:
            self.faults.append(fault)
        return self

    def _consult(self, op: str, path: str | None = None) -> Fault | None:
        """Count one syscall; return the fault to apply, if one fires."""
        with self._lock:
            self.counts[op] += 1
            for f in self.faults:
                if f.done or f.op != op:
                    continue
                if f.path_contains is not None and (
                        path is None or f.path_contains not in path):
                    continue
                f.seen += 1
                if f.seen >= f.at:
                    f.done = True
                    self.fired.append(f.describe())
                    trace.event("fault.injected", tier="faults",
                                attrs={"op": op, "action": f.action,
                                       "path": path or "",
                                       "fault": f.describe()})
                    return f
            return None

    @property
    def fired_count(self) -> int:
        return len(self.fired)


_ACTIVE: FaultPlan | None = None
_ARM_LOCK = threading.Lock()


@contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block (one plan at a time)."""
    global _ACTIVE
    with _ARM_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already active")
        _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def _raise_for(f: Fault, op: str):
    if f.action == A_ERRNO:
        raise InjectedIOError(f.err, os.strerror(f.err),
                              f"<injected:{op}>")
    raise InjectedCrash(f"injected crash at {f.describe()}")


def _soft(f: Fault) -> bool:
    """call/stall are soft actions: run the side effect here, then the shim
    performs the real op. Returns True when the fault was consumed."""
    if f.action == A_CALL:
        f.callback()
        return True
    if f.action == A_STALL:
        time.sleep(f.delay_s)
        return True
    return False


# --------------------------------------------------------------- syscall shims
def pwrite(fd: int, buf, offset: int) -> int:
    f = _ACTIVE._consult(OP_WRITE) if _ACTIVE is not None else None
    if f is None:
        return os.pwrite(fd, buf, offset)
    if f.action in (A_TORN, A_SHORT):
        mv = memoryview(buf)
        keep = min(max(int(len(mv) * f.frac), 0), max(len(mv) - 1, 0))
        n = os.pwrite(fd, mv[:keep], offset) if keep else 0
        if f.action == A_TORN:
            raise InjectedCrash(
                f"torn write: {n} of {len(mv)} bytes persisted")
        return n
    if _soft(f):
        return os.pwrite(fd, buf, offset)
    _raise_for(f, OP_WRITE)


def preadv(fd: int, buffers, offset: int) -> int:
    f = _ACTIVE._consult(OP_READ) if _ACTIVE is not None else None
    if f is None:
        return os.preadv(fd, buffers, offset)
    if f.action == A_SHORT:
        mv = memoryview(buffers[0])
        keep = min(max(int(len(mv) * f.frac), 1), len(mv))
        return os.preadv(fd, [mv[:keep]], offset)
    if _soft(f):
        return os.preadv(fd, buffers, offset)
    _raise_for(f, OP_READ)   # crash / errno / torn all abort the read


def _fsync_fault(fd: int) -> Fault | None:
    f = _ACTIVE._consult(OP_FSYNC) if _ACTIVE is not None else None
    if f is None:
        return None
    if _soft(f):
        return None
    _raise_for(f, OP_FSYNC)


def fsync(fd: int) -> None:
    if _fsync_fault(fd) is None:
        os.fsync(fd)


def fdatasync(fd: int) -> None:
    if _fsync_fault(fd) is None:
        os.fdatasync(fd)


def replace(src: str, dst: str) -> None:
    f = (_ACTIVE._consult(OP_RENAME, path=f"{src}\x00{dst}")
         if _ACTIVE is not None else None)
    if f is None:
        return os.replace(src, dst)
    if _soft(f):
        return os.replace(src, dst)
    _raise_for(f, OP_RENAME)


def rmtree(path: str, *, ignore_errors: bool = False) -> None:
    """Recursive-delete shim (staging/aside/retired checkpoint trees).

    Consulted once per tree with the root path. A_TORN deletes a prefix of
    the tree's files bottom-up and then crashes, modelling death mid-GC:
    recovery must tolerate (and re-reap) half-deleted staging dirs.
    ``ignore_errors`` applies to the real deletion only — injected faults
    always surface, since swallowing them is exactly the bug class the
    chaos campaign exists to catch."""
    f = (_ACTIVE._consult(OP_RMTREE, path=path)
         if _ACTIVE is not None else None)
    if f is None:
        return shutil.rmtree(path, ignore_errors=ignore_errors)
    if f.action in (A_TORN, A_SHORT):
        victims = []
        for dirpath, _dirnames, filenames in os.walk(path):
            victims.extend(os.path.join(dirpath, n) for n in filenames)
        keep = min(max(int(len(victims) * f.frac), 0),
                   max(len(victims) - 1, 0))
        for p in victims[:keep]:
            try:
                os.remove(p)
            except OSError:
                pass
        if f.action == A_TORN:
            raise InjectedCrash(
                f"torn rmtree: {keep} of {len(victims)} files removed "
                f"under {path}")
        return   # short: partial delete, no crash — tree left half-reaped
    if _soft(f):
        return shutil.rmtree(path, ignore_errors=ignore_errors)
    _raise_for(f, OP_RMTREE)


def posix_fallocate(fd: int, offset: int, length: int) -> None:
    f = _ACTIVE._consult(OP_FALLOCATE) if _ACTIVE is not None else None
    if f is None:
        return os.posix_fallocate(fd, offset, length)
    if _soft(f):
        return os.posix_fallocate(fd, offset, length)
    _raise_for(f, OP_FALLOCATE)
    # note: an A_ERRNO here is swallowed by _open_files' best-effort
    # fallocate (by design — filesystems without fallocate); A_CRASH is a
    # RuntimeError and propagates


def gather(key: str) -> None:
    """Dirty-chunk D2H gather shim (delta fp128 path, DESIGN.md §14).

    Consulted once per dirty-chunk resolve, carrying the chunk's put key as
    the path so schedules can target specific chunks. Runs on the pipeline
    worker between the fingerprint diff and the chunk's ``stream.put`` —
    a crash here unwinds through the stream abort, so the step commits
    nothing (the manifest that would have referenced the never-copied
    chunk is never written)."""
    f = _ACTIVE._consult(OP_GATHER, path=key) if _ACTIVE is not None else None
    if f is None:
        return
    if _soft(f):
        return
    _raise_for(f, OP_GATHER)   # crash / errno / torn / short all abort


def file_write(f, data: bytes) -> None:
    """Buffered-file write shim (the manifest tmp-file path)."""
    flt = _ACTIVE._consult(OP_WRITE) if _ACTIVE is not None else None
    if flt is None:
        f.write(data)
        return
    if flt.action == A_SHORT:
        # libc's buffered write loops internally: a regular-file write
        # cannot land short without an error, so the fault is a full write
        f.write(data)
        return
    if flt.action == A_TORN:
        keep = min(max(int(len(data) * flt.frac), 0), max(len(data) - 1, 0))
        f.write(data[:keep])
        f.flush()
        raise InjectedCrash(
            f"torn write: {keep} of {len(data)} bytes persisted")
    if _soft(flt):
        f.write(data)
        return
    _raise_for(flt, OP_WRITE)


def remote_op(op: str, key: str) -> Fault | None:
    """Object-store request shim (core/remote.py ranged GET / PUT).

    Unlike the syscall shims this cannot perform the op itself — the store
    does the "I/O". crash/errno raise here (before any bytes move); soft
    and data-shaping actions (stall, short, torn) are returned for the
    store to apply at the protocol-appropriate point: a stalled request
    sleeps before first byte, a short GET returns a prefix of the range,
    a torn PUT persists a prefix of the staged object and crashes without
    ever making it visible (PUT visibility is atomic)."""
    f = _ACTIVE._consult(op, path=key) if _ACTIVE is not None else None
    if f is None:
        return None
    if f.action == A_CALL:
        f.callback()
        return None
    if f.action in (A_STALL, A_SHORT, A_TORN):
        return f
    _raise_for(f, op)


# ------------------------------------------------------- post-commit corruptors
def flip_byte(path: str, offset: int) -> None:
    """Invert one byte in place (the classic silent media corruption)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"offset {offset} beyond EOF of {path!r}")
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_file(path: str, keep_bytes: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def zero_file(path: str) -> None:
    """Model ext4-style crash journal replay: rename survived, data did not."""
    with open(path, "wb"):
        pass


def simulate_owner_death(root: str, *, backdate_s: float = 3600.0) -> int:
    """Make every ``.tmp-*`` staging dir under ``root`` look like its writer
    process died ``backdate_s`` ago: rewrite ownership pidfiles to a dead
    pid and backdate dir mtimes past the young-dir grace, so a fresh
    manager's ``_gc_tmp`` treats them exactly like a crashed trainer's.
    Returns the number of dirs marked."""
    import socket
    dead_pid = 2 ** 30 + 7    # beyond pid_max everywhere we run
    # crlint: allow(CRL006): backdating an mtime needs the wall clock
    then = time.time() - backdate_s
    marked = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        full = os.path.join(root, name)
        if ".tmp-" not in name or not os.path.isdir(full):
            continue
        from .checkpoint import OWNER_NAME  # runtime: avoid cycle
        pidfile = os.path.join(full, OWNER_NAME)
        if os.path.exists(pidfile):
            with open(pidfile, "w") as f:
                f.write(f"{dead_pid} {then:.3f} {socket.gethostname()}")
        os.utime(full, (then, then))
        marked += 1
    return marked


def referenced_chunks(root: str) -> dict[str, list]:
    """Map store-relative path ->
    [(offset, nbytes, crc32, hash, digest_kind, key), ...] for every
    store-resident reference in committed step manifests.

    ``digest_kind`` names the hash's digest function (manifest constants;
    None for extent/blob refs that carry no content address) so the
    scrubber verifies each span with the function that produced it. The
    FIRST chunk of a quantized fp128 shard gets hash=None: its write span
    includes the 20-byte packed header, which the fp128 digest domain
    excludes, so its content cannot be checked against the digest directly
    (CRC, when recorded, still covers it)."""
    from .checkpoint import _STEP_RE          # runtime: avoid cycle
    from .delta import STORE_PREFIX, is_chunked, store_rel
    from .manifest import DIGEST_FP128, Manifest
    refs: dict[str, list] = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return refs
    for name in names:
        if not _STEP_RE.match(name):
            continue
        try:
            m = Manifest.load(os.path.join(root, name))
        except ManifestError:
            continue
        quantized = set(m.extra.get("quantized", ()))
        for rec in m.tensors.values():
            for sh in rec.shards:
                if is_chunked(sh) and sh.chunks:
                    kind = sh.digest_kind
                    headered = (kind == DIGEST_FP128
                                and rec.key in quantized)
                    for j, r in enumerate(sh.chunks):
                        if r.path.startswith(STORE_PREFIX):
                            h = None if (headered and j == 0) else r.hash
                            refs.setdefault(store_rel(r.path), []).append(
                                (r.offset, r.nbytes, r.crc32, h, kind,
                                 rec.key))
                elif sh.path.startswith(STORE_PREFIX):
                    refs.setdefault(store_rel(sh.path), []).append(
                        (sh.offset, sh.nbytes, sh.crc32, None, None,
                         rec.key))
        for key, b in m.blobs.items():
            if b.path.startswith(STORE_PREFIX):
                refs.setdefault(store_rel(b.path), []).append(
                    (b.offset, b.nbytes, getattr(b, "crc32", None), None,
                     None, key))
    return refs


def corrupt_store_chunk(root: str, rng) -> tuple[str, int] | None:
    """Flip one byte inside a randomly chosen referenced chunk span.
    Returns (store-relative path, absolute flip offset) or None when the
    directory holds no store-resident references."""
    from .delta import CHUNKSTORE_DIR
    refs = referenced_chunks(root)
    candidates = [(rel, spans) for rel, spans in sorted(refs.items())
                  if os.path.exists(os.path.join(root, CHUNKSTORE_DIR, rel))]
    if not candidates:
        return None
    rel, spans = candidates[rng.randrange(len(candidates))]
    off, nbytes, _crc, _h, _kind, _key = spans[rng.randrange(len(spans))]
    flip_at = off + rng.randrange(max(nbytes, 1))
    flip_byte(os.path.join(root, CHUNKSTORE_DIR, rel), flip_at)
    return rel, flip_at


# ------------------------------------------------------------------ scrubber
@dataclass
class ScrubReport:
    files_scanned: int = 0
    chunks_checked: int = 0
    corrupt: list = field(default_factory=list)      # store-rel paths found bad
    repaired: list = field(default_factory=list)     # refetched from level 1
    quarantined: list = field(default_factory=list)  # moved aside

    @property
    def clean(self) -> bool:
        return not self.corrupt

    def summary(self) -> str:
        return (f"scrub: {self.files_scanned} files / "
                f"{self.chunks_checked} chunks checked, "
                f"{len(self.corrupt)} corrupt "
                f"({len(self.repaired)} repaired, "
                f"{len(self.quarantined)} quarantined)")


def _verify_spans(path: str, spans) -> tuple[int, bool]:
    """(spans checked, all good). A span verifies by CRC when recorded,
    else by recomputing its content hash with the digest kind that
    produced it (blake2b or fp128 — fp128 chunk digests cover exactly the
    written span, quantized first-chunks excepted, see
    ``referenced_chunks``), else by being readable at its extent."""
    import hashlib
    from .manifest import DIGEST_FP128
    checked = 0
    try:
        with open(path, "rb") as f:
            for off, nbytes, crc, h, kind, _key in spans:
                f.seek(off)
                data = f.read(nbytes)
                checked += 1
                if len(data) != nbytes:
                    return checked, False
                if crc is not None:
                    if zlib.crc32(data) & 0xFFFFFFFF != crc:
                        return checked, False
                elif h is not None:
                    if kind == DIGEST_FP128:
                        from ..kernels.fingerprint import digest_bytes
                        if digest_bytes(data) != h:
                            return checked, False
                    elif hashlib.blake2b(
                            data, digest_size=16).hexdigest() != h:
                        return checked, False
    except OSError:
        return checked, False
    return checked, True


def scrub_store(root: str, *, remote_root: str | None = None) -> ScrubReport:
    """Verify every store file the kept steps reference, span by span.

    A file failing verification is repaired from ``remote_root``'s mirror
    of the store (level 1) when that copy verifies, else moved to
    ``<root>/chunkstore/quarantine/<rel>`` — out of the restore path, but
    kept for forensics. Quarantined chunks make dependent restores fail
    with ``QuarantinedChunkError`` instead of a CRC mismatch deep in the
    read stream (see ``check_quarantined``)."""
    from .delta import CHUNKSTORE_DIR
    store = os.path.join(root, CHUNKSTORE_DIR)
    report = ScrubReport()
    refs = referenced_chunks(root)
    for rel in sorted(refs):
        spans = refs[rel]
        fp = os.path.join(store, rel)
        report.files_scanned += 1
        checked, good = _verify_spans(fp, spans)
        report.chunks_checked += checked
        if good:
            continue
        report.corrupt.append(rel)
        if remote_root is not None and _repair_from(
                remote_root, store, rel, spans):
            report.repaired.append(rel)
            continue
        _quarantine(store, rel)
        report.quarantined.append(rel)
    return report


def _repair_from(remote_root: str, store: str, rel: str, spans) -> bool:
    """Refetch one store file from the level-1 mirror, verify, land it
    atomically. Returns False when no (good) mirror copy exists."""
    import shutil
    from .delta import CHUNKSTORE_DIR
    src = os.path.join(remote_root, CHUNKSTORE_DIR, rel)
    if not os.path.exists(src):
        return False
    _checked, good = _verify_spans(src, spans)
    if not good:
        return False     # mirror is corrupt too: quarantine instead
    dst = os.path.join(store, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = dst + ".repair"
    shutil.copyfile(src, tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, dst)
    return True


def _quarantine(store: str, rel: str) -> None:
    src = os.path.join(store, rel)
    if not os.path.exists(src):
        return           # already missing — nothing to move aside
    dst = os.path.join(store, QUARANTINE_SUBDIR, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.replace(src, dst)


def check_quarantined(ckpt_dir: str, manifest) -> None:
    """Raise ``QuarantinedChunkError`` if the manifest references a store
    file that is missing from the store but present under quarantine.
    Called at the top of every restore: a typed, named failure beats a
    FileNotFoundError from deep inside the read pipeline."""
    from .delta import CHUNKSTORE_DIR, STORE_PREFIX, is_chunked, store_rel
    root = os.path.dirname(os.path.abspath(ckpt_dir))
    store = os.path.join(root, CHUNKSTORE_DIR)
    qdir = os.path.join(store, QUARANTINE_SUBDIR)
    if not os.path.isdir(qdir):
        return
    seen: set[str] = set()

    def _check(path: str, key: str, chunk_hash: str | None):
        rel = store_rel(path)
        if rel in seen:
            return
        seen.add(rel)
        if not os.path.exists(os.path.join(store, rel)) and os.path.exists(
                os.path.join(qdir, rel)):
            raise QuarantinedChunkError(rel, key, chunk_hash)

    for rec in manifest.tensors.values():
        for sh in rec.shards:
            if is_chunked(sh) and sh.chunks:
                for r in sh.chunks:
                    if r.path.startswith(STORE_PREFIX):
                        _check(r.path, rec.key, r.hash)
            elif sh.path.startswith(STORE_PREFIX):
                _check(sh.path, rec.key, None)
    for key, b in manifest.blobs.items():
        if b.path.startswith(STORE_PREFIX):
            _check(b.path, key, None)
