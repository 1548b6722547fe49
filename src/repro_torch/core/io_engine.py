"""I/O engine abstraction: io_uring / thread-pool / blocking POSIX backends.

The paper benchmarks liburing against POSIX under checkpoint workloads; this
module is that axis. All engines consume the same ``IORequest`` stream so the
aggregation strategies and C/R engines above them are backend-agnostic.

- ``UringEngine``    — batched async submission via repro.core.uring (the paper's
                       subject). Supports registered ("fixed") buffers and deep
                       submission queues; completions reaped in batches.
- ``ThreadPoolEngine``— portability fallback: pread/pwrite on a worker pool (the
                       GIL is released inside the syscalls, so I/O overlaps).
- ``PosixEngine``    — the paper's POSIX baseline: sequential blocking pwrite /
                       pread in submission order, one syscall per object.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

from . import faults, trace
from .buffers import AlignedBuffer, PAGE, align_up
from .uring import IoUring, probe_io_uring

OP_READ = "read"
OP_WRITE = "write"
OP_FSYNC = "fsync"


@dataclass
class IORequest:
    op: str
    fd: int
    offset: int = 0
    buffer: AlignedBuffer | None = None
    buf_offset: int = 0
    nbytes: int = 0
    user_data: int = 0
    buf_index: int | None = None  # registered-buffer slot (uring fixed ops)

    @property
    def addr(self) -> int:
        assert self.buffer is not None
        return self.buffer.address + self.buf_offset

    def view(self) -> memoryview:
        assert self.buffer is not None
        return self.buffer.view(self.buf_offset, self.nbytes)


@dataclass
class Completion:
    user_data: int
    nbytes: int
    error: BaseException | None = None   # set iff engine.capture_errors


@dataclass
class EngineStats:
    submissions: int = 0      # io_uring_enter / syscall batches
    ops: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    short_retries: int = 0
    max_inflight: int = 0

    def merge_op(self, op: str, nbytes: int) -> None:
        self.ops += 1
        if op == OP_WRITE:
            self.bytes_written += nbytes
        elif op == OP_READ:
            self.bytes_read += nbytes

    def as_dict(self) -> dict:
        """Flat dict for per-tier attribution in benchmark/flush reports."""
        return {"submissions": self.submissions, "ops": self.ops,
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "short_retries": self.short_retries,
                "max_inflight": self.max_inflight}


class IOEngine:
    """Base: synchronous convenience on top of submit/poll primitives."""

    name = "base"

    def __init__(self):
        self.stats = EngineStats()
        # True: a failed op is reported as Completion(error=...) instead of
        # raising from poll() — required by callers that hedge requests and
        # must tolerate one attempt failing while another succeeds
        self.capture_errors = False
        # trace track for this engine's submit→completion spans; owners
        # re-tag per role (tiered flush engines are "level1", remote "remote")
        self.tier = "level0"

    # --- async primitives (overridden) ---
    def submit(self, reqs: list[IORequest]) -> None:
        raise NotImplementedError

    def poll(self, min_n: int = 0,
             timeout_s: float | None = None) -> list[Completion]:
        """Reap completions. ``min_n`` > 0 blocks for at least that many;
        ``timeout_s`` bounds the block (hedging needs timed waits) — a timed
        poll may return fewer than ``min_n`` completions, including none."""
        raise NotImplementedError

    @property
    def inflight(self) -> int:
        raise NotImplementedError

    # --- sync convenience ---
    def run(self, reqs: list[IORequest], queue_depth: int = 64) -> list[Completion]:
        """Submit all requests with bounded queue depth; wait for everything."""
        out: list[Completion] = []
        i = 0
        n = len(reqs)
        while i < n or self.inflight:
            room = queue_depth - self.inflight
            if room > 0 and i < n:
                batch = reqs[i:i + room]
                self.submit(batch)
                i += len(batch)
            if self.inflight:
                out.extend(self.poll(min_n=1 if i >= n or self.inflight >= queue_depth else 0))
        out.extend(self.poll(min_n=0))  # drain engines that complete inline
        return out

    def fsync(self, fd: int, datasync: bool = True) -> None:
        with trace.span("io.fsync", tier=self.tier):
            if datasync:
                faults.fdatasync(fd)
            else:
                faults.fsync(fd)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UringEngine(IOEngine):
    """Kernel-accelerated batched async I/O (the paper's liburing)."""

    name = "uring"

    def __init__(self, entries: int = 256, sqpoll: bool = False,
                 fixed_buffers: list[AlignedBuffer] | None = None):
        super().__init__()
        self.ring = IoUring(entries=entries, sqpoll=sqpoll)
        self._pending: dict[int, IORequest] = {}
        self._t_submit: dict[int, float] = {}   # token -> clock() at submit
        self._backlog: list[Completion] = []
        self._next_token = 0
        self._fixed_index: dict[int, int] = {}
        if fixed_buffers:
            self.ring.register_buffers(fixed_buffers)
            self._fixed_index = {id(b): i for i, b in enumerate(fixed_buffers)}

    def _token(self) -> int:
        self._next_token += 1
        return self._next_token

    def _prep(self, r: IORequest, token: int) -> None:
        if r.op == OP_FSYNC:
            self.ring.prep_fsync(r.fd, user_data=token)
            return
        buf_index = r.buf_index
        if buf_index is None and r.buffer is not None:
            buf_index = self._fixed_index.get(id(r.buffer))
        if r.op == OP_WRITE:
            if buf_index is not None:
                self.ring.prep_write_fixed(r.fd, r.addr, r.nbytes, r.offset,
                                           token, buf_index)
            else:
                self.ring.prep_write(r.fd, r.addr, r.nbytes, r.offset, token)
        elif r.op == OP_READ:
            if buf_index is not None:
                self.ring.prep_read_fixed(r.fd, r.addr, r.nbytes, r.offset,
                                          token, buf_index)
            else:
                self.ring.prep_read(r.fd, r.addr, r.nbytes, r.offset, token)
        else:
            raise ValueError(r.op)

    def submit(self, reqs: list[IORequest]) -> None:
        traced = trace.is_enabled()
        for r in reqs:
            token = self._token()
            self._pending[token] = r
            if traced:
                self._t_submit[token] = trace.clock()
            self._prep(r, token)
        if reqs:
            self.ring.submit()
            self.stats.submissions += 1
            self.stats.max_inflight = max(self.stats.max_inflight,
                                          len(self._pending))

    @property
    def inflight(self) -> int:
        return len(self._pending)

    def poll(self, min_n: int = 0,
             timeout_s: float | None = None) -> list[Completion]:
        out: list[Completion] = []
        if self._backlog:
            out, self._backlog = self._backlog, []
            min_n = max(0, min_n - len(out))
            if not min_n:
                out.extend(self._reap(0))
                return out
        if min_n and timeout_s is not None:
            # timed wait: spin on non-blocking reaps until deadline.
            # min_n was already decremented by any backlog drained above,
            # so count only newly reaped completions against it.
            deadline = trace.clock() + timeout_s
            got = 0
            while got < min_n:
                new = self._reap(0)
                out.extend(new)
                got += len(new)
                if got >= min_n or trace.clock() >= deadline:
                    break
                time.sleep(0.0005)
            return out
        out.extend(self._reap(min_n))
        return out

    def _reap(self, min_n: int) -> list[Completion]:
        cqes = self.ring.wait_cqes(min_n) if min_n else self.ring.peek_cqes()
        out: list[Completion] = []
        for c in cqes:
            r = self._pending.pop(c.user_data)
            t0 = self._t_submit.pop(c.user_data, None)
            if t0 is not None:   # submit→completion pair on this tier's track
                trace.complete(f"io.{r.op}", t0, tier=self.tier,
                               nbytes=r.nbytes)
            if c.res < 0:
                err = OSError(-c.res,
                              f"{r.op} failed: {os.strerror(-c.res)} "
                              f"(fd={r.fd} off={r.offset} n={r.nbytes})")
                if self.capture_errors:
                    out.append(Completion(r.user_data, 0, err))
                    continue
                raise err
            if r.op != OP_FSYNC and c.res < r.nbytes:
                # short read/write: resubmit the remainder
                self.stats.short_retries += 1
                rem = IORequest(r.op, r.fd, r.offset + c.res, r.buffer,
                                r.buf_offset + c.res, r.nbytes - c.res,
                                r.user_data, r.buf_index)
                self.stats.merge_op(r.op, c.res)
                self.submit([rem])
                continue
            self.stats.merge_op(r.op, c.res if r.op != OP_FSYNC else 0)
            out.append(Completion(r.user_data, c.res))
        return out

    def fsync(self, fd: int, datasync: bool = True) -> None:
        token = self._token()
        self._pending[token] = IORequest(OP_FSYNC, fd, user_data=token)
        if trace.is_enabled():
            self._t_submit[token] = trace.clock()
        self.ring.prep_fsync(fd, user_data=token, datasync=datasync)
        self.ring.submit()
        self.stats.submissions += 1
        # Wait for this fsync; completions of other in-flight ops observed
        # while waiting are stashed for the next poll().
        while token in self._pending:
            done = self._reap(min_n=1)
            self._backlog.extend(c for c in done if c.user_data != token)

    def close(self) -> None:
        self.ring.close()


class ThreadPoolEngine(IOEngine):
    """pread/pwrite worker pool — async via OS threads (GIL released in I/O)."""

    name = "threadpool"

    def __init__(self, workers: int = 8):
        super().__init__()
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="io")
        self._lock = threading.Lock()
        # crlint: guarded-by(_lock)
        self._futs: dict = {}

    @staticmethod
    def _do(r: IORequest) -> int:
        # syscalls route through the fault-injection shims (pass-through
        # when no FaultPlan is armed) — also the PosixEngine's data path
        if r.op == OP_WRITE:
            mv = r.view()
            total = 0
            while total < r.nbytes:
                total += faults.pwrite(r.fd, mv[total:], r.offset + total)
            return total
        elif r.op == OP_READ:
            # preadv fills the caller's (aligned) buffer — required for O_DIRECT
            mv = r.view()
            total = 0
            while total < r.nbytes:
                n = faults.preadv(r.fd, [mv[total:]], r.offset + total)
                if n == 0:
                    raise EOFError(f"pread hit EOF at {r.offset + total}")
                total += n
            return total
        elif r.op == OP_FSYNC:
            faults.fdatasync(r.fd)
            return 0
        raise ValueError(r.op)

    def _do_traced(self, r: IORequest) -> int:
        # runs on the io worker thread: the span lands in that thread's
        # ring, so worker-side I/O visibly overlaps the submitter's stages
        with trace.span(f"io.{r.op}", tier=self.tier, nbytes=r.nbytes):
            return self._do(r)

    def submit(self, reqs: list[IORequest]) -> None:
        with self._lock:
            for r in reqs:
                self._futs[self.pool.submit(self._do_traced, r)] = r
            self.stats.submissions += 1
            self.stats.max_inflight = max(self.stats.max_inflight,
                                          len(self._futs))

    @property
    def inflight(self) -> int:
        # crlint: allow(CRL003): racy len() read is the contract — callers
        # loop `while io.inflight: poll()`, and poll() re-checks under lock
        return len(self._futs)

    def poll(self, min_n: int = 0,
             timeout_s: float | None = None) -> list[Completion]:
        with self._lock:
            futs = list(self._futs)
        if not futs:
            return []
        done, _ = wait(futs, return_when="FIRST_COMPLETED" if min_n else "ALL_COMPLETED",
                       timeout=timeout_s if min_n else 0)
        out = []
        with self._lock:
            for f in done:
                r = self._futs.pop(f, None)
                if r is None:
                    continue
                try:
                    n = f.result()
                except BaseException as e:
                    if self.capture_errors:
                        out.append(Completion(r.user_data, 0, e))
                        continue
                    raise
                self.stats.merge_op(r.op, n)
                out.append(Completion(r.user_data, n))
        return out

    def close(self) -> None:
        self.pool.shutdown(wait=True)


class PosixEngine(IOEngine):
    """The paper's POSIX baseline: blocking, sequential, one syscall per op."""

    name = "posix"

    def __init__(self):
        super().__init__()
        self._done: list[Completion] = []

    def submit(self, reqs: list[IORequest]) -> None:
        for r in reqs:
            self.stats.submissions += 1
            try:
                with trace.span(f"io.{r.op}", tier=self.tier,
                                nbytes=r.nbytes):
                    n = ThreadPoolEngine._do(r)  # same loop, executed inline
            except BaseException as e:
                if self.capture_errors:
                    self._done.append(Completion(r.user_data, 0, e))
                    continue
                raise
            self.stats.merge_op(r.op, n)
            self._done.append(Completion(r.user_data, n))

    @property
    def inflight(self) -> int:
        return 0

    def poll(self, min_n: int = 0,
             timeout_s: float | None = None) -> list[Completion]:
        out, self._done = self._done, []
        return out


_ENGINES = {
    "uring": UringEngine,
    "threadpool": ThreadPoolEngine,
    "posix": PosixEngine,
}


def resolve_backend(name: str = "auto") -> str:
    """'auto' prefers io_uring, falls back to threads (single policy point)."""
    if name == "auto":
        return "uring" if probe_io_uring() else "threadpool"
    return name


def make_engine(name: str = "auto", **kw) -> IOEngine:
    """Engine factory."""
    return _ENGINES[resolve_backend(name)](**kw)


def open_for(path: str, mode: str, direct: bool = False,
             create_dirs: bool = True) -> int:
    """Open a file for engine I/O. mode in {'r','w','rw'}."""
    if create_dirs and mode != "r":
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flags = {"r": os.O_RDONLY, "w": os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
             "rw": os.O_CREAT | os.O_RDWR}[mode]
    if direct:
        flags |= os.O_DIRECT
    try:
        return os.open(path, flags, 0o644)
    except OSError:
        if direct:  # filesystem without O_DIRECT: degrade gracefully
            return os.open(path, flags & ~os.O_DIRECT, 0o644)
        raise
