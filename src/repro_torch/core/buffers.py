"""Aligned, reusable host buffer pool.

The paper's Fig 13–14 finding: dynamic per-read allocation dominates restore time;
preallocated, reusable, page-aligned buffers nearly double restore throughput.
This pool is that fix. Buffers are mmap-backed (page-aligned by construction,
satisfying O_DIRECT alignment) and size-classed in powers of two so a buffer
released by one tensor is reusable by the next.
"""

from __future__ import annotations

import ctypes
import mmap
import threading

from . import trace
from dataclasses import dataclass, field

PAGE = mmap.PAGESIZE  # typically 4096; also the O_DIRECT alignment quantum


def align_up(n: int, quantum: int = PAGE) -> int:
    return (n + quantum - 1) // quantum * quantum


def aligned_span(offset: int, nbytes: int, quantum: int = PAGE) -> tuple[int, int]:
    """Expand a logical byte range to alignment boundaries.

    Returns ``(start, span)`` with ``start % quantum == 0`` and
    ``span % quantum == 0`` covering ``[offset, offset + nbytes)`` — the shape
    an O_DIRECT read/write of that range must take (tiered prefetch pulls
    manifest extents as aligned spans; see DESIGN.md §8)."""
    start = offset - offset % quantum
    return start, align_up(offset + nbytes - start, quantum)


class AlignedBuffer:
    """A page-aligned host buffer backed by anonymous mmap."""

    __slots__ = ("mm", "nbytes", "address", "pool", "size_class", "_mv")

    def __init__(self, nbytes: int, pool: "BufferPool | None" = None,
                 size_class: int | None = None):
        nbytes = align_up(max(nbytes, PAGE))
        self.mm = mmap.mmap(-1, nbytes)
        self.nbytes = nbytes
        self.address = ctypes.addressof(ctypes.c_char.from_buffer(self.mm))
        self.pool = pool
        self.size_class = size_class if size_class is not None else nbytes
        self._mv = memoryview(self.mm)

    def view(self, offset: int = 0, nbytes: int | None = None) -> memoryview:
        end = self.nbytes if nbytes is None else offset + nbytes
        return self._mv[offset:end]

    def write_bytes(self, data, offset: int = 0) -> int:
        n = len(data)
        self._mv[offset:offset + n] = data
        return n

    def release(self) -> None:
        if self.pool is not None:
            self.pool.put(self)

    def destroy(self) -> None:
        pool, self.pool = self.pool, None
        if pool is not None:
            # destroyed without passing through put() (e.g. a janitor reaping
            # a straggling transfer): settle the outstanding-byte books so
            # acquire() budgets don't leak
            pool._forget(self)
        try:
            self._mv.release()
            self.mm.close()
        except (BufferError, ValueError):
            # Outstanding exported views (e.g. np.frombuffer slices) keep the
            # mapping alive; the munmap happens when they are GC'd. The
            # allocation-cost accounting (what the disabled-pool mode models)
            # already happened at get().
            pass

    def __len__(self) -> int:
        return self.nbytes


@dataclass
class PoolStats:
    allocations: int = 0      # fresh mmap allocations
    reuses: int = 0           # satisfied from the free list
    released: int = 0
    bytes_allocated: int = 0
    high_water_bytes: int = 0
    peak_outstanding_bytes: int = 0   # max bytes handed out and unreleased
    by_class: dict = field(default_factory=dict)

    @property
    def reuse_rate(self) -> float:
        total = self.allocations + self.reuses
        return self.reuses / total if total else 0.0


class StageBudget:
    """In-flight staged-byte accounting for streaming transfer loops.

    The snapshot pipeline (engines.aggregated save stream), the restore
    pipeline (its read stream), and the tiered transfer engine all stage data
    through pooled buffers; this is the shared backpressure primitive that
    caps how many staged bytes may be in flight at once. ``limit=None`` disables the cap. Not thread-safe by design — each
    user drives its own single-threaded submit/reap loop and consults the
    budget only from that loop (cross-thread blocking waits go through
    ``BufferPool.acquire`` instead).
    """

    __slots__ = ("limit", "in_flight", "peak")

    def __init__(self, limit: int | None):
        self.limit = limit
        self.in_flight = 0
        self.peak = 0

    def admits(self, nbytes: int) -> bool:
        """True if staging ``nbytes`` more fits the budget. Always grants
        when nothing is in flight so one oversized request can't deadlock."""
        return (self.limit is None or self.in_flight == 0
                or self.in_flight + nbytes <= self.limit)

    def add(self, nbytes: int) -> None:
        self.in_flight += nbytes
        self.peak = max(self.peak, self.in_flight)

    def sub(self, nbytes: int) -> None:
        self.in_flight -= nbytes

    def settle(self) -> None:
        """Zero the in-flight books (abort paths: every staged buffer was
        force-released, so the next loop on this budget must start clean)."""
        self.in_flight = 0


class BufferPool:
    """Size-classed (power-of-two ≥ 1 page) pool of AlignedBuffers.

    ``get`` either reuses a free buffer of the right class or allocates fresh.
    ``disabled=True`` models DataStates-LLM's dynamic-allocation behaviour for
    the bench_restore_alloc experiment: every get() is a fresh mmap and
    released buffers are destroyed.
    """

    def __init__(self, disabled: bool = False, max_cached_bytes: int | None = None,
                 max_outstanding_bytes: int | None = None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # crlint: guarded-by(_lock, _cond)
        self._free: dict[int, list[AlignedBuffer]] = {}
        self.disabled = disabled
        self.max_cached_bytes = max_cached_bytes
        self.max_outstanding_bytes = max_outstanding_bytes  # acquire() budget
        # crlint: guarded-by(_lock, _cond)
        self._cached_bytes = 0
        # crlint: guarded-by(_lock, _cond)
        self._outstanding = 0     # bytes handed out and not yet released
        self.stats = PoolStats()

    @staticmethod
    def size_class(nbytes: int) -> int:
        nbytes = max(nbytes, PAGE)
        return 1 << (nbytes - 1).bit_length()

    @property
    def outstanding_bytes(self) -> int:
        # crlint: allow(CRL003): deliberately racy stats read — a single
        # int load for dashboards; callers never branch durability on it
        return self._outstanding

    def get(self, nbytes: int) -> AlignedBuffer:
        with self._lock:
            return self._get_locked(self.size_class(nbytes))

    def acquire(self, nbytes: int, budget: int | None = None,
                timeout: float | None = None) -> AlignedBuffer:
        """Blocking bounded ``get``: waits until granting ``nbytes`` keeps the
        pool's outstanding (handed-out, unreleased) bytes within ``budget``
        (default: ``max_outstanding_bytes``). A request is always granted when
        nothing is outstanding, so one oversized buffer can't deadlock.
        Raises TimeoutError after ``timeout`` seconds."""
        cls = self.size_class(nbytes)
        limit = self.max_outstanding_bytes if budget is None else budget
        deadline = None if timeout is None else trace.clock() + timeout
        with self._cond:
            while (limit is not None and self._outstanding
                   and self._outstanding + cls > limit):
                remaining = None if deadline is None \
                    else deadline - trace.clock()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"buffer budget exhausted: {self._outstanding} B "
                        f"outstanding, want {cls} B under a {limit} B budget")
                self._cond.wait(0.5 if remaining is None else min(remaining, 0.5))
            return self._get_locked(cls)

    def _get_locked(self, cls: int) -> AlignedBuffer:  # crlint: holds(_lock)
        buf = None
        if not self.disabled:
            lst = self._free.get(cls)
            if lst:
                buf = lst.pop()
                self._cached_bytes -= buf.nbytes
                self.stats.reuses += 1
        if buf is None:
            buf = AlignedBuffer(cls, pool=self, size_class=cls)
            self.stats.allocations += 1
            self.stats.bytes_allocated += buf.nbytes
            self.stats.by_class[cls] = self.stats.by_class.get(cls, 0) + 1
            self.stats.high_water_bytes = max(
                self.stats.high_water_bytes, self.stats.bytes_allocated)
        self._outstanding += buf.nbytes
        self.stats.peak_outstanding_bytes = max(
            self.stats.peak_outstanding_bytes, self._outstanding)
        return buf

    def put(self, buf: AlignedBuffer) -> None:
        with self._cond:
            self.stats.released += 1
            self._outstanding -= buf.nbytes
            self._cond.notify_all()
            if self.disabled or (
                    self.max_cached_bytes is not None
                    and self._cached_bytes + buf.nbytes > self.max_cached_bytes):
                self.stats.bytes_allocated -= buf.nbytes
                buf.pool = None   # books settled here; destroy must not _forget
                buf.destroy()
                return
            self._free.setdefault(buf.size_class, []).append(buf)
            self._cached_bytes += buf.nbytes

    def _forget(self, buf: AlignedBuffer) -> None:
        """A handed-out buffer was destroyed without release(): drop it from
        the outstanding and allocation books (called from destroy())."""
        with self._cond:
            self._outstanding -= buf.nbytes
            self.stats.bytes_allocated -= buf.nbytes
            self._cond.notify_all()

    def preallocate(self, sizes) -> None:
        """Warm the pool (the paper's 'preallocated buffers' mode)."""
        bufs = [self.get(s) for s in sizes]
        for b in bufs:
            b.release()

    def free_buffers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())

    def drain(self) -> None:
        with self._lock:
            for lst in self._free.values():
                for b in lst:
                    self.stats.bytes_allocated -= b.nbytes
                    b.pool = None   # free-list buffers aren't outstanding
                    b.destroy()
            self._free.clear()
            self._cached_bytes = 0
