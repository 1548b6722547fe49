"""Raw io_uring binding via ctypes — the paper's liburing, without the C shim.

Implements the io_uring syscall ABI directly (x86_64 syscall numbers 425/426/427),
mmap'd submission/completion rings, 64-byte SQEs, registered buffers and files.
This is the kernel-accelerated I/O backend the paper characterizes; see DESIGN.md §2.

Only the opcodes the checkpoint/restore path needs are exposed:
READ / WRITE / READ_FIXED / WRITE_FIXED / FSYNC / NOP.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import mmap
import os
import struct
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Syscall numbers (x86_64)
# ---------------------------------------------------------------------------
SYS_io_uring_setup = 425
SYS_io_uring_enter = 426
SYS_io_uring_register = 427

# mmap offsets for the three ring regions
IORING_OFF_SQ_RING = 0
IORING_OFF_CQ_RING = 0x8000000
IORING_OFF_SQES = 0x10000000

# io_uring_enter flags
IORING_ENTER_GETEVENTS = 1 << 0
IORING_ENTER_SQ_WAKEUP = 1 << 1

# setup flags
IORING_SETUP_IOPOLL = 1 << 0
IORING_SETUP_SQPOLL = 1 << 1
IORING_SETUP_CQSIZE = 1 << 3

# features
IORING_FEAT_SINGLE_MMAP = 1 << 0
IORING_FEAT_NODROP = 1 << 1

# sq ring flags (read from kernel)
IORING_SQ_NEED_WAKEUP = 1 << 0

# register opcodes
IORING_REGISTER_BUFFERS = 0
IORING_UNREGISTER_BUFFERS = 1
IORING_REGISTER_FILES = 2
IORING_UNREGISTER_FILES = 3

# sqe opcodes (subset)
IORING_OP_NOP = 0
IORING_OP_READV = 1
IORING_OP_WRITEV = 2
IORING_OP_FSYNC = 3
IORING_OP_READ_FIXED = 4
IORING_OP_WRITE_FIXED = 5
IORING_OP_READ = 22
IORING_OP_WRITE = 23

IORING_FSYNC_DATASYNC = 1 << 0

SQE_SIZE = 64
CQE_SIZE = 16

_libc = ctypes.CDLL(None, use_errno=True)
_libc.syscall.restype = ctypes.c_long


class _SqringOffsets(ctypes.Structure):
    _fields_ = [
        ("head", ctypes.c_uint32),
        ("tail", ctypes.c_uint32),
        ("ring_mask", ctypes.c_uint32),
        ("ring_entries", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("dropped", ctypes.c_uint32),
        ("array", ctypes.c_uint32),
        ("resv1", ctypes.c_uint32),
        ("user_addr", ctypes.c_uint64),
    ]


class _CqringOffsets(ctypes.Structure):
    _fields_ = [
        ("head", ctypes.c_uint32),
        ("tail", ctypes.c_uint32),
        ("ring_mask", ctypes.c_uint32),
        ("ring_entries", ctypes.c_uint32),
        ("overflow", ctypes.c_uint32),
        ("cqes", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("resv1", ctypes.c_uint32),
        ("user_addr", ctypes.c_uint64),
    ]


class IoUringParams(ctypes.Structure):
    _fields_ = [
        ("sq_entries", ctypes.c_uint32),
        ("cq_entries", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("sq_thread_cpu", ctypes.c_uint32),
        ("sq_thread_idle", ctypes.c_uint32),
        ("features", ctypes.c_uint32),
        ("wq_fd", ctypes.c_uint32),
        ("resv", ctypes.c_uint32 * 3),
        ("sq_off", _SqringOffsets),
        ("cq_off", _CqringOffsets),
    ]


class _Iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


@dataclass(frozen=True)
class Cqe:
    """One completion-queue entry."""

    user_data: int
    res: int  # >=0: bytes transferred; <0: -errno
    flags: int


class UringError(OSError):
    pass


def _check(ret: int, what: str) -> int:
    if ret < 0:
        err = ctypes.get_errno()
        raise UringError(err, f"{what}: {os.strerror(err)}")
    return ret


def probe_io_uring() -> bool:
    """True if the kernel/container permits io_uring."""
    params = IoUringParams()
    fd = _libc.syscall(SYS_io_uring_setup, 4, ctypes.byref(params))
    if fd < 0:
        return False
    os.close(fd)
    return True


class IoUring:
    """A single io_uring instance: submission + completion rings.

    Not thread-safe by itself; the engine layer serializes submissions and may
    reap completions from a dedicated thread (reaping and submitting touch
    disjoint ring words, and the GIL orders the python-side bookkeeping).
    """

    def __init__(self, entries: int = 256, sqpoll: bool = False,
                 sqpoll_idle_ms: int = 2000):
        if entries & (entries - 1):
            raise ValueError("entries must be a power of two")
        params = IoUringParams()
        if sqpoll:
            params.flags |= IORING_SETUP_SQPOLL
            params.sq_thread_idle = sqpoll_idle_ms
        fd = _libc.syscall(SYS_io_uring_setup, entries, ctypes.byref(params))
        if fd < 0 and sqpoll:
            # SQPOLL may need privileges; retry without.
            params = IoUringParams()
            fd = _libc.syscall(SYS_io_uring_setup, entries, ctypes.byref(params))
            sqpoll = False
        _check(fd, "io_uring_setup")
        self.fd = fd
        self.params = params
        self.sqpoll = sqpoll
        self.sq_entries = params.sq_entries
        self.cq_entries = params.cq_entries

        sq_sz = params.sq_off.array + params.sq_entries * 4
        cq_sz = params.cq_off.cqes + params.cq_entries * CQE_SIZE
        single = bool(params.features & IORING_FEAT_SINGLE_MMAP)
        if single:
            sz = max(sq_sz, cq_sz)
            self._sq_mm = mmap.mmap(fd, sz, flags=mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0),
                                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                    offset=IORING_OFF_SQ_RING)
            self._cq_mm = self._sq_mm
        else:
            self._sq_mm = mmap.mmap(fd, sq_sz, flags=mmap.MAP_SHARED,
                                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                    offset=IORING_OFF_SQ_RING)
            self._cq_mm = mmap.mmap(fd, cq_sz, flags=mmap.MAP_SHARED,
                                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                    offset=IORING_OFF_CQ_RING)
        self._sqe_mm = mmap.mmap(fd, params.sq_entries * SQE_SIZE,
                                 flags=mmap.MAP_SHARED,
                                 prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                 offset=IORING_OFF_SQES)

        so, co = params.sq_off, params.cq_off
        self._sq_head_off = so.head
        self._sq_tail_off = so.tail
        self._sq_mask = self._u32(self._sq_mm, so.ring_mask)
        self._sq_flags_off = so.flags
        self._sq_dropped_off = so.dropped
        self._sq_array_off = so.array
        self._cq_head_off = co.head
        self._cq_tail_off = co.tail
        self._cq_mask = self._u32(self._cq_mm, co.ring_mask)
        self._cqes_off = co.cqes
        self._to_submit = 0  # sqes written but not yet passed to enter()
        self._inflight = 0
        self._registered_bufs: list | None = None

        # Pre-fill the SQ index array once: we always use slot i -> sqe i.
        for i in range(self.sq_entries):
            self._put_u32(self._sq_mm, self._sq_array_off + 4 * i, i)

    # -- ring word accessors ------------------------------------------------
    @staticmethod
    def _u32(mm, off) -> int:
        return struct.unpack_from("<I", mm, off)[0]

    @staticmethod
    def _put_u32(mm, off, val) -> None:
        struct.pack_into("<I", mm, off, val & 0xFFFFFFFF)

    # -- capacity -----------------------------------------------------------
    def sq_space(self) -> int:
        head = self._u32(self._sq_mm, self._sq_head_off)
        tail = self._u32(self._sq_mm, self._sq_tail_off)
        return self.sq_entries - (tail - head) % (1 << 32)

    @property
    def inflight(self) -> int:
        return self._inflight

    # -- registration -------------------------------------------------------
    def register_buffers(self, buffers) -> None:
        """Register fixed buffers; each must expose .address and .nbytes."""
        n = len(buffers)
        iovs = (_Iovec * n)()
        for i, b in enumerate(buffers):
            iovs[i].iov_base = b.address
            iovs[i].iov_len = b.nbytes
        ret = _libc.syscall(SYS_io_uring_register, self.fd,
                            IORING_REGISTER_BUFFERS, ctypes.byref(iovs), n)
        _check(ret, "io_uring_register(BUFFERS)")
        self._registered_bufs = list(buffers)

    def unregister_buffers(self) -> None:
        ret = _libc.syscall(SYS_io_uring_register, self.fd,
                            IORING_UNREGISTER_BUFFERS, None, 0)
        _check(ret, "io_uring_register(UNREGISTER_BUFFERS)")
        self._registered_bufs = None

    # -- sqe preparation ----------------------------------------------------
    # struct io_uring_sqe (64B):
    #  u8 opcode; u8 flags; u16 ioprio; s32 fd; u64 off; u64 addr; u32 len;
    #  u32 rw_flags; u64 user_data; u16 buf_index; u16 personality;
    #  s32 splice_fd_in; u64 addr3; u64 pad
    _SQE_FMT = "<BBHiQQIIQHHiQQ"
    assert struct.calcsize(_SQE_FMT) == SQE_SIZE

    def _prep(self, opcode: int, fd: int, off: int, addr: int, length: int,
              user_data: int, rw_flags: int = 0, buf_index: int = 0) -> None:
        if self.sq_space() <= 0:
            raise UringError(errno.EBUSY, "submission queue full")
        tail = self._u32(self._sq_mm, self._sq_tail_off)
        idx = tail & self._sq_mask
        struct.pack_into(self._SQE_FMT, self._sqe_mm, idx * SQE_SIZE,
                         opcode, 0, 0, fd, off, addr, length,
                         rw_flags, user_data, buf_index, 0, 0, 0, 0)
        # publish: the array is pre-filled identity, just bump the tail
        self._put_u32(self._sq_mm, self._sq_tail_off, tail + 1)
        self._to_submit += 1

    def prep_write(self, fd: int, addr: int, nbytes: int, offset: int,
                   user_data: int) -> None:
        self._prep(IORING_OP_WRITE, fd, offset, addr, nbytes, user_data)

    def prep_read(self, fd: int, addr: int, nbytes: int, offset: int,
                  user_data: int) -> None:
        self._prep(IORING_OP_READ, fd, offset, addr, nbytes, user_data)

    def prep_write_fixed(self, fd: int, addr: int, nbytes: int, offset: int,
                         user_data: int, buf_index: int) -> None:
        self._prep(IORING_OP_WRITE_FIXED, fd, offset, addr, nbytes, user_data,
                   buf_index=buf_index)

    def prep_read_fixed(self, fd: int, addr: int, nbytes: int, offset: int,
                        user_data: int, buf_index: int) -> None:
        self._prep(IORING_OP_READ_FIXED, fd, offset, addr, nbytes, user_data,
                   buf_index=buf_index)

    def prep_fsync(self, fd: int, user_data: int, datasync: bool = True) -> None:
        self._prep(IORING_OP_FSYNC, fd, 0, 0, 0, user_data,
                   rw_flags=IORING_FSYNC_DATASYNC if datasync else 0)

    def prep_nop(self, user_data: int) -> None:
        self._prep(IORING_OP_NOP, 0, 0, 0, 0, user_data)

    # -- submit / complete ---------------------------------------------------
    def submit(self, wait_for: int = 0) -> int:
        """Pass pending sqes to the kernel; optionally wait for completions."""
        to_submit = self._to_submit
        flags = 0
        if wait_for:
            flags |= IORING_ENTER_GETEVENTS
        if self.sqpoll:
            sqflags = self._u32(self._sq_mm, self._sq_flags_off)
            if sqflags & IORING_SQ_NEED_WAKEUP:
                flags |= IORING_ENTER_SQ_WAKEUP
            elif not wait_for:
                # SQPOLL thread picks the sqes up without a syscall.
                self._inflight += to_submit
                self._to_submit = 0
                return to_submit
        ret = _libc.syscall(SYS_io_uring_enter, self.fd, to_submit,
                            wait_for, flags, None, 0)
        while ret < 0 and ctypes.get_errno() in (errno.EINTR, errno.EAGAIN):
            ret = _libc.syscall(SYS_io_uring_enter, self.fd, to_submit,
                                wait_for, flags, None, 0)
        _check(ret, "io_uring_enter")
        self._inflight += ret
        self._to_submit -= ret
        return ret

    def peek_cqes(self, max_n: int | None = None) -> list[Cqe]:
        """Drain available completions without blocking."""
        out: list[Cqe] = []
        head = self._u32(self._cq_mm, self._cq_head_off)
        tail = self._u32(self._cq_mm, self._cq_tail_off)
        while head != tail and (max_n is None or len(out) < max_n):
            idx = head & self._cq_mask
            user_data, res, flags = struct.unpack_from(
                "<QiI", self._cq_mm, self._cqes_off + idx * CQE_SIZE)
            out.append(Cqe(user_data, res, flags))
            head += 1
        self._put_u32(self._cq_mm, self._cq_head_off, head)
        self._inflight -= len(out)
        return out

    def wait_cqes(self, n: int = 1) -> list[Cqe]:
        """Block until at least n completions are available, drain all."""
        got = self.peek_cqes()
        while len(got) < n:
            need = n - len(got)
            ret = _libc.syscall(SYS_io_uring_enter, self.fd, 0, need,
                                IORING_ENTER_GETEVENTS, None, 0)
            if ret < 0 and ctypes.get_errno() not in (errno.EINTR, errno.EAGAIN):
                _check(ret, "io_uring_enter(GETEVENTS)")
            got.extend(self.peek_cqes())
        return got

    def close(self) -> None:
        if getattr(self, "fd", -1) >= 0:
            try:
                if self._registered_bufs is not None:
                    self.unregister_buffers()
            except OSError:
                pass
            self._sqe_mm.close()
            if self._cq_mm is not self._sq_mm:
                self._cq_mm.close()
            self._sq_mm.close()
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
