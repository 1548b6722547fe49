"""Deterministic seeded chaos campaign over the checkpoint stack (§13).

Counterpart of ``repro.core.chaos``: the same cells, the same per-trial RNG
derivation from ``(seed, trial, cell)``, the same invariants and corruption
trials, over this package's stack. Restores land on the campaign's
``device`` (``"cuda"`` unless the caller asks for the CPU), and the
``delta-gather`` cell holds its ``w`` tensor there — on the card, its delta
saves fingerprint with the CUDA kernel and gather dirty chunks by D2H.

Drives randomized save / restore / flush / GC schedules across the
delta × multiwriter × multilevel composition matrix with faults injected
through ``core.faults`` (syscall-level crashes, torn/short writes,
ENOSPC/EIO) and filesystem-level corruptors (bit-flips, truncation,
zeroing), then checks the two design invariants after every fault:

  I1  a committed step always restores bit-exactly (storage is never left
      corrupt by a crash — a step either restores byte-identical to what
      was saved, or is not committed),
  I2  a crash never loses the previously committed step (the newest
      pre-fault committed step is still present and restorable from a
      fresh manager, exactly as a restarted trainer would find it).

Post-commit corruption trials check the complementary pair: restore must
never *silently* return wrong bytes (typed ``ChecksumError`` /
``ManifestError`` / ``QuarantinedChunkError``, or clean fallback to an
older step), and ``scrub_store`` must detect every injected corruption —
repairing from level 1 when a mirror exists, quarantining otherwise.

Every trial derives its RNG from ``(seed, trial-index, cell)``, so a
campaign failure is reproducible from the seed line it prints:

    PYTHONPATH=src python -m repro_torch.core.faults --campaign \
        --seed <S> --only-trial <I> --cells <CELL> --device <DEV> -v

Multiwriter / threadpool trials interleave threads, which can move WHERE
in the syscall stream a fault lands between runs — the invariants must
hold at every site, so any landing is a valid trial; the schedule itself
(states, steps, fault specs) is fully seed-determined.
"""

from __future__ import annotations

import argparse
import errno as _errno
import os
import random
import shutil
import tempfile
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from . import delta as delta_mod
from . import faults, trace
from .checkpoint import CheckpointManager
from .engines import ChecksumError, EngineConfig
from .manifest import MANIFEST_NAME, ManifestError
from .multilevel import MultiLevelCheckpointer
from .multiwriter import MultiWriterAborted, MultiWriterCheckpointer
from .serialization import tensor_to_numpy

CELLS = ("solo", "delta", "ml", "ml-delta", "mw", "mw-delta",
         "delta-gather", "remote", "remote-delta")
_CHUNK = 2048         # delta chunk grid for campaign states (small & fast)


class InvariantViolation(AssertionError):
    """A chaos trial observed a broken design invariant."""


@dataclass
class CampaignStats:
    seed: int = 0
    trials: int = 0
    faults: int = 0                      # faults actually fired/injected
    no_fire: int = 0                     # trials whose fault never triggered
    by_kind: Counter = field(default_factory=Counter)
    by_cell: Counter = field(default_factory=Counter)
    elapsed: float = 0.0

    def summary(self) -> str:
        kinds = ", ".join(f"{k}={n}" for k, n in sorted(self.by_kind.items()))
        cells = ", ".join(f"{c}={n}" for c, n in sorted(self.by_cell.items()))
        return (f"campaign seed={self.seed}: {self.trials} trials, "
                f"{self.faults} faults fired ({self.no_fire} no-fire) in "
                f"{self.elapsed:.1f}s\n  kinds: {kinds}\n  cells: {cells}")


# --------------------------------------------------------------- state helpers
def _make_state(rng: random.Random) -> dict:
    r = np.random.default_rng(rng.randrange(2 ** 32))
    return {
        "w": r.standard_normal((512, 4)).astype(np.float32),     # 8 KiB
        "b": r.standard_normal(256),                             # 2 KiB f64
        "emb": r.integers(0, 256, 6144).astype(np.uint8),        # 6 KiB
        "step_count": int(rng.randrange(10 ** 6)),
    }


def _mutate(state: dict, rng: random.Random) -> dict:
    """Sparsely mutated copy: realistic delta dirtiness (some chunks clean)."""
    r = np.random.default_rng(rng.randrange(2 ** 32))
    out = {}
    for k, v in state.items():
        if not isinstance(v, np.ndarray):
            out[k] = v + 1
            continue
        a = v.copy()
        if rng.random() < 0.75:          # leave ~25% of tensors untouched
            flat = a.reshape(-1)
            span = max(1, flat.shape[0] // 8)
            at = rng.randrange(max(flat.shape[0] - span, 1))
            if a.dtype == np.uint8:
                flat[at:at + span] = r.integers(0, 256, span, dtype=np.int64)
            else:
                flat[at:at + span] = r.standard_normal(span)
        out[k] = a
    return out


def _fp(state) -> dict:
    """Bit-exact fingerprint of a (restored) state tree."""
    out = {}
    for k, v in state.items():
        a = tensor_to_numpy(v) if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        out[k] = (str(a.dtype), tuple(a.shape), a.tobytes())
    return out


def _injected(err: BaseException) -> bool:
    """True when an exception chain bottoms out in an injected fault."""
    seen = set()
    e: BaseException | None = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, (faults.InjectedCrash, faults.InjectedIOError,
                          MultiWriterAborted)):
            return True
        e = e.__cause__ or e.__context__
    return False


# ------------------------------------------------------------------- trial ctx
@dataclass
class _Trial:
    cell: str
    rng: random.Random
    root: str                  # local checkpoint directory
    remote: str | None         # level-1 directory (ml cells)
    device: torch.device       # where restores land
    committed: dict = field(default_factory=dict)   # step -> fingerprint
    # a faulted re-save of step S may legally land either version
    acceptable: dict = field(default_factory=dict)  # step -> [fp, ...]
    fault_desc: str = ""

    def die(self, msg: str):
        raise InvariantViolation(
            f"[{self.cell}] {self.fault_desc}: {msg} (dir kept at "
            f"{self.root})")

    def ok_fps(self, step: int) -> list:
        fps = list(self.acceptable.get(step, ()))
        if step in self.committed:
            fps.append(self.committed[step])
        return fps


def _engine_config(rng: random.Random) -> EngineConfig:
    return EngineConfig(
        backend="posix" if rng.random() < 0.8 else "threadpool",
        strategy=rng.choice(["single_file", "file_per_tensor"]),
        direct=False)


def _mgr_kw(t: _Trial) -> dict:
    kw = dict(engine="aggregated", config=_engine_config(t.rng), keep=2,
              verify_crc=True, device=t.device)
    if "delta" in t.cell:
        kw.update(delta=True, delta_chunk_bytes=_CHUNK)
    return kw


def _fresh_verifier(t: _Trial) -> CheckpointManager:
    """A restarted trainer's view: new manager, runs ``_gc_tmp`` recovery."""
    return CheckpointManager(
        t.root, engine="aggregated",
        config=EngineConfig(backend="posix", direct=False), keep=None,
        device=t.device)


def _check_restores(t: _Trial, mgr: CheckpointManager, step: int,
                    expect_fps: list) -> None:
    try:
        got = _fp(mgr.restore(step=step))
    except Exception as e:
        t.die(f"restore of committed step {step} failed: {e!r}")
    if got not in expect_fps:
        t.die(f"restore of committed step {step} is not bit-exact")


def _verify_recovery(t: _Trial, pending_step: int | None,
                     pending_fp) -> None:
    """Crash aftermath: fresh manager, I1 + I2, then GC + scrub + re-check."""
    faults.simulate_owner_death(t.root)
    if t.remote is not None:
        faults.simulate_owner_death(t.remote)
    v = _fresh_verifier(t)
    steps = v.all_steps()
    if t.committed:
        last = max(t.committed)
        if last not in steps:
            t.die(f"previously committed step {last} lost (found {steps})")
    if pending_step is not None and pending_step in steps \
            and pending_step not in t.committed:
        # the faulted save actually committed: it must restore bit-exactly
        t.committed[pending_step] = pending_fp
    for s in steps:
        fps = t.ok_fps(s)
        if fps:
            _check_restores(t, v, s, fps)
    # a crash must leave the store GC-convergent and corruption-free
    delta_mod.gc_store(t.root, grace_s=0.0)
    rep = faults.scrub_store(t.root)
    if not rep.clean:
        t.die(f"crash left corrupt store data: {rep.summary()}")
    if t.committed:
        last = max(s for s in steps if s in t.committed) \
            if any(s in t.committed for s in steps) else None
        if last is not None:
            _check_restores(t, v, last, t.ok_fps(last))
    v.close()


# ------------------------------------------------------------- fault schedules
def _pick_fault(rng: random.Random, for_restore: bool = False) -> faults.Fault:
    if for_restore:
        kind = rng.choice(["eio-read", "crash-read", "short-read"])
        if kind == "eio-read":
            return faults.Fault(faults.OP_READ, at=rng.randint(1, 3),
                                action=faults.A_ERRNO, err=_errno.EIO)
        if kind == "crash-read":
            return faults.Fault(faults.OP_READ, at=rng.randint(1, 3),
                                action=faults.A_CRASH)
        return faults.Fault(faults.OP_READ, at=rng.randint(1, 3),
                            action=faults.A_SHORT,
                            frac=rng.choice([0.25, 0.5, 0.75]))
    kind = rng.choice(["crash-write", "crash-fsync", "crash-rename",
                       "crash-fallocate", "torn-write", "short-write",
                       "enospc-write", "eio-write", "eio-rename",
                       "enospc-fallocate"])
    at = rng.randint(1, 4)
    if kind == "crash-write":
        return faults.Fault(faults.OP_WRITE, at=at)
    if kind == "crash-fsync":
        return faults.Fault(faults.OP_FSYNC, at=rng.randint(1, 3))
    if kind == "crash-rename":
        return faults.Fault(faults.OP_RENAME, at=rng.randint(1, 2))
    if kind == "crash-fallocate":
        return faults.Fault(faults.OP_FALLOCATE, at=1)
    if kind == "torn-write":
        return faults.Fault(faults.OP_WRITE, at=at, action=faults.A_TORN,
                            frac=rng.choice([0.1, 0.5, 0.9]))
    if kind == "short-write":
        return faults.Fault(faults.OP_WRITE, at=at, action=faults.A_SHORT,
                            frac=rng.choice([0.25, 0.5, 0.75]))
    if kind == "enospc-write":
        return faults.Fault(faults.OP_WRITE, at=at, action=faults.A_ERRNO,
                            err=_errno.ENOSPC)
    if kind == "eio-write":
        return faults.Fault(faults.OP_WRITE, at=at, action=faults.A_ERRNO,
                            err=_errno.EIO)
    if kind == "eio-rename":
        return faults.Fault(faults.OP_RENAME, at=rng.randint(1, 2),
                            action=faults.A_ERRNO, err=_errno.EIO)
    return faults.Fault(faults.OP_FALLOCATE, at=1, action=faults.A_ERRNO,
                        err=_errno.ENOSPC)


def _pick_gather_fault(rng: random.Random) -> faults.Fault:
    """Fault in the dirty-chunk gather window between the fingerprint diff
    and put submission (delta §14): a crash or I/O error mid-gather must
    abort the stream so no manifest ever references never-copied chunks."""
    at = rng.randint(1, 2)
    if rng.random() < 0.5:
        return faults.Fault(faults.OP_GATHER, at=at)
    return faults.Fault(faults.OP_GATHER, at=at,
                        action=faults.A_ERRNO, err=_errno.EIO)


def _fault_kind(f: faults.Fault) -> str:
    return f"{f.action}-{f.op}"


# ------------------------------------------------------------------ trial body
def run_trial(cell: str, rng: random.Random, base_dir: str,
              stats: CampaignStats, device="cuda") -> None:
    """One seeded trial: committed saves, one fault, invariant checks.
    Raises InvariantViolation (keeping the trial dir) on any breakage."""
    root = tempfile.mkdtemp(prefix=f"chaos-{cell}-", dir=base_dir)
    remote = None
    if cell.startswith("ml") or cell.startswith("remote"):
        remote = tempfile.mkdtemp(prefix=f"chaos-{cell}-l1-", dir=base_dir)
    t = _Trial(cell, rng, root, remote, torch.device(device))
    # fresh per-trial ring: a violation dumps exactly this trial's spans,
    # fault injections included, next to the kept dir
    owned_tracer = not trace.is_enabled()
    if owned_tracer:
        trace.enable()
    try:
        try:
            if cell.startswith("mw"):
                _trial_multiwriter(t, stats)
            elif cell.startswith("remote"):
                _trial_remote(t, stats)
            else:
                _trial_single(t, stats)
        except InvariantViolation:
            raise                  # keep the dir for forensics
        except Exception as e:
            t.die(f"unexpected trial error: {e!r}")
    except InvariantViolation:
        trace.export_perfetto(os.path.join(root, "trace.json"))
        raise
    finally:
        if owned_tracer:
            trace.disable()
    shutil.rmtree(root, ignore_errors=True)
    if remote is not None:
        shutil.rmtree(remote, ignore_errors=True)


def _record(t: _Trial, stats: CampaignStats, plan: faults.FaultPlan) -> bool:
    fired = bool(plan.fired)
    stats.faults += len(plan.fired)
    if not fired:
        stats.no_fire += 1
    for d in plan.fired:
        stats.by_kind[d.split("#")[0]] += 1
    return fired


def _trial_single(t: _Trial, stats: CampaignStats) -> None:
    rng = t.rng
    ml = t.cell.startswith("ml")
    kw = _mgr_kw(t)
    if ml:
        mgr = MultiLevelCheckpointer(t.root, t.remote, flush_workers=2, **kw)
        base = mgr.local
    else:
        mgr = CheckpointManager(t.root, async_save=rng.random() < 0.3, **kw)
        base = mgr
    base.delta_gc_grace_s = 0.0

    state = _make_state(rng)
    if t.cell == "delta-gather":
        # hold one tensor on device: exercises the on-device fingerprint +
        # D2H dirty-span gather path instead of free host views
        state["w"] = torch.tensor(state["w"], device=t.device)
    step = rng.randint(1, 5)
    for _ in range(rng.randint(1, 2)):
        mgr.save(step, state)
        mgr.wait()
        t.committed[step] = _fp(state)
        state = _mutate(state, rng)
        step += rng.randint(1, 3)

    if t.cell == "delta-gather":
        scenario = rng.choice(["save", "save", "resave"])
    else:
        scenario = rng.choice(["save", "save", "save", "resave", "restore",
                               "corrupt", "corrupt"]
                              + (["flush"] if ml else []))
    if scenario == "resave":
        step = max(t.committed)        # overwrite: the displaced-aside window
    pending_fp = _fp(state)

    if scenario == "corrupt":
        mgr.close()
        _trial_corruption(t, stats)
        return

    fault = (_pick_gather_fault(rng) if t.cell == "delta-gather"
             else _pick_fault(rng, for_restore=(scenario == "restore")))
    t.fault_desc = fault.describe()
    plan = faults.FaultPlan([fault])
    err: BaseException | None = None
    try:
        with faults.inject(plan):
            if scenario == "restore":
                got = _fp(mgr.restore(step=max(t.committed)))
                if got != t.committed[max(t.committed)]:
                    t.die("restore under fault returned wrong bytes "
                          "instead of failing")
            elif scenario == "flush":
                # fault lands in the level-1 flush of a NEW step: level 0
                # commits first, so the local step must survive the fault
                mgr.save(step, state)
                mgr.wait()
            else:
                mgr.save(step, state)
                mgr.wait()
    except Exception as e:
        err = e
    fired = _record(t, stats, plan)
    if err is not None and not _injected(err):
        t.die(f"fault surfaced as unexpected error: {err!r}")
    if err is not None and not fired:
        t.die(f"error raised but no fault fired: {err!r}")

    if scenario == "restore":
        # the manager must be fully usable after a failed restore: no leaked
        # budget/buffers, and both a retry restore and the next save work
        if base.engine.pool.outstanding_bytes:
            t.die(f"read-stream abort leaked "
                  f"{base.engine.pool.outstanding_bytes} pooled bytes")
        _check_restores(t, base, max(t.committed),
                        t.ok_fps(max(t.committed)))
        mgr.save(step, state)
        mgr.wait()
        t.committed[step] = pending_fp
        _check_restores(t, base, step, [pending_fp])
        mgr.close()
        return

    if scenario == "resave":
        t.acceptable.setdefault(step, []).append(pending_fp)
    if err is None:
        # fault did not break the op (no-fire, short write, or post-commit
        # crash point): the step is committed and must restore bit-exactly
        t.committed[step] = pending_fp
        t.acceptable.pop(step, None)
    if scenario == "flush" and err is not None:
        # the fault may have hit the level-0 save rather than the flush
        # (both run inside the armed window); only when the step committed
        # locally must a flush retry converge and publish it at level 1
        if step in base.all_steps():
            t.committed[step] = pending_fp
            mgr.flush_to_remote(step)
            if not os.path.exists(os.path.join(
                    t.remote, f"step_{step:08d}", MANIFEST_NAME)):
                t.die("flush retry did not publish the step at level 1")
    crashed = err is not None and any(
        isinstance(e, faults.InjectedCrash) for e in _chain(err))
    if err is not None and not crashed:
        # errno faults are survivable failures: the SAME manager must accept
        # the next save (no wedged budget/engine state)
        state2 = _mutate(state, rng)
        step2 = step + 1
        mgr.save(step2, state2)
        mgr.wait()
        t.committed[step2] = _fp(state2)
    try:
        mgr.close()
    except Exception:
        pass               # a crashed manager may not close cleanly
    _verify_recovery(t, step if err is not None else None, pending_fp)


def _chain(err: BaseException):
    seen = set()
    e: BaseException | None = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        yield e
        e = e.__cause__ or e.__context__


def _trial_corruption(t: _Trial, stats: CampaignStats) -> None:
    """Post-commit damage: detection (scrub / typed errors), never silence."""
    rng = t.rng
    last = max(t.committed)
    step_dir = os.path.join(t.root, f"step_{last:08d}")
    choices = ["manifest-zero", "manifest-trunc", "manifest-flip"]
    if "delta" in t.cell:
        choices += ["chunk-flip", "chunk-flip"]
    else:
        choices += ["data-flip"]
    mode = rng.choice(choices)
    t.fault_desc = f"corrupt:{mode}"
    stats.faults += 1
    stats.by_kind[f"corrupt:{mode.split('-')[1]}"] += 1

    if mode == "chunk-flip":
        hit = faults.corrupt_store_chunk(t.root, rng)
        if hit is None:
            stats.faults -= 1
            stats.no_fire += 1
            return
        rel, _off = hit
        rep = faults.scrub_store(
            t.root, remote_root=t.remote if t.remote else None)
        if rel not in rep.corrupt:
            t.die(f"scrub missed injected corruption in {rel}")
        v = _fresh_verifier(t)
        if t.remote is not None:
            if rel not in rep.repaired:
                t.die(f"scrub did not repair {rel} from level 1")
            for s in v.all_steps():
                if s in t.committed:
                    _check_restores(t, v, s, t.ok_fps(s))
        else:
            if rel not in rep.quarantined:
                t.die(f"scrub did not quarantine {rel}")
            try:
                got = _fp(v.restore())
                if got not in [t.committed[s] for s in t.committed]:
                    t.die("restore silently returned wrong bytes after "
                          "quarantine")
            except faults.QuarantinedChunkError:
                pass       # typed failure naming the chunk: acceptable
            except ManifestError:
                pass       # every kept step depended on the chunk
        v.close()
        return

    if mode == "data-flip":
        # flip one byte inside a referenced data extent of the latest step
        try:
            from .manifest import Manifest
            m = Manifest.load(step_dir)
        except ManifestError:
            return
        exts = [sh for rec in m.tensors.values() for sh in rec.shards
                if getattr(sh, "kind", "extent") == "extent"
                and not sh.path.startswith(delta_mod.STORE_PREFIX)]
        if not exts:
            stats.faults -= 1
            stats.no_fire += 1
            return
        sh = exts[rng.randrange(len(exts))]
        faults.flip_byte(os.path.join(step_dir, sh.path),
                         sh.offset + rng.randrange(max(sh.nbytes, 1)))
        v = _fresh_verifier(t)
        try:
            got = _fp(v.restore(step=last))
            if got == t.committed[last]:
                t.die("bit-flip in a referenced extent went undetected "
                      "(restore returned the pre-flip bytes?)")
            t.die("restore silently returned corrupt bytes (no CRC error)")
        except (ChecksumError, ManifestError):
            pass           # typed detection: the invariant
        v.close()
        return

    # manifest damage on the latest step
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if mode == "manifest-zero":
        faults.zero_file(mpath)
    elif mode == "manifest-trunc":
        faults.truncate_file(mpath, rng.randrange(
            max(os.path.getsize(mpath) // 2, 1)))
    else:
        faults.flip_byte(mpath, rng.randrange(os.path.getsize(mpath)))
    v = _fresh_verifier(t)
    try:
        v.restore(step=last)
        if mode != "manifest-flip":
            t.die("restore of a zeroed/truncated manifest succeeded")
        # a single bit-flip inside a JSON string can remain parseable; the
        # restore then either succeeds bit-exactly or fails typed below
    except ManifestError:
        pass               # typed: the regression contract
    except ChecksumError:
        pass               # flipped a crc/offset field: caught downstream
    older = [s for s in t.committed if s != last]
    if older and mode in ("manifest-zero", "manifest-trunc"):
        # latest-step fallback: restore() must skip the corrupt manifest
        got = _fp(v.restore())
        if got != t.committed[max(older)]:
            t.die("latest-step fallback did not restore the previous step "
                  "bit-exactly")
    v.close()


def _trial_multiwriter(t: _Trial, stats: CampaignStats) -> None:
    rng = t.rng
    kw = _mgr_kw(t)
    kw["config"] = EngineConfig(
        backend="posix" if rng.random() < 0.8 else "threadpool",
        strategy="single_file", direct=False)
    w = MultiWriterCheckpointer(t.root, 2, **kw)
    for m in w.managers:
        m.delta_gc_grace_s = 0.0

    state = _make_state(rng)
    step = rng.randint(1, 5)
    for _ in range(rng.randint(1, 2)):
        w.save(step, state)
        t.committed[step] = _fp(state)
        state = _mutate(state, rng)
        step += rng.randint(1, 3)

    resave = rng.random() < 0.25
    if resave:
        step = max(t.committed)
    pending_fp = _fp(state)
    fault = _pick_fault(rng)
    t.fault_desc = fault.describe()
    plan = faults.FaultPlan([fault])
    err: BaseException | None = None
    try:
        with faults.inject(plan):
            w.save(step, state)
    except Exception as e:
        err = e
    fired = _record(t, stats, plan)
    if err is not None and not _injected(err):
        t.die(f"fault surfaced as unexpected error: {err!r}")
    if err is not None and not fired:
        t.die(f"error raised but no fault fired: {err!r}")
    if resave:
        t.acceptable.setdefault(step, []).append(pending_fp)
    if err is None:
        t.committed[step] = pending_fp
        t.acceptable.pop(step, None)
    else:
        # a failed group save must leave the group usable: the next save
        # (same writer set, fresh step) commits and restores
        step2 = max(max(t.committed), step) + 1
        state2 = _mutate(state, rng)
        w.save(step2, state2)
        t.committed[step2] = _fp(state2)
        got = _fp(w.restore(step=step2))
        if got != t.committed[step2]:
            t.die("post-fault group save did not restore bit-exactly")
    try:
        w.close()
    except Exception:
        pass
    _verify_recovery(t, step if err is not None else None, pending_fp)


def _pick_remote_fault(rng: random.Random, *, upload: bool) -> faults.Fault:
    """Object-tier faults (§15): on uploads a crash/errno/torn PUT must
    never publish the step (manifest-last), a stalled PUT just slows it;
    on ranged reads stalls must be masked by hedging, short ranges by the
    remainder re-request, and crash/errno must surface typed."""
    if upload:
        kind = rng.choice(["crash", "crash", "errno", "torn", "stall"])
        at = rng.randint(1, 3)
        if kind == "crash":
            return faults.Fault(faults.OP_RPUT, at=at)
        if kind == "errno":
            return faults.Fault(faults.OP_RPUT, at=at,
                                action=faults.A_ERRNO, err=_errno.EIO)
        if kind == "torn":
            return faults.Fault(faults.OP_RPUT, at=at, action=faults.A_TORN,
                                frac=rng.choice([0.1, 0.5, 0.9]))
        return faults.Fault(faults.OP_RPUT, at=at, action=faults.A_STALL,
                            delay_s=0.05)
    kind = rng.choice(["stall", "stall", "short", "short", "errno", "crash"])
    at = rng.randint(1, 4)
    if kind == "stall":
        return faults.Fault(faults.OP_RGET, at=at, action=faults.A_STALL,
                            delay_s=0.15)
    if kind == "short":
        return faults.Fault(faults.OP_RGET, at=at, action=faults.A_SHORT,
                            frac=rng.choice([0.25, 0.5, 0.75]))
    if kind == "errno":
        return faults.Fault(faults.OP_RGET, at=at,
                            action=faults.A_ERRNO, err=_errno.EIO)
    return faults.Fault(faults.OP_RGET, at=at)


def _remote_verifier(t: _Trial, store, cfg, mode: str):
    """A fresh trainer on a NEW machine: empty local dir, so every restore
    must come over the remote tier (stream or promote)."""
    from .remote import RemoteCheckpointer
    vdir = tempfile.mkdtemp(prefix="chaos-rverify-", dir=t.remote)
    return RemoteCheckpointer(
        vdir, store, remote=cfg, upload_async=False, restore_mode=mode,
        engine="aggregated",
        config=EngineConfig(backend="posix", direct=False),
        keep=None, verify_crc=True, device=t.device)


def _verify_remote(t: _Trial, store, cfg, mode: str) -> None:
    """I1 at level 2: every step whose remote manifest object exists
    restores bit-exactly on a fresh machine."""
    v = _remote_verifier(t, store, cfg, mode)
    for s in v.tier.committed_steps():
        if s in t.committed:
            try:
                got = _fp(v.restore(step=s))
            except Exception as e:
                t.die(f"remote restore of published step {s} failed: {e!r}")
            if got not in t.ok_fps(s):
                t.die(f"remote restore of published step {s} is not "
                      f"bit-exact")
    v.close()


def _trial_remote(t: _Trial, stats: CampaignStats) -> None:
    """Level-2 object-tier trials: faulted uploads (crash mid-upload must
    leave the step unpublished and a retry must converge via dedup),
    faulted ranged restores (stall/short masked, crash/errno typed and
    retryable), and remote object corruption (typed detection)."""
    from .remote import RemoteCheckpointer, RemoteConfig, SimObjectStore
    rng = t.rng
    cfg = RemoteConfig(range_bytes=4096, window=4, hedge_after_s=0.02,
                       min_bw_bytes_s=1e12, retry_backoff_s=0.001,
                       put_workers=rng.choice([1, 4]))
    store = SimObjectStore(os.path.join(t.remote, "bucket"))
    mode = rng.choice(["stream", "stream", "promote"])
    mgr = RemoteCheckpointer(t.root, store, remote=cfg, upload_async=False,
                             restore_mode=mode, **_mgr_kw(t))
    mgr.local.delta_gc_grace_s = 0.0

    state = _make_state(rng)
    step = rng.randint(1, 5)
    for _ in range(rng.randint(1, 2)):
        mgr.save(step, state)
        t.committed[step] = _fp(state)
        state = _mutate(state, rng)
        step += rng.randint(1, 3)

    scenario = rng.choice(["upload", "upload", "restore", "restore",
                           "restore", "corrupt"])

    if scenario == "corrupt":
        mgr.close()
        _trial_remote_corruption(t, stats, store, cfg, mode)
        return

    if scenario == "upload":
        fault = _pick_remote_fault(rng, upload=True)
        t.fault_desc = fault.describe()
        plan = faults.FaultPlan([fault])
        pending_fp = _fp(state)
        err: BaseException | None = None
        try:
            with faults.inject(plan):
                mgr.save(step, state)
        except Exception as e:
            err = e
        fired = _record(t, stats, plan)
        if err is not None and not _injected(err):
            t.die(f"fault surfaced as unexpected error: {err!r}")
        if err is not None and not fired:
            t.die(f"error raised but no fault fired: {err!r}")
        published = set(mgr.tier.committed_steps())
        if err is not None:
            # manifest-last: a failed upload must never have published the
            # step (no remote manifest may reference un-uploaded objects)
            if step in published:
                t.die("crashed upload published the step's manifest")
            # the step DID commit locally; a plain upload retry must
            # converge, deduping whatever the failed attempt shipped
            mgr.tier.upload_step(t.root, step)
            if step not in mgr.tier.committed_steps():
                t.die("upload retry after fault did not publish the step")
        t.committed[step] = pending_fp
        mgr.close()
        _verify_remote(t, store, cfg, mode)
        return

    # restore scenario: fault the ranged reads of a fresh-machine restore
    mgr.close()
    fault = _pick_remote_fault(rng, upload=False)
    t.fault_desc = fault.describe()
    plan = faults.FaultPlan([fault])
    last = max(t.committed)
    v = _remote_verifier(t, store, cfg, mode)
    err = None
    try:
        with faults.inject(plan):
            got = _fp(v.restore(step=last))
            if got != t.committed[last]:
                t.die("remote restore under fault returned wrong bytes "
                      "instead of failing")
    except Exception as e:
        err = e
    fired = _record(t, stats, plan)
    if err is not None and not _injected(err):
        t.die(f"fault surfaced as unexpected error: {err!r}")
    if err is not None and not fired:
        t.die(f"error raised but no fault fired: {err!r}")
    if fired and err is not None \
            and fault.action in (faults.A_STALL, faults.A_SHORT):
        # stalls are masked by hedged re-issue, short ranges by the
        # remainder re-request: neither may surface as a failure
        t.die(f"masked fault surfaced as error: {err!r}")
    # failed or not, a retry on the same verifier must restore bit-exactly
    try:
        got = _fp(v.restore(step=last))
    except Exception as e:
        t.die(f"retry restore after remote fault failed: {e!r}")
    if got != t.committed[last]:
        t.die("retry restore after remote fault is not bit-exact")
    v.close()


def _trial_remote_corruption(t: _Trial, stats: CampaignStats, store, cfg,
                             mode: str) -> None:
    """Damage a published remote object in place: restore on a fresh
    machine must fail typed (ManifestError / ChecksumError / RemoteError),
    never silently return wrong bytes; undamaged steps stay restorable."""
    from .remote import RemoteError, join_key
    rng = t.rng
    last = max(t.committed)
    step_key = f"step_{last:08d}"
    mkey = join_key(step_key, MANIFEST_NAME)
    choices = ["manifest-trunc", "manifest-zero"]
    if "delta" not in t.cell:
        choices.append("data-flip")
    kind = rng.choice(choices)
    t.fault_desc = f"corrupt:remote-{kind}"
    stats.faults += 1
    stats.by_kind[f"corrupt:remote-{kind.split('-')[0]}"] += 1

    if kind == "data-flip":
        # flip one byte inside a REFERENCED extent (a flip in alignment
        # padding would legitimately restore bit-exactly)
        from .manifest import Manifest
        m = Manifest.loads(store.get(mkey))
        exts = [sh for rec in m.tensors.values() for sh in rec.shards
                if getattr(sh, "kind", "extent") == "extent"
                and not sh.path.startswith(delta_mod.STORE_PREFIX)]
        if not exts:
            stats.faults -= 1
            stats.no_fire += 1
            return
        sh = exts[rng.randrange(len(exts))]
        path = store.backing_path(join_key(step_key, sh.path))
        faults.flip_byte(path, sh.offset + rng.randrange(max(sh.nbytes, 1)))
    elif kind == "manifest-zero":
        faults.zero_file(store.backing_path(mkey))
    else:
        path = store.backing_path(mkey)
        faults.truncate_file(path, rng.randrange(
            max(os.path.getsize(path) // 2, 1)))

    v = _remote_verifier(t, store, cfg, mode)
    try:
        got = _fp(v.restore(step=last))
        if got == t.committed[last]:
            t.die("remote corruption went undetected (restore returned "
                  "the pre-damage bytes?)")
        t.die("restore silently returned corrupt remote bytes")
    except (ManifestError, ChecksumError, RemoteError):
        pass               # typed detection: the invariant
    # other published steps are untouched and must still restore
    for s in v.tier.committed_steps():
        if s != last and s in t.committed:
            try:
                got = _fp(v.restore(step=s))
            except Exception as e:
                t.die(f"undamaged remote step {s} failed to restore: {e!r}")
            if got not in t.ok_fps(s):
                t.die(f"undamaged remote step {s} is not bit-exact")
    v.close()


# -------------------------------------------------------------------- campaign
def run_campaign(seed: int = 0, *, min_faults: int = 200,
                 max_trials: int | None = None,
                 cells: tuple = CELLS, base_dir: str | None = None,
                 only_trial: int | None = None,
                 verbose: bool = False, device="cuda") -> CampaignStats:
    """Run seeded trials round-robin over ``cells`` until ``min_faults``
    faults have fired (or ``max_trials`` trials ran). Deterministic per
    (seed, trial index, cell). Raises ``InvariantViolation`` with a
    reproduction line on the first broken invariant. ``device``: where
    restores land and the ``delta-gather`` cell's tensor lives."""
    stats = CampaignStats(seed=seed)
    t0 = trace.clock()
    owned_base = None
    if base_dir is None:
        owned_base = tempfile.mkdtemp(prefix=f"chaos-campaign-{seed}-")
        base_dir = owned_base
    else:
        os.makedirs(base_dir, exist_ok=True)
    cap = max_trials if max_trials is not None else max(min_faults * 4, 64)
    failed = False
    try:
        i = -1
        while stats.faults < min_faults and stats.trials < cap:
            i += 1
            if only_trial is not None and i != only_trial:
                continue
            cell = cells[i % len(cells)]
            rng = random.Random(f"{seed}:{i}:{cell}")
            stats.trials += 1
            stats.by_cell[cell] += 1
            if verbose:
                print(f"  trial {i} [{cell}] ...", flush=True)
            try:
                run_trial(cell, rng, base_dir, stats, device)
            except InvariantViolation as e:
                failed = True
                raise InvariantViolation(
                    f"{e}\nreproduce: PYTHONPATH=src python -m "
                    f"repro_torch.core.faults --campaign --seed {seed} "
                    f"--only-trial {i} --cells {cell} --device {device} "
                    f"-v") from e
            if only_trial is not None:
                break
    finally:
        stats.elapsed = trace.clock() - t0
        if owned_base is not None and not failed:
            shutil.rmtree(owned_base, ignore_errors=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.faults",
        description="chaos campaign over the checkpoint stack (DESIGN.md §13)")
    ap.add_argument("--campaign", action="store_true",
                    help="run the seeded campaign (the only mode)")
    ap.add_argument("--seed", default="0",
                    help="campaign seed (int, or 'random')")
    ap.add_argument("--min-faults", type=int, default=200,
                    help="keep running trials until this many faults fired")
    ap.add_argument("--max-trials", type=int, default=None)
    ap.add_argument("--only-trial", type=int, default=None,
                    help="re-run exactly one trial index (reproduction)")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help=f"comma-separated subset of {CELLS}")
    ap.add_argument("--base-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where restores land (default cuda; cpu on asking)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if not args.campaign:
        ap.error("nothing to do: pass --campaign")
    seed = (int.from_bytes(os.urandom(4), "little")
            if args.seed == "random" else int(args.seed))
    cells = tuple(c.strip() for c in args.cells.split(",") if c.strip())
    for c in cells:
        if c not in CELLS:
            ap.error(f"unknown cell {c!r} (choose from {CELLS})")
    try:
        stats = run_campaign(
            seed, min_faults=args.min_faults, max_trials=args.max_trials,
            cells=cells, base_dir=args.base_dir,
            only_trial=args.only_trial, verbose=args.verbose,
            device=args.device)
    except InvariantViolation as e:
        print(f"INVARIANT VIOLATION\n{e}")
        return 1
    print(stats.summary())
    return 0
