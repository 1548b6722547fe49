#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each failing the run (non-zero exit, no result line) on any error:

  1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
               with nvcc (sm_90a); print the build time and the card's name
               and power limit (nvidia-smi).
  2. kernels — every kernel of the save/restore path against its plain
               PyTorch version on the card, bit for bit, at main-path shapes
               (a 256 MiB slice of the ``mlp/wd`` moment, the bf16 ``embed``)
               and at edge cases (ragged last chunk, odd bf16 lane count,
               all-zero rows, exact .5 quotients); CUDA-event times beside the
               bytes-moved bound at 3.35 TB/s and the plain version's time.
  3. main path — the full-width qwen2.5-3b train state (44 tensors, 28.74
               GiB; random values from a seeded torch.Generator on the card)
               through ``CheckpointManager``: (A) a quantized async save
               (the embedding mutated in place right after
               ``wait_snapshotted()``) + restore,
               (B) a delta chain — step 1, a contiguous 1% change of a few
               tensors, step 2, restore of step 2. Restored bytes are checked
               (unquantized: bit-exact; quantized: equal to the plain
               dequantize(quantize(x)) on the card), step 2's written bytes
               are held to the dirty chunks plus the lean blob, and every
               kernel's launch count over (A) and (B) must be above 0.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON, and the one before that the nvidia-smi line. The run
needs one card and the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CHUNK = 256 << 10                  # delta chunk grid (DEFAULT_CHUNK_BYTES)
KERNELS = {
    # wrapper name: (CUDA source, Pallas kernel it replaces)
    "quantize_blocks": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:55"),
    "dequantize_blocks": ("src/repro_torch/kernels/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:72"),
    "fingerprint_chunks": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                           "src/repro/kernels/fingerprint.py:258"),
    "quantize_fingerprint_blocks": (
        "src/repro_torch/kernels/csrc/fingerprint.cu",
        "src/repro/kernels/fingerprint.py:296"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ helpers
def bits(t):
    """Same-width integer view, so equality is bitwise (NaN-safe)."""
    import torch
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(width[t.element_size()])


def max_abs_diff(a, b) -> float:
    import torch
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def require_equal(name: str, got, want) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.equal(bits(got), bits(want)):
        fail(f"{name}: kernel differs from its plain version "
             f"(max abs diff {max_abs_diff(got, want)})")
    return max_abs_diff(got, want)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2
def check_kernels(results: dict) -> None:
    import torch
    from repro_torch.kernels import _lib, fingerprint as fpk, quantize as qk
    from repro_torch.kernels.quantize import LANE_COLS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # main-path shape: a 256 MiB slice of the mlp/wd first moment (f32)
    rows = (256 << 20) // 4 // LANE_COLS
    x = torch.empty((rows, LANE_COLS), dtype=torch.float32, device=dev)
    x.normal_(0.0, 1e-3, generator=gen)
    n = x.numel()
    qbytes, sbytes = rows * LANE_COLS, rows * 4

    # B1 quantize_blocks
    q, s = qk.quantize_blocks(x)
    qp, sp = qk.quantize_blocks_plain(x)
    err = max(require_equal("quantize_blocks q", q, qp),
              require_equal("quantize_blocks s", s, sp))
    results["quantize_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qk.quantize_blocks(x), 20),
        plain_ms=cuda_ms(lambda: qk.quantize_blocks_plain(x), 3, 1),
        bound_ms=bound_ms(n * 4 + qbytes + sbytes), library_ms=None,
        shape=f"x ({rows}, {LANE_COLS}) f32")

    # B2 dequantize_blocks (restore decode of the f32 moment)
    d = qk.dequantize_blocks(q, s, torch.float32, n=n)
    dp = qk.dequantize_blocks_plain(q, s, torch.float32, n=n)
    err = require_equal("dequantize_blocks", d, dp)
    results["dequantize_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qk.dequantize_blocks(q, s, torch.float32, n=n), 20),
        plain_ms=cuda_ms(
            lambda: qk.dequantize_blocks_plain(q, s, torch.float32, n=n), 3, 1),
        bound_ms=bound_ms(qbytes + sbytes + n * 4),
        # one PyTorch call computing the same f32 function: int8 * f32
        library_ms=cuda_ms(lambda: torch.mul(q, s[:, None]), 20),
        shape=f"q ({rows}, {LANE_COLS}) int8 -> {n} f32")

    # B3 fingerprint_chunks on the bf16 embedding (151936, 2048)
    emb = torch.empty((151936, 2048), dtype=torch.bfloat16, device=dev)
    emb.normal_(0.0, 0.02, generator=gen)
    fd = fpk.fingerprint_chunks(emb, CHUNK)
    fdp = fpk.fingerprint_chunks_plain(emb, CHUNK)
    err = require_equal("fingerprint_chunks embed", fd, fdp)
    nbytes = emb.numel() * 2
    results["fingerprint_chunks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fpk.fingerprint_chunks(emb, CHUNK), 20),
        plain_ms=cuda_ms(lambda: fpk.fingerprint_chunks_plain(emb, CHUNK),
                         3, 1),
        bound_ms=bound_ms(nbytes + fd.numel() * 4), library_ms=None,
        shape="embed (151936, 2048) bf16, 256 KiB chunks")
    del emb

    # B4 quantize_fingerprint_blocks on the moment slice
    q4, s4, d4 = fpk.quantize_fingerprint_blocks(x, CHUNK)
    q4p, s4p, d4p = fpk.quantize_fingerprint_blocks_plain(x, CHUNK)
    err = max(require_equal("quantize_fingerprint_blocks q", q4, q4p),
              require_equal("quantize_fingerprint_blocks s", s4, s4p),
              require_equal("quantize_fingerprint_blocks d", d4, d4p))
    results["quantize_fingerprint_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fpk.quantize_fingerprint_blocks(x, CHUNK), 20),
        plain_ms=cuda_ms(
            lambda: fpk.quantize_fingerprint_blocks_plain(x, CHUNK), 3, 1),
        bound_ms=bound_ms(n * 4 + qbytes + sbytes + d4.numel() * 4),
        library_ms=None, shape=f"x ({rows}, {LANE_COLS}) f32, 256 KiB chunks")
    del x, q, s, qp, sp, d, dp, q4, s4, d4, q4p, s4p, d4p

    edge_cases(dev, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _ = _lib  # launch counts of this phase are reset before phase 3


def edge_cases(dev, gen) -> None:
    """Ragged chunks, odd bf16 lane counts, all-zero rows, exact .5."""
    import torch
    from repro_torch.kernels import fingerprint as fpk, quantize as qk
    from repro_torch.kernels.quantize import LANE_COLS

    x = torch.empty((64, LANE_COLS), dtype=torch.float32, device=dev)
    x.normal_(0.0, 1.0, generator=gen)
    x[3] = 0.0                                          # all-zero row
    half = torch.arange(LANE_COLS, device=dev, dtype=torch.float32)
    x[5] = (half % 9) - 4.5                             # .5 quotients ...
    x[5, 0] = 127.0                                     # ... at scale 1.0
    x[6] = -x[5]
    q, s = qk.quantize_blocks(x)
    qp, sp = qk.quantize_blocks_plain(x)
    require_equal("edge quantize q", q, qp)
    require_equal("edge quantize s", s, sp)
    if float(s[3]) != 1.0 or bool(q[3].any()):
        fail("all-zero row must quantize to q=0, scale=1")
    if float(s[5]) != 1.0:
        fail("row 5 was built for scale 1.0")
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        require_equal(f"edge dequantize {dt}",
                      qk.dequantize_blocks(q, s, dt, n=64 * LANE_COLS - 3),
                      qk.dequantize_blocks_plain(q, s, dt,
                                                 n=64 * LANE_COLS - 3))
    # ragged flat input: zero extension past n_valid
    flat = x.reshape(-1)[:40 * LANE_COLS + 77]
    for name, (a, b) in {
            "ragged quantize": (qk.quantize_blocks(flat, 48),
                                qk.quantize_blocks_plain(flat, 48))}.items():
        require_equal(name + " q", a[0], b[0])
        require_equal(name + " s", a[1], b[1])
    # fingerprints: 1-, 2- and 4-byte sources, ragged last chunk, odd lanes
    cb = 4096
    srcs = {
        "u8 ragged": torch.randint(0, 256, (3 * cb + 5,), dtype=torch.uint8,
                                   device=dev, generator=gen),
        "bf16 odd lanes": torch.empty(3 * cb // 2 + 3, dtype=torch.bfloat16,
                                      device=dev).normal_(generator=gen),
        "f32 ragged": torch.empty(5 * cb // 4 + 7, dtype=torch.float32,
                                  device=dev).normal_(generator=gen),
        "i8 one partial chunk": torch.randint(-128, 128, (13,),
                                              dtype=torch.int8, device=dev,
                                              generator=gen),
    }
    for name, t in srcs.items():
        got = fpk.fingerprint_chunks(t, cb)
        require_equal(f"fingerprint {name}", got,
                      fpk.fingerprint_chunks_plain(t, cb))
        host = fpk.fingerprint_chunks_host(
            t.view(torch.uint8).cpu().numpy(), cb)
        if not (fpk.digest_table(got) == host).all():
            fail(f"fingerprint {name}: differs from the numpy host twin")
    # fused path with a tail (q remainder + scales region) on a ragged tensor
    src = torch.empty(3 * (CHUNK // 2) + 1000, dtype=torch.float32,
                      device=dev).normal_(generator=gen)
    from repro_torch.core.quant_codec import packed_rows
    rows = packed_rows(src.numel())
    q, s, d = fpk.quant_fingerprint(src, rows, CHUNK)
    qp, sp = qk.quantize_blocks_plain(src, rows)
    dp = fpk.digest_table(fpk.fingerprint_chunks_plain(
        torch.cat([qp.reshape(-1).view(torch.uint8), sp.view(torch.uint8)]),
        CHUNK))
    require_equal("quant_fingerprint q", q, qp)
    require_equal("quant_fingerprint s", s, sp)
    if not (d == dp).all():
        fail("quant_fingerprint digests differ from the plain versions")


# ------------------------------------------------------------ phase 3
def state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def flat_leaves(state, prefix="") -> dict:
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_leaves(v, key + "/"))
        else:
            out[key] = v
    return out


def check_restored(restored: dict, state: dict, quantized: set) -> None:
    """Unquantized leaves bit-exact; quantized ones equal to the plain
    dequantize(quantize(x)) of the saved values, computed on the card."""
    import torch
    from repro_torch.kernels.quantize import (LANE_COLS,
                                              dequantize_blocks_plain,
                                              quantize_blocks_plain)
    got, want = flat_leaves(restored), flat_leaves(state)
    if set(got) != set(want):
        fail(f"restored keys differ: {sorted(set(got) ^ set(want))[:4]}")
    for key, w in want.items():
        g = got[key]
        if g.device != w.device or g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{key}: restored {g.device}/{tuple(g.shape)}/{g.dtype}")
        if key not in quantized:
            if not torch.equal(bits(g), bits(w)):
                fail(f"{key}: restored bytes differ")
            continue
        src, out = w.reshape(-1), g.reshape(-1)
        step = 1 << 26                     # 64 Mi values = 128 Ki rows
        for a in range(0, src.numel(), step):
            part = src[a:a + step]
            rows = -(-part.numel() // LANE_COLS)
            qv, sv = quantize_blocks_plain(part, rows)
            ref = dequantize_blocks_plain(qv, sv, w.dtype, n=part.numel())
            if not torch.equal(bits(out[a:a + step]), bits(ref)):
                fail(f"{key}: restored values differ from the plain "
                     f"dequantize(quantize(x)) at [{a}, {a + step})")


def dirty_bound(state: dict, changed: dict, quant: set, blob_nbytes: int
                ) -> tuple[int, int]:
    """Upper bound (bytes, chunks) a delta save of ``changed`` spans may
    write: every chunk its changed payload bytes touch, plus the lean
    blob. Quantized tensors dirty the q rows and the scales they own."""
    from repro_torch.core import quant_codec
    leaves = flat_leaves(state)
    nbytes = chunks = 0

    def span(lo, hi):                     # payload byte span -> chunk count
        return (hi - 1) // CHUNK - lo // CHUNK + 1

    for key, (a, b) in changed.items():
        t = leaves[key]
        if key in quant:
            rows = quant_codec.packed_rows(t.numel())
            qb = rows * quant_codec.GROUP_COLS
            r0, r1 = a // 512, -(-b // 512)
            c = span(r0 * 512, r1 * 512) + span(qb + 4 * r0, qb + 4 * r1)
            nbytes += c * CHUNK + quant_codec.HEADER.size
        else:
            isz = t.element_size()
            c = span(a * isz, b * isz)
            nbytes += c * CHUNK
        chunks += c
    return nbytes + blob_nbytes, chunks


def storage_probe(root: str, nbytes: int = 4 << 30) -> dict:
    """The storage rate the main path runs against: one ``nbytes`` host
    buffer written and read back through the same engine and settings
    (aggregated, O_DIRECT), with no device work at all."""
    import numpy as np
    from repro_torch.core.engines import (EngineConfig, ReadReq, SaveItem,
                                          make_cr_engine)
    path = os.path.join(root, "storage_probe")
    os.makedirs(path, exist_ok=True)
    eng = make_cr_engine("aggregated", EngineConfig())
    buf = np.ones(nbytes, np.uint8)
    t0 = time.perf_counter()
    m = eng.save(path, [SaveItem("probe", buf)])
    write_s = time.perf_counter() - t0
    ext = m.blobs.get("probe") or m.tensors["probe"].shards[0]
    t0 = time.perf_counter()
    eng.read(path, [ReadReq("probe", ext.path, ext.offset, ext.nbytes)])
    read_s = time.perf_counter() - t0
    eng.close()
    shutil.rmtree(path, ignore_errors=True)
    out = dict(nbytes=nbytes, backend=eng.config.backend,
               write_gbps=nbytes / write_s / 1e9,
               read_gbps=nbytes / read_s / 1e9)
    log(f"storage probe ({nbytes} B, {eng.config.backend}, O_DIRECT): write "
        f"{out['write_gbps']:.3f} GB/s, read {out['read_gbps']:.3f} GB/s")
    return out


def stall(root: str) -> dict:
    """Attribution of the last ``root`` span's wall (repro_torch.core.trace)
    — printed, and returned as {category: seconds}."""
    from repro_torch.core import trace
    rep = trace.stall_report(root=root)
    if rep is None:
        fail(f"no {root} span was traced")
    parts = {k: v for k, v in sorted(rep.attribution.items(),
                                     key=lambda kv: -kv[1]) if v}
    log(f"  {root} wall {rep.wall:.3f} s by category: " + ", ".join(
        f"{k} {v:.3f} s ({100 * v / rep.wall:.1f}%)"
        for k, v in parts.items()))
    return parts


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_main_path(state: dict, root: str, probe_bytes: int = 4 << 30) -> dict:
    """Drive ``state`` (a qwen2.5-3b-layout train state) through
    CheckpointManager on the device its tensors live on."""
    import torch
    from repro_torch.core import CheckpointManager, trace
    from repro_torch.core.serialization import extract_tensors, serialize_lean
    from repro_torch.kernels import _lib

    quant_prefixes = ("opt/mu", "opt/nu")
    tensors, _lean = extract_tensors(state)
    device = next(iter(tensors.values())).device
    total = state_bytes(tensors)
    log(f"main path: {len(tensors)} tensors, {total} bytes "
        f"({total / 2**30:.2f} GiB) on {device}")
    quant = {k for k in tensors if k.startswith(quant_prefixes)
             and tensors[k].numel() * tensors[k].element_size() >= 1 << 16}
    out: dict = {"state_bytes": total, "tensors": len(tensors),
                 "storage": storage_probe(root, probe_bytes)}
    trace.enable()

    _lib.reset_launches()
    # (A) quantized async save + restore, no delta. The embedding is
    # mutated in place right after wait_snapshotted(), as an optimizer step
    # would; the restore must still return the saved (pre-mutation) values.
    dir_a = os.path.join(root, "nondelta")
    shutil.rmtree(dir_a, ignore_errors=True)
    leaves = flat_leaves(state)
    emb = leaves["params/embed"]
    saved_emb = emb.clone()
    with CheckpointManager(dir_a, quantize_prefixes=quant_prefixes,
                           device=device, keep=None, async_save=True) as mgr:
        t0 = time.perf_counter()
        m = mgr.save(1, state)
        mgr.wait_snapshotted()
        snap = time.perf_counter() - t0
        emb.add_(1.0)
        mgr.wait()
        wall = time.perf_counter() - t0
        log(f"(A) async save: blocking {m.blocking_seconds:.3f} s, "
            f"snapshotted {snap:.3f} s, wall {wall:.3f} s, written "
            f"{m.written_bytes} B, {total / wall / 1e9:.3f} GB/s of state, "
            f"staging copy {m.d2h_seconds:.3f} s, flush "
            f"{m.flush_seconds:.3f} s, commit {m.commit_seconds:.3f} s")
        out["A_save"] = dict(blocking_s=m.blocking_seconds,
                             snapshotted_s=snap, wall_s=wall,
                             total_bytes=m.total_bytes,
                             written_bytes=m.written_bytes,
                             staging_copy_s=m.d2h_seconds,
                             gbps_state=total / wall / 1e9,
                             gbps_written=m.written_bytes / wall / 1e9,
                             stall=stall("save"))
        sync(device)
        t0 = time.perf_counter()
        restored = mgr.restore(state_template=state, step=1)
        sync(device)
        wall = time.perf_counter() - t0
        rm = mgr.last_restore_metrics
        log(f"(A) restore: wall {wall:.3f} s ({total / wall / 1e9:.3f} GB/s"
            f" of state), read {rm.read_seconds:.3f} s, decode "
            f"{rm.decode_seconds:.3f} s, assemble {rm.assemble_seconds:.3f} s")
        out["A_restore"] = dict(wall_s=wall, read_s=rm.read_seconds,
                                read_stall_s=rm.read_stall_seconds,
                                decode_s=rm.decode_seconds,
                                assemble_s=rm.assemble_seconds,
                                gbps_state=total / wall / 1e9,
                                stall=stall("restore"))
    emb.copy_(saved_emb)                 # the values the save snapshotted
    del saved_emb
    check_restored(restored, state, quant)
    del restored
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(dir_a, ignore_errors=True)
    log("(A) restored state checked")

    # (B) delta chain
    dir_b = os.path.join(root, "delta")
    shutil.rmtree(dir_b, ignore_errors=True)
    changed = {}
    for key in ("params/embed", "opt/mu/embed",
                "opt/nu/blocks/b0_attn/mlp/wd",
                "params/blocks/b0_attn/wq"):
        n = leaves[key].numel()
        a = n // 3
        changed[key] = (a, a + n // 100)          # a contiguous 1% slice
    with CheckpointManager(dir_b, delta=True, quantize_prefixes=quant_prefixes,
                           device=device, keep=None) as mgr:
        t0 = time.perf_counter()
        m1 = mgr.save(1, state)
        wall1 = time.perf_counter() - t0
        if m1.chunks_dirty != m1.chunks_total:
            fail("delta step 1 must write every chunk")
        log(f"(B) delta step 1: blocking {m1.blocking_seconds:.3f} s, wall "
            f"{wall1:.3f} s, written {m1.written_bytes} B, d2h "
            f"{m1.d2h_bytes} B, chunks {m1.chunks_dirty}/{m1.chunks_total}, "
            f"fingerprint {m1.fingerprint_seconds:.3f} s")
        out["B_save1"] = dict(blocking_s=m1.blocking_seconds, wall_s=wall1,
                              written_bytes=m1.written_bytes,
                              d2h_bytes=m1.d2h_bytes,
                              chunks=m1.chunks_total,
                              fingerprint_s=m1.fingerprint_seconds,
                              diff_s=m1.diff_seconds, stall=stall("save"))
        for key, (a, b) in changed.items():
            leaves[key].view(-1)[a:b] += 1.0 if key.startswith("params") \
                else 1e-3
        sync(device)
        t0 = time.perf_counter()
        m2 = mgr.save(2, state)
        wall2 = time.perf_counter() - t0
        _, lean = extract_tensors(state)
        bound, bound_chunks = dirty_bound(state, changed, quant,
                                          len(serialize_lean(lean)))
        log(f"(B) delta step 2: blocking {m2.blocking_seconds:.3f} s, wall "
            f"{wall2:.3f} s, written {m2.written_bytes} B (bound {bound}), "
            f"d2h {m2.d2h_bytes} B, chunks {m2.chunks_dirty}/"
            f"{m2.chunks_total} (bound {bound_chunks}), fingerprint "
            f"{m2.fingerprint_seconds:.3f} s")
        out["B_save2"] = dict(blocking_s=m2.blocking_seconds, wall_s=wall2,
                              written_bytes=m2.written_bytes,
                              d2h_bytes=m2.d2h_bytes,
                              chunks_dirty=m2.chunks_dirty,
                              chunks_total=m2.chunks_total,
                              written_bound=bound,
                              fingerprint_s=m2.fingerprint_seconds,
                              diff_s=m2.diff_seconds, stall=stall("save"))
        if not 0 < m2.chunks_dirty <= bound_chunks:
            fail(f"step 2 dirtied {m2.chunks_dirty} chunks, bound "
                 f"{bound_chunks}")
        if m2.written_bytes > bound:
            fail(f"step 2 wrote {m2.written_bytes} B, bound {bound}")
        sync(device)
        t0 = time.perf_counter()
        restored = mgr.restore(state_template=state, step=2)
        sync(device)
        wall = time.perf_counter() - t0
        rm = mgr.last_restore_metrics
        log(f"(B) delta restore of step 2: wall {wall:.3f} s "
            f"({total / wall / 1e9:.3f} GB/s of state), read "
            f"{rm.read_seconds:.3f} s, decode {rm.decode_seconds:.3f} s, "
            f"assemble {rm.assemble_seconds:.3f} s")
        out["B_restore2"] = dict(wall_s=wall, gbps_state=total / wall / 1e9,
                                 read_s=rm.read_seconds,
                                 read_stall_s=rm.read_stall_seconds,
                                 decode_s=rm.decode_seconds,
                                 assemble_s=rm.assemble_seconds,
                                 stall=stall("restore"))
    trace.disable()
    check_restored(restored, state, quant)
    del restored
    shutil.rmtree(dir_b, ignore_errors=True)
    log("(B) restored state checked")
    out["launches"] = dict(_lib.LAUNCHES)
    log(f"kernel launches over (A)+(B): {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the main path")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs only on the card")
    from repro_torch.kernels import _lib

    # phase 1: build
    t0 = time.perf_counter()
    _lib.lib()
    built = (f"nvcc {_lib.build_seconds:.1f} s" if _lib.build_seconds
             else "already built from these sources")
    log(f"build: {time.perf_counter() - t0:.1f} s ({built}) -> "
        f"{_lib.library_path()}")
    for line in _lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.strip())
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: kernels against their plain versions (tolerance: bit-exact)
    results: dict = {}
    check_kernels(results)
    for name, r in results.items():
        log(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, max abs err {r['max_abs_err']} "
            f"(bit-exact required)")

    # phase 3: main path, full width and full depth
    from repro_torch.configs import make_train_state, train_state_inventory
    state = make_train_state(train_state_inventory("qwen2.5-3b"),
                             device="cuda", seed=0)
    torch.cuda.synchronize()
    log("main path: qwen2.5-3b train state, 36 stacked layers, no cut")
    root = os.path.join(HERE, "build", "smoke_ckpt")
    try:
        main_path = run_main_path(state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, kernels=results, main_path=main_path),
                      f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
