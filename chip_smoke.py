#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each failing the run (non-zero exit, no result line) on any error:

  1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
               with nvcc (sm_90a); print the build time and the card's name
               and power limit (nvidia-smi).
  2. kernels — every kernel against its plain PyTorch version on the card,
               bit for bit, at main-path shapes (a 256 MiB slice of the
               ``mlp/wd`` moment, the bf16 ``embed``; the RG-LRU scan's
               forward, reverse and fused backward at (8, 255, 2560), on the
               bulk-copy path and on a misaligned copy that takes the 4-byte
               path) and at edge cases (ragged last chunk, odd bf16 lane
               count, all-zero rows, exact .5 quotients; S=1, R=1, R=2561,
               S=300, S at and around the ring's stage edges, the 0.999^t
               carry); CUDA-event times beside the bytes-moved bound at 3.35
               TB/s and the plain version's time, and the unfused RG-LRU
               backward as the fused one's yardstick.
  3. checkpoint path — the full-width qwen2.5-3b train state (44 tensors;
               depth cut to 4 of 36 layers, since the machine takes 45 GiB of
               disk writes per call and phase 4 needs 29 of them; random values
               from a seeded torch.Generator on the card) through
               ``CheckpointManager``: (A) a quantized async save
               (the embedding mutated in place right after
               ``wait_snapshotted()``) + restore,
               (B) a delta chain — step 1, a contiguous 1% change of a few
               tensors, step 2, restore of step 2. Restored bytes are checked
               (unquantized: bit-exact; quantized: equal to the plain
               dequantize(quantize(x)) on the card), step 2's written bytes
               are held to the dirty chunks plus the lean blob, and each of
               the four checkpoint kernels must be launched in (A) + (B).
  4. training path — full-width, full-depth recurrentgemma-2b (26 layers, no
               cut; weights from a seeded torch.Generator) through the port's
               ``Trainer`` at batch 8 x 255 tokens: run 1 trains 3 steps with
               an async checkpoint at step 2 (keep=1) — step 3 updates the
               state in place right after ``wait_snapshotted()`` — and every
               leaf is digested with the fingerprint kernel as the save is
               called; run 2, a fresh ``Trainer`` on the same directory, must
               resume at step 2 with every digest equal and train 2 more
               steps. One checkpoint of 28.94 GB: two would pass the machine's
               45 GiB of disk writes per call. Every loss must be finite and
               the RG-LRU kernel must be launched.
     4b. the same stack on a narrow float32 config: two train steps on the
               card against two on the CPU (plain path) from one set of
               weights and batches.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON, and the one before that the nvidia-smi line. The run
needs one card, the repository's ``src/`` beside this file, and room for one
~29 GB checkpoint under ``build/``.
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
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru.cu",
                   "src/repro/kernels/rglru.py:43"),
}
# the kernels each main path must launch
CHECKPOINT_KERNELS = ("quantize_blocks", "dequantize_blocks",
                      "fingerprint_chunks", "quantize_fingerprint_blocks")
TRAINING_KERNELS = ("rglru_scan",)
TRAIN_SHAPE = (8, 255, 2560)       # (batch, tokens, lru_dim) of phase 4
# The chip machine takes at most 45 GiB of disk writes per call, deleted
# files included. Phase 4 writes one full recurrentgemma-2b checkpoint
# (28.94 GB), so phase 3 runs qwen2.5-3b at a cut depth: every width kept,
# 4 of its 36 stacked layers (~2.5 GB per save, two saves, a 1 GiB probe).
CHECKPOINT_LAYERS = 4


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


def device_ms(fn, reps: int, warmup: int = 20) -> float:
    """Device time of one ``fn`` call: the kernel time that
    ``torch.profiler`` records over ``reps`` calls, summed over every kernel
    a call launches, per call. Unlike ``cuda_ms`` it leaves out the gaps
    between kernels, so it reads a kernel whose host-side launch takes
    about as long as the kernel itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("torch.profiler recorded no kernel time")
    return us / reps / 1e3


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


def misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its buffer: the
    RG-LRU kernel must take its 4-byte cp.async path for it."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# edge shapes of B5: one step; one column; an odd width; S = 300; S below,
# at k*T +- 1 of and on the ring's wraps (T = 32 steps a stage; 4 stages
# forward and reverse, 3 in the fused backward); a narrow last column tile
# on the bulk path (R = 2564)
RGLRU_EDGES = ((4, 1, 2560), (8, 255, 1), (2, 255, 2561), (2, 300, 2560),
               (2, 5, 2560), (2, 31, 2560), (2, 33, 2560), (2, 63, 2560),
               (2, 65, 2560), (2, 97, 2564), (2, 129, 2560), (2, 257, 2560))


def check_rglru(results: dict) -> None:
    """B5's three modes (forward, g-only reverse, fused backward) against
    their plain loops, bit for bit, at the training path's shape, at edge
    shapes, on misaligned views (the 4-byte copy path) and with the 0.999^t
    carry; CUDA-event times beside the bytes bounds, with the unfused
    backward (the g-only reverse plus the three PyTorch passes that the
    fused mode replaced) timed as its yardstick."""
    import torch
    from repro_torch.kernels import rglru as rk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def inputs(shape):
        a = torch.rand(shape, device=dev, generator=gen) * 0.3 + 0.69
        b = torch.randn(shape, device=dev, generator=gen) * 0.1
        dh = torch.randn(shape, device=dev, generator=gen)
        return a, b, dh

    def check(tag, a, b, dh, want=None):
        """Every mode on (a, b, dh) against the plain loops (or ``want``,
        the plain outputs of equal data); returns them and the max error."""
        h = rk.linear_scan(a, b)
        g = rk.linear_scan(a, dh, reverse=True)
        da, g2 = rk.linear_scan_grad(a, h, dh)
        torch.cuda.synchronize()
        if want is None:
            h_p = rk.linear_scan_plain(a, b)
            want = (h_p, *rk.linear_scan_grad_plain(a, h_p, dh))
        err = max(require_equal(f"rglru_scan forward {tag}", h, want[0]),
                  require_equal(f"rglru_scan reverse {tag}", g, want[2]),
                  require_equal(f"rglru_scan grad da {tag}", da, want[1]),
                  require_equal(f"rglru_scan grad g {tag}", g2, want[2]))
        return want, err

    a, b, dh = inputs(TRAIN_SHAPE)
    want, err = check(f"{TRAIN_SHAPE}", a, b, dh)
    variant = rk.copy_variant(a, b)
    if variant != "bulk":
        fail(f"rglru_scan at {TRAIN_SHAPE} took the {variant} copy path")
    h = want[0]
    # a misaligned copy of the same data: the 4-byte cp.async variant
    am, bm, hm, dhm = (misaligned(t) for t in (a, b, h, dh))
    if rk.copy_variant(am, bm, hm, dhm) != "cp.async":
        fail("a misaligned view did not take the 4-byte copy path")
    check(f"{TRAIN_SHAPE} misaligned", am, bm, dhm, want)

    def unfused():              # the backward before the fused mode
        g = rk.linear_scan(a, dh, reverse=True)
        h_prev = torch.zeros_like(h)
        h_prev[:, 1:] = h[:, :-1]
        return g * h_prev, g

    # each input read once, each output written once
    nbytes = a.numel() * 4
    # forward first and last: the first timing of a run can catch the
    # card's clocks still ramping; both forward timings are kept
    first_ms = cuda_ms(lambda: rk.linear_scan(a, b), 100, 20)
    reverse_ms = cuda_ms(lambda: rk.linear_scan(a, dh, reverse=True), 100, 20)
    grad_ms = cuda_ms(lambda: rk.linear_scan_grad(a, h, dh), 100, 20)
    unfused_ms = cuda_ms(unfused, 100, 20)
    cp_async_ms = dict(
        forward=cuda_ms(lambda: rk.linear_scan(am, bm), 100, 20),
        reverse=cuda_ms(lambda: rk.linear_scan(am, dhm, reverse=True),
                        100, 20),
        grad=cuda_ms(lambda: rk.linear_scan_grad(am, hm, dhm), 100, 20))
    # the same calls' kernel time alone (profiler), without launch gaps
    device = dict(
        forward=device_ms(lambda: rk.linear_scan(a, b), 100),
        reverse=device_ms(lambda: rk.linear_scan(a, dh, reverse=True), 100),
        grad=device_ms(lambda: rk.linear_scan_grad(a, h, dh), 100),
        unfused_grad=device_ms(unfused, 100),
        cp_async_forward=device_ms(lambda: rk.linear_scan(am, bm), 100),
        cp_async_grad=device_ms(lambda: rk.linear_scan_grad(am, hm, dhm),
                                100))
    results["rglru_scan"] = dict(
        max_abs_err=err, first_ms=first_ms, reverse_ms=reverse_ms,
        grad_ms=grad_ms, unfused_grad_ms=unfused_ms, cp_async_ms=cp_async_ms,
        device_ms=device,
        ms=cuda_ms(lambda: rk.linear_scan(a, b), 100, 20),
        plain_ms=cuda_ms(lambda: rk.linear_scan_plain(a, b), 3, 1),
        reverse_plain_ms=cuda_ms(
            lambda: rk.linear_scan_plain(a, dh, reverse=True), 3, 1),
        grad_plain_ms=cuda_ms(lambda: rk.linear_scan_grad_plain(a, h, dh),
                              3, 1),
        bound_ms=bound_ms(3 * nbytes), grad_bound_ms=bound_ms(5 * nbytes),
        library_ms=None, variant=variant,
        shape=f"a, b {TRAIN_SHAPE} f32")
    del a, b, dh, h, am, bm, hm, dhm, want
    for shape in RGLRU_EDGES:
        check(f"{shape}", *inputs(shape))
    check("(2, 65, 2560) misaligned",
          *(misaligned(t) for t in inputs((2, 65, 2560))))
    a = torch.full((1, 300, 128), 0.999, device=dev)
    b = torch.zeros_like(a)
    b[:, 0] = 1.0
    (h, _, _), _ = check("carry", a, b, torch.flip(b, (1,)))
    want = 0.999 ** torch.arange(300, dtype=torch.float64, device=dev)
    carry_err = float(((h[0, :, 0].double() - want) / want).abs().max())
    if carry_err > 1e-4:    # f32 rounding of 300 multiplies stays below
        fail(f"rglru_scan carry: h_t differs from 0.999^t by {carry_err}")
    del a, b, h
    torch.cuda.empty_cache()


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


def storage_probe(root: str, nbytes: int = 1 << 30) -> dict:
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


def run_main_path(state: dict, root: str, probe_bytes: int = 1 << 30) -> dict:
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
    out["launches"] = {k: _lib.LAUNCHES[k] for k in CHECKPOINT_KERNELS}
    log(f"kernel launches over (A)+(B): {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the checkpoint path")
    return out


# ------------------------------------------------------------ phase 4
def finite_losses(out: dict, steps: list[int]) -> list[float]:
    import math
    got = [m["step"] for m in out["metrics"]]
    if got != steps:
        fail(f"trainer logged steps {got}, expected {steps}")
    losses = [m["loss"] for m in out["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    return losses


def digests(state: dict) -> dict:
    """key -> fp128 digest table (on the host) of every tensor leaf."""
    from repro_torch.kernels import fingerprint as fpk
    return {k: fpk.fingerprint_chunks(t.contiguous(), CHUNK).cpu()
            for k, t in flat_leaves(state).items()}


def log_steps(tag: str, out: dict, tokens: int) -> list[dict]:
    rows = []
    for m in out["metrics"]:
        rows.append(dict(step=m["step"], seconds=m["seconds"],
                         tokens_per_s=tokens / m["seconds"], loss=m["loss"],
                         grad_norm=m["grad_norm"]))
        log(f"  {tag} step {m['step']}: {m['seconds']:.3f} s, "
            f"{tokens / m['seconds']:.0f} tokens/s, loss {m['loss']:.4f}, "
            f"grad norm {m['grad_norm']:.4f}")
    return rows


KERNEL_GROUPS = (("rglru_scan", ("rglru_scan",)),
                 ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
                 ("elementwise", ("elementwise",)),
                 ("reduction", ("reduce",)))


def device_profile(prof, wall_s: float, steps: int, top: int = 8) -> dict:
    """Kernel time from a ``torch.profiler`` run (kernel events only, so no
    time is counted twice): per group of kernels, the busiest kernels, and
    the device's busy share of the profiled window's host wall (the
    profiler adds host overhead, so the window is slower than a plain
    step)."""
    from torch.autograd import DeviceType
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        log("  torch.profiler recorded no kernel time: device busy share "
            "not measured")
        return {}
    busy_ms = sum(r[1] for r in rows)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in rows:
        name = next((g for g, marks in KERNEL_GROUPS
                     if any(m in key for m in marks)), "other")
        groups[name] += ms
    log(f"  run 2 profile ({steps} steps): kernels {busy_ms:.1f} ms "
        f"({busy_ms / steps:.1f} ms per step) in {wall_s * 1e3:.1f} ms of "
        f"profiled host wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy); "
        + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f}%)"
                    for g, ms in groups.items()))
    for key, ms, n in rows[:top]:
        log(f"    {ms:9.2f} ms  {n:6d} x  {key[:90]}")
    return dict(kernel_ms=busy_ms, wall_ms=wall_s * 1e3, steps=steps,
                groups_ms=groups,
                top=[dict(name=k, ms=ms, count=n) for k, ms, n in rows[:top]])


def run_training(root: str) -> dict:
    """Phase 4: full recurrentgemma-2b through the port's Trainer, with an
    async checkpoint followed by an in-place step, and a resume in a fresh
    Trainer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.kernels import _lib, rglru as rk
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("recurrentgemma-2b")
    layout = flat_leaves(init_train_state(cfg, device="meta"))
    total = state_bytes(layout)
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    log(f"training path: {cfg.name}, {cfg.num_layers} layers (no cut), "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}; train state "
        f"{len(layout)} tensors, {total} B ({total / 2**30:.2f} GiB); batch "
        f"{B} x {S} tokens")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < total + (2 << 30):
        fail(f"{root}: {free} B free, the run needs room for a checkpoint "
             f"of {total} B")

    def trainer(steps, ckpt_every):
        return Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=ckpt_every, ckpt_dir=root,
            async_ckpt=True, keep=1, log_every=1, seed=0), device="cuda")

    out: dict = {"state_bytes": total, "tensors": len(layout)}
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    rk.COPY_LAUNCHES.update({k: 0 for k in rk.COPY_LAUNCHES})
    # run 1: 3 steps, an async checkpoint at step 2, then step 3 in place;
    # the state is digested on the card as the save is called
    t1 = trainer(3, 2)
    saved: dict = {}
    save = t1.ckpt.save

    def digesting_save(step, state):
        saved[step] = digests(state["train"])
        return save(step, state)

    t1.ckpt.save = digesting_save
    try:
        r1 = t1.run()
    finally:
        t1.close()
    finite_losses(r1, [0, 1, 2])
    steps1 = log_steps("run 1", r1, B * S)
    saves = [dict(step=m.step, blocking_s=m.blocking_seconds,
                  wall_s=m.end_to_end_seconds, total_bytes=m.total_bytes,
                  written_bytes=m.written_bytes, staging_copy_s=m.d2h_seconds,
                  flush_s=m.flush_seconds, commit_s=m.commit_seconds)
             for m in t1.save_log]
    for sv in saves:
        log(f"  async save of step {sv['step']}: blocking "
            f"{sv['blocking_s']:.3f} s, wall {sv['wall_s']:.3f} s "
            f"({total / sv['wall_s'] / 1e9:.3f} GB/s of state), written "
            f"{sv['written_bytes']} B")
    log(f"  run 1: wall {r1['wall_seconds']:.3f} s, checkpoint stall "
        f"{r1['ckpt_blocking_seconds']:.3f} s (save calls, this script's "
        f"digest pass included; SaveMetrics blocking "
        f"{r1['ckpt_blocking_reported_s']:.3f} s) of which wait_snapshotted()"
        f" {r1['ckpt_snapshot_wait_seconds']:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    out["run1"] = dict(steps=steps1, saves=saves,
                       wall_s=r1["wall_seconds"],
                       ckpt_blocking_s=r1["ckpt_blocking_seconds"],
                       snapshot_wait_s=r1["ckpt_snapshot_wait_seconds"],
                       peak_device_bytes=torch.cuda.max_memory_allocated(),
                       save_stall=stall("save"))
    del r1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # run 2: a fresh Trainer resumes at step 2 and trains 2 more steps (it
    # checkpoints every 5, so it writes nothing more)
    t2 = trainer(4, 5)
    try:
        state, start = t2.initial_state()
        if start != 2 or list(saved) != [2]:
            fail(f"run 2 resumed at step {start}; run 1 saved {list(saved)}")
        got, want = digests(state), saved[2]
        if got.keys() != want.keys():
            fail("restored state has other leaves than the saved one")
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad:
            fail(f"{len(bad)} restored leaves differ from the state run 1 "
                 f"saved, e.g. {bad[:3]}")
        wall = t2.restore_attr["restore_seconds"]
        log(f"  run 2 restored step 2 in {wall:.3f} s ({total / wall / 1e9:.3f}"
            f" GB/s of state); {len(want)} leaf digests equal the saved "
            f"state's (step 3 had updated it in place)")
        restore = dict(t2.restore_attr, stall=stall("restore"))
        # run 2 saves nothing: profile its two steps for the device's view
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r2 = t2.run((state, start))
    finally:
        t2.close()
    del state
    finite_losses(r2, [2, 3])
    # the resumed step 2 sees run 1's step-2 state and batch
    l1 = out["run1"]["steps"][2]["loss"]
    l2 = r2["metrics"][0]["loss"]
    if abs(l2 - l1) > 1e-4 * abs(l1):
        fail(f"resumed step 2 loss {l2} differs from run 1's {l1}")
    out["launches"] = {k: _lib.LAUNCHES[k] for k in TRAINING_KERNELS}
    out["rglru_copy_launches"] = dict(rk.COPY_LAUNCHES)
    trace.disable()
    out["run2"] = dict(steps=log_steps("run 2", r2, B * S), restore=restore,
                       wall_s=r2["wall_seconds"],
                       peak_device_bytes=torch.cuda.max_memory_allocated(),
                       profile=device_profile(prof, r2["wall_seconds"], 2))
    del r2
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    out["train_steps"] = 5
    log(f"kernel launches over runs 1 and 2 (5 train steps): "
        f"{out['launches']} ({out['launches']['rglru_scan'] / 5:g} "
        f"rglru_scan per step; by copy variant "
        f"{out['rglru_copy_launches']})")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the training path")
    return out


def cpu_vs_card() -> dict:
    """Phase 4b: two train steps of a narrow float32 recurrentgemma on the
    card and on the CPU from one set of weights and batches. Tolerances:
    loss rtol 1e-4 (cuBLAS and the CPU sum in other orders); params within
    5e-5 + 1e-4 relative (a few learning-rate-sized AdamW steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 matmuls
    cfg = get_config("recurrentgemma-2b").replace(
        dtype="float32", num_layers=3, block_pattern=("rglru", "rglru",
                                                      "attn_local"),
        d_model=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
        lru_dim=200, vocab_size=512, sliding_window=16)
    cpu_state = init_train_state(cfg, seed=0, device="cpu")
    states = {"cuda": tree_map_with_path(lambda _p, t: t.cuda(), cpu_state),
              "cpu": cpu_state}
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=0))
    losses: dict = {}
    for dev, state in states.items():
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        for s in range(2):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch_at(s).items()}
            state, m = step(state, batch)
            losses.setdefault(dev, []).append(float(m["loss"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    if loss_err > 1e-4:
        fail(f"card vs CPU losses {losses}")
    got = flat_leaves(states["cuda"]["params"])
    param_err = 0.0
    for k, want in flat_leaves(states["cpu"]["params"]).items():
        diff = (got[k].cpu().double() - want.double()).abs()
        param_err = max(param_err, float(diff.max()))
        if bool((diff > 5e-5 + 1e-4 * want.double().abs()).any()):
            fail(f"card vs CPU params differ at {k}: max {float(diff.max())}")
    log(f"card vs CPU, narrow float32, 2 steps: losses {losses['cuda']} vs "
        f"{losses['cpu']} (max rel {loss_err:.2e}), params max abs diff "
        f"{param_err:.2e}")
    return dict(losses=losses, loss_rel_err=loss_err,
                param_max_abs_err=param_err)


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
    entry = "?"
    for line in _lib.build_log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: kernels against their plain versions (tolerance: bit-exact)
    results: dict = {}
    check_kernels(results)
    check_rglru(results)
    for name, r in results.items():
        log(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, max abs err {r['max_abs_err']} "
            f"(bit-exact required)")
    r = results["rglru_scan"]
    log(f"kernel rglru_scan forward timed first: {r['first_ms']:.4f} ms; "
        f"reverse (g only) {r['reverse_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms, plain {r['reverse_plain_ms']:.4f} ms; "
        f"fused backward {r['grad_ms']:.4f} ms, bound "
        f"{r['grad_bound_ms']:.4f} ms, plain {r['grad_plain_ms']:.4f} ms; "
        f"unfused backward (reverse + zeros_like + shifted copy + mul) "
        f"{r['unfused_grad_ms']:.4f} ms")
    log(f"kernel rglru_scan copy variant at {TRAIN_SHAPE}: {r['variant']}; "
        f"4-byte cp.async variant on a misaligned copy: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in r["cp_async_ms"].items()))
    log("kernel rglru_scan device time per call (torch.profiler): " +
        ", ".join(f"{k} {v:.4f} ms" for k, v in r["device_ms"].items()))

    # phase 3: checkpoint path, full width and full depth
    from repro_torch.configs import make_train_state, train_state_inventory
    state = make_train_state(train_state_inventory("qwen2.5-3b"),
                             device="cuda", seed=0, layers=CHECKPOINT_LAYERS)
    torch.cuda.synchronize()
    log(f"checkpoint path: qwen2.5-3b train state, depth cut to "
        f"{CHECKPOINT_LAYERS} of 36 stacked layers (every width kept)")
    root = os.path.join(HERE, "build", "smoke_ckpt")
    t0 = time.perf_counter()
    try:
        main_path = run_main_path(state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    log(f"checkpoint path: {time.perf_counter() - t0:.1f} s")

    # phase 4: training path, full width and full depth
    t0 = time.perf_counter()
    training = run_training(os.path.join(HERE, "build", "smoke_train"))
    log(f"training path: {time.perf_counter() - t0:.1f} s")
    training["cpu_vs_card"] = cpu_vs_card()

    launches = dict(main_path["launches"], **training["launches"])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, kernels=results, main_path=main_path,
                           training=training), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
