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
               depth cut to 1 of 36 layers, since the machine takes 45 GiB of
               disk writes per call and phase 4 needs 29 of them; random values
               from a seeded torch.Generator on the card; AdamW moments
               quantized) through the port's storage stack, after an O_DIRECT
               probe and a 512 MiB storage probe:
               (A) ``MultiLevelCheckpointer``: an async save at level 0 (the
               embedding mutated in place right after ``wait_snapshotted()``),
               its level-1 flush, node loss (level 0 deleted), and a restore
               onto the card through ``RestorePrefetcher`` that promotes the
               step back to level 0;
               (B) ``RemoteCheckpointer`` over ``SimObjectStore``: a delta
               chain (step 1, a contiguous 1% change of four tensors, step 2),
               each step uploaded with chunk dedup, node loss, and a stream
               restore of step 2 straight from the store onto the card;
               (C) the same state saved and restored (reads made cold) through
               each engine: aggregated, datastates, snapshot, torchsave;
               (D) ``MultiWriterCheckpointer``: 4 writer ranks save the CUDA
               state's row views asynchronously into one SINGLE_FILE O_DIRECT
               checkpoint (each rank quantizing its rows of the moments, rank
               0 merge-committing), then a cold restore onto the card, an
               elastic 4 -> 2 restore, and a restore into DTensor templates
               on a 1-rank NCCL mesh (B1 and B2 launched within (D)).
               Restored bytes are checked (unquantized: bit-exact; quantized:
               equal to the plain dequantize(quantize(x)) on the card, per
               writer rank's rows), step 2's written and uploaded bytes are
               held to the dirty chunks plus the lean blob (and the
               manifest), and each of the four checkpoint kernels must be
               launched in (A) + (B) + (C) + (D). A tally of every byte
               written (probe, saves, flushes, uploads, promotes, phase 4's
               checkpoint, 4f's failover child's write calls and its
               promote, 4c, 4d, 4e's zoo example, the campaign's write
               calls) must stay under 44 GiB; the plan is checked before
               phase 3 starts.
  4. training path — full-width recurrentgemma-2b cut to the first 7
               blocks of its 13-block pattern ((RG-LRU, RG-LRU, local
               attention) x 2, RG-LRU; weights from a seeded
               torch.Generator), through the port's ``Trainer`` at batch 8 x
               255 tokens: run 1 trains 3 steps with an async checkpoint at
               step 2 (keep=1) — step 3 updates the state in place right
               after ``wait_snapshotted()`` — and every leaf is digested with
               the fingerprint kernel as the save is called; run 2, a fresh
               ``Trainer`` on the same directory, must resume at step 2 with
               every digest equal and train 2 more steps. One checkpoint of
               12.61 GB (the full depth's 28.94 GB, 13 layers' 17.75 GB and
               10 layers' 15.18 GB left no room in the machine's 45 GiB of
               disk writes per call for 4f's three copies of xlstm-350m and
               4k's checkpoint), so phase 4 and 4e numbers at this depth are
               not comparable with those of other depths. Every loss must be finite and the RG-LRU kernel must
               be launched.
     4b. narrow float32 configs on the card against the CPU (plain path):
               two train steps each from one set of weights and batches — the
               recurrentgemma stack, xLSTM at 255 tokens (quadratic mLSTM)
               and at 512 (the chunkwise form, two chunks), olmoe's MoE
               blocks, musicgen's frontend prefix.
     4c. ``Trainer(multilevel_remote=)`` on 4b's config on the card: run 1
               saves step 2 at levels 0 and 1, level 0 is deleted, and run 2
               resumes step 2 through the prefetcher, every leaf digest equal,
               and trains one more step.
     4d. ``Trainer(ckpt_writers=2, async_ckpt=True)`` on 4b's config on the
               card: step 3 runs in place right after the multi-writer
               snapshot barrier; a fresh single-writer Trainer resumes step 2
               and must match the uninterrupted run bit for bit (loss and
               every final leaf).
     4e. serving path, on phase 4's checkpoint after run 2 — (a) with its
               reads made cold, a fresh ``CheckpointManager`` swaps phase
               4's step 2 onto the card, reading only the params (the
               moments get empty windows through ``window_fn``), each leaf
               equal to the saved state's digest; (b) 8 seeded requests of
               64-token prompts through one ``make_prefill_step`` call (the
               RG-LRU scan once per RG-LRU block: 5 launches at
               (8, 64, 2560), all on the bulk-copy path that phase 2 holds
               bit for bit at that shape) and ``steps.generate`` (the
               prompt teacher-forced through ``decode_step``, then 32
               greedy tokens): the decode logits at the last prompt
               position within 0.05 of the largest prefill logit (the JAX
               package's decode-vs-forward yardstick); prefill ms, decode
               ms per step, tokens/s, peak memory; (c) full-width
               qwen2.5-3b, initialised on the card and never checkpointed,
               served the same way; (d) ``examples/torch_serve_swap.main``
               on the card (its delta saves fingerprint with B3); (e) a
               narrow float32 decode on the card against the CPU; last, a
               7-step decode window under torch.profiler (kernel time, busy
               share, host stream syncs) of each served model at full depth
               from ``init_params``: recurrentgemma-2b, qwen2.5-3b, and
               4f's and 4g's xlstm-350m and olmoe-1b-7b.
     4f. the slice's path, failover: xlstm-350m (the training CLI's
               default) at full width and depth, no cut (24 layers of mLSTM
               and sLSTM blocks, d_model 1024, 4 heads, up-projection 2048,
               vocab 50304). (i) ``python -m repro_torch.launch.train
               --arch xlstm-350m --full --remote-dir R --ckpt-every 2`` is
               SIGKILLed once step 2 is committed at level 1 and step 4's
               save has begun at level 0; (ii) a Trainer of the same
               arguments resumes step 2 from level 0, skipping the torn
               step, digests every leaf (the fingerprint kernel) and re-runs
               steps 2 and 3, each loss within 1e-6 relative of (i)'s, and
               saves nothing; (iii) level 0 is wiped and a third restores
               step 2 from level 1 through the prefetcher, every digest
               equal to (ii)'s. Kill-to-resume wall, the level-1 flush
               (seconds, bytes, GB/s, seen by this script's 5 ms watch) and
               the node-loss restore wall and read stall are reported. Then
               step 2 is served as in 4e — params swapped in with cold
               reads, 8 requests prefilled, 32 greedy tokens through the
               mLSTM and sLSTM decode caches in bf16 (decode vs prefill
               reported: at this depth bf16 takes the two forms apart, in
               the reference too), then again in float32 on the same
               weights, decode within 0.05 of the prefill; last, one train
               step of one full-width (mLSTM, sLSTM) group under
               torch.profiler.
     4g. full-width olmoe-1b-7b (16 layers, 64 experts, top-8; 6.92 B
               params, bf16, never checkpointed) served as in 4e at capacity
               factor 8.0 (no drops: the 0.05 gate holds) and at its own
               1.25 (the ratio reported only).
     4h. the sharding layer: (a) phase 4's checkpoint of step 2 (after 4e)
               resumed by a third Trainer with ``mesh=make_host_mesh(1, 1)``
               on a 1-rank NCCL group, through ``restore(shardings=)`` with
               the Partitioner's layouts onto a ``meta`` template: every
               leaf a DTensor whose local block equals the saved state's
               digest; steps 2 and 3 on DTensors (nothing written), each
               loss within 1e-4 relative of run 2's, B5 launched through
               ``local_map`` 15 times a step; step walls beside run 1's
               and run 2's, restore wall, peak memory; a warm step 4 whose
               peak memory the dry run predicts (below); then a step 4 on
               the mesh under torch.profiler (kernel time and the host's
               operator calls beside run 2's profile). (b) after 4f's run 2 has checked
               its resume (its state is then the saved one, whose windows
               are CRC'd on the host), 4 CPU processes on a gloo group
               restore 4f's xlstm-350m checkpoint onto a 2x2 mesh, each
               reading its windows only and reporting its bytes, wall and
               a CRC of every local block, each equal to its window's. (c)
               ``python -m repro_torch.launch.train --mesh 1x1 --steps 2
               --ckpt-every 0`` on the card.
     4i. serving on a mesh, after 4h (a), on a 1-rank NCCL group and
               ``make_host_mesh(1, 1)``: (a) with its reads made cold,
               phase 4's step 2 swapped in params-only at ``serve_specs``'
               param layouts through ``restore(shardings=, window_fn=)``
               (the bytes read must be the param windows' extents, no
               moment byte), every local block equal to the saved state's
               digest (the fingerprint kernel); 4e's requests prefilled on
               DTensors (B5 5 times under ``local_map``) and decoded by
               ``generate`` through DTensor caches laid out by
               ``serve_cache_layouts``: decode vs prefill within 0.05, the
               greedy tokens equal to 4e's unsharded run, the largest
               difference of the last prompt logits from 4e's reported;
               (b) full-width, full-depth qwen2.5-3b, initialised on the
               card as in 4e (c), distributed to the serve layouts and
               served with the same gates against 4e (c). Both run
               attention split over ``model`` (``layers._attention_local``)
               and the lookup at the table's own layout. Swap-in wall,
               prefill ms, decode ms per step beside 4e's and beside the
               runs before this split (``MESH_SERVE_BEFORE``), tokens/s,
               peak memory.
               Nothing is written. (A 1x1 mesh splits nothing and
               NCCL refuses two ranks on one card: the split timeline is
               held on gloo ranks in the tests and on four cards.)
     4j. expert-parallel MoE on a 1-rank NCCL group and
               ``make_host_mesh(1, 1)`` (as 4h and 4i; nothing written): (a)
               4g's bf16 params distributed to the serve layouts (each
               expert stack split over ``model``) and 4g's requests at
               capacity 8.0 served through ``moe_apply``'s mesh path: the
               greedy tokens equal to 4g's, decode vs prefill within 0.05;
               the last prompt logits' largest difference from 4g's,
               prefill ms, decode ms per step beside 4g's and peak memory
               reported beside the earlier slices' (``MOE_MESH_BEFORE``,
               ``MESH_SERVE_BEFORE``).
               (b) olmoe-1b-7b at full width cut to 8 of its 16 layers (its
               train state reckoned on ``meta`` and printed beside full
               depth's 69.19 GB): two Trainer steps unsharded, then two
               from the same seed on the mesh, each loss within 1e-4
               relative; step walls and peak memory, the mesh run's peak at
               most 1% above the earlier slices', and a warm third step on
               the mesh whose peak the dry run predicts (below). The MoE's
               mesh path keeps each rank's tokens on its data shard (the
               slots counted over the whole batch, the capacity split over
               ``data``); it runs torch ops only: no kernel of the five
               launches in 4j. A 1x1 mesh splits nothing: it proves the
               path and its dispatch cost on the card; the split itself is
               held on gloo ranks (tests/test_torch_moe_mesh.py) and four
               cards (``test_moe_on_four_cards``).
     4k. the slice's path, N writer threads in the rank of a mesh:
               ``Trainer(mesh=make_host_mesh(1, 1), ckpt_writers=4,
               async_ckpt=True)`` on a 1-rank NCCL group (commits over the
               Trainer's gloo group), xlstm-350m at full width and the most
               whole (mLSTM, sLSTM) groups whose 4-writer checkpoint the
               write budget leaves room for (reckoned on ``meta``, printed
               beside full depth's): (a) step 2 saved through 4 writer
               threads over the rank's local blocks, every leaf digested
               with B3 as the save is called, step 3 in place right after
               ``wait_snapshotted()``, then step 3 of the same state; (b) a
               fresh mesh Trainer with 4 writers resumes step 2, every
               local block's digest equal, and reruns steps 2 and 3 with
               losses equal to (a)'s to the last bit; (c) a single-writer
               ``CheckpointManager`` restores the same step onto the card,
               the same digests. Save wall, blocking seconds, the
               ``wait_snapshotted()`` wait, each writer's wall and bytes,
               aggregate GB/s, restore walls and read stalls are printed.
     4l. the slice's path, the xLSTM blocks split over ``model``:
               xlstm-350m at full width and depth (24 layers, bf16, weights
               of seed 0; nothing written), unsharded and then on a 1-rank
               NCCL group and ``make_host_mesh(1, 1)``, where the mLSTM core
               (``layers._mlstm_block``) and the sLSTM gates and recurrence
               (``layers._slstm_local``) run on each rank's share of the
               heads (value columns) and channels: (a) one prefill of 8 x
               255 seeded tokens, the greedy tokens equal to the unsharded
               run's; (b) 4e's requests prefilled and decoded by
               ``generate`` through ``serve_cache_layouts`` caches, the
               greedy tokens equal to the unsharded run's; (c) two
               ``Trainer`` steps unsharded and two on the mesh from the
               same seed, each loss within 1e-5 relative, and a warm third
               step on the mesh whose peak the dry run predicts (below).
               Prefill ms, decode ms per step and step walls beside the
               unsharded ones. A 1x1 mesh splits nothing (its collectives
               are skipped); the split is held on gloo ranks
               (tests/test_torch_xlstm_mesh.py) and four cards
               (``test_mesh_xlstm_on_four_cards``). No kernel of the five
               launches in 4l.
     4m. the slice's path, the train step's loss split over ``model``:
               qwen2.5-3b at full width and vocab cut to 2 of 36 layers
               (bf16, weights of seed 0; nothing written): (a) three steps
               of ``make_train_step(microbatches=2)`` on one seeded batch
               of 4 x 4096 tokens, unsharded and on a 1-rank NCCL group and
               ``make_host_mesh(1, 1)``, where each microbatch keeps the
               batch's layout and each loss chunk's logits the table's
               (``train.steps.token_nll``: a one-rank vocab group here);
               every loss equal to the unsharded one to the last bit, and
               the warm third step's peak on the mesh against the dry
               run's "4m" cell (below); (b) ``token_nll`` held against the
               plain ``cross_entropy`` on one chunk's (2, 512, 151936)
               float32 logits (the mean within 1e-6 relative, the logits'
               grad within 1e-6 of its largest value), its forward +
               backward ms beside the composition's, and a microbatch's
               whole loss (unembed included) beside the loss before the
               split. The split itself is held on gloo ranks
               (tests/test_torch_ce_mesh.py) and four cards
               (``test_mesh_cross_entropy_on_four_cards``). No kernel of
               the five launches in 4m.
  dry run vs card — ``launch.dryrun.measure_cell`` on a 1x1 fake mesh for
               4h (a)'s, 4j (b)'s and 4l's train steps (their configs
               and depths, 8 x 255 tokens, one microbatch) and 4m's (4 x
               4096 tokens, 2 microbatches; a process of its
               own on ``meta``, started after phase 1): each predicted
               ``peak_hbm_bytes`` against the step's own peak on the card
               (``max_memory_allocated()`` of the warm step, less what was
               allocated beside its arguments) within 10%. The same
               process, with three more, runs the production MoE cells on
               the 16x16 mesh (``PRODUCTION_MOE``: olmoe-1b-7b and
               moonshot-v1-16b-a3b at ``prefill_32k`` and ``train_4k``)
               and the GQA cells whose KV heads do not split 16 ways
               (``PRODUCTION_GQA``: qwen3-32b ``prefill_32k`` and
               ``decode_32k``, gemma2-9b ``prefill_32k``, qwen2.5-3b
               ``train_4k``; attention and the lookup split over
               ``model``) and xlstm-350m ``prefill_32k``
               (``PRODUCTION_XLSTM``: the xLSTM blocks split over
               ``model``), and the run prints each one's peak, FLOPs and
               collective bytes by kind, the GQA and xLSTM cells beside
               the parent's; a ``prefill_32k`` peak above an 80 GB card, an
               all-gather of a whole (V, d) embedding table, a decode step
               that all-gathers 64 MB or more, a ``train_4k`` cell that
               all-gathers a loss chunk's whole-vocab logits, a qwen2.5-3b
               ``train_4k`` peak of 2 GB or more (13.62 GB before the loss
               split over ``model``; the MoE ``train_4k`` cells printed
               beside their numbers before it), or an xLSTM cell over 5e12
               FLOPs or a 2 GB peak a device, or that all-gathers a whole
               sLSTM gate weight or v, q or k with every head, fails the
               run.
  5. chaos — the port's seeded chaos campaign with restores on the card, for
               the JAX package's gate seeds (0, 42): zero invariant
               violations, >= 200 faults fired, every required kind class.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON (launches summed over phases 3, 4, 4e, 4f, 4h (a), 4i
and 4k, each counted from zero), and the one before that the nvidia-smi
line. The run needs one card, the repository's ``src/`` and ``examples/``
beside this file, and room for one ~13 GB checkpoint under ``build/``.
"""

from __future__ import annotations

import argparse
import atexit
import functools
import json
import math
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
SERVE_RGLRU = (8, 64, 2560)        # the same of 4e's prefill (SERVE_SHAPE)
# The chip machine takes at most 45 GiB of disk writes per call, deleted
# files included. Phase 4 writes one recurrentgemma-2b checkpoint at the
# first 7 blocks of its 13-block pattern (every width kept: 12.61 GB; the
# full depth's 28.94 GB, 13 layers' 17.75 GB and 10 layers' 15.18 GB left
# no room for phase 4f's failover, which writes xlstm-350m's 4.29 GB three
# times: level 0, level 1 and the promote after node loss, and 4k's
# 4-writer checkpoint), and phase 3 runs qwen2.5-3b at a cut
# depth: every width kept, 1 of its 36 stacked layers (~1.57 GB per save
# with quantized moments; nine such saves, flushes, uploads and promotes, a
# 512 MiB probe, and (D)'s 4-writer save of ~2.49 GB: the stacked block
# leaves, leading dim 1, are replicated on every writer rank).
TRAIN_LAYERS = 7
XLSTM_ARCH = "xlstm-350m"          # phase 4f: the CLI's default, no cut
XLSTM_KERNELS = ("fingerprint_chunks",)   # 4f: the digests of its leaves
FAILOVER_CKPT_EVERY = 2            # 4f (i): step 2 saved, step 4's torn
TORN_ALLOWANCE = 256 << 20         # 4f (i): the torn save's writes before
                                   # the kill (a 5 ms watch; ~1 GB/s disk)
MOE_ARCH = "olmoe-1b-7b"           # phase 4g: served, never checkpointed
MOE_GATED_CAPACITY = 8.0           # no drops: prefill and decode route
#                                    alike (tests/test_models.py)
MOE_TRAIN_LAYERS = 8               # 4j (b): 35.6 of full depth's 69.2 GB of
#                                    params and moments, grads beside them
DRYRUN_TOL = 0.10                  # dry-run peak against the card's step
# 4j's numbers before the MoE's mesh path kept tokens on their data shard
# (PERF.md: (a) the three card runs before it; (b) every card run before it)
MOE_MESH_BEFORE = {"4j (a)": dict(prefill_ms=(174.59, 218.46),
                                  decode_median_ms=(110.08, 120.42),
                                  peak_device_bytes=14_264_452_608),
                   "4j (b)": dict(peak_device_bytes=44_767_974_912)}
# 4i's and 4j (a)'s serving on the 1x1 mesh before attention and the
# lookup split over `model` (PERF.md: the three card runs before; ms)
MESH_SERVE_BEFORE = {
    "4i (a)": dict(prefill_ms=(297.70, 457.88),
                   decode_median_ms=(32.30, 52.05)),
    "4i (b)": dict(prefill_ms=(483.67, 767.14),
                   decode_median_ms=(162.12, 278.92)),
    "4j (a)": dict(prefill_ms=(282.41, 350.15),
                   decode_median_ms=(204.90, 222.25))}
MOE_PEAK_SLACK = 0.01              # 4j (b)'s mesh peak over the earlier one
# the dry run's production MoE cells on 16x16, longest first
PRODUCTION_MOE = (("moonshot-v1-16b-a3b", "train_4k"),
                  ("olmoe-1b-7b", "train_4k"),
                  ("moonshot-v1-16b-a3b", "prefill_32k"),
                  ("olmoe-1b-7b", "prefill_32k"))
# their train_4k numbers a device before the loss split over `model`
# (PERF.md): peak bytes, FLOPs, collective bytes by kind
PRODUCTION_MOE_BEFORE = {
    "moonshot-v1-16b-a3b train_4k": (16_199_075_892, 1.66369853177856e14,
                                     dict(all_gather=453_292_064_768,
                                          all_reduce=215_026_041_048,
                                          reduce_scatter=12_516_655_104)),
    "olmoe-1b-7b train_4k": (4_967_403_572, 5.4208929726464e13, dict(
        all_gather=175_311_421_440, all_reduce=77_947_289_824,
        reduce_scatter=5_505_630_208))}
# the dry run's GQA cells on 16x16 whose KV heads do not split 16 ways,
# longest first, and their numbers a device before the change that last
# moved them (PERF.md): qwen2.5-3b train_4k's before the loss split over
# `model`, the others' before attention split over it; peak bytes, FLOPs,
# collective bytes by kind
PRODUCTION_GQA = (("qwen2.5-3b", "train_4k"), ("qwen3-32b", "prefill_32k"),
                  ("gemma2-9b", "prefill_32k"), ("qwen3-32b", "decode_32k"))
PRODUCTION_GQA_BEFORE = {
    "qwen2.5-3b train_4k": (13.62e9, 1.117e14, dict(
        all_gather=65.81e9, all_reduce=64.96e9, reduce_scatter=0.6586e9)),
    "qwen3-32b prefill_32k": (41.19e9, 5.113e15, dict(
        all_gather=303.56e9, all_reduce=42.95e9, reduce_scatter=32.21e9)),
    "gemma2-9b prefill_32k": (20.15e9, 2.076e15, dict(
        all_gather=267.14e9, all_reduce=39.46e9, reduce_scatter=22.20e9)),
    "qwen3-32b decode_32k": (8.06e9, 5.12e10, dict(all_gather=1.567e9))}
DECODE_GATHER_LIMIT = 64e6         # a decode step's all-gather bytes a device
# the dry run's xLSTM cell on 16x16 and its numbers a device before the
# xLSTM blocks split over `model` (PERF.md): peak bytes, FLOPs, collective
# bytes by kind; its gates after the split
PRODUCTION_XLSTM = (("xlstm-350m", "prefill_32k"),)
PRODUCTION_XLSTM_BEFORE = {
    "xlstm-350m prefill_32k": (5_994_148_244, 2.0414529e13, dict(
        all_gather=704_643_072, all_reduce=16_265_510_912))}
XLSTM_FLOPS_LIMIT = 5.0e12
XLSTM_PEAK_LIMIT = 2.0e9
CE_ARCH = "qwen2.5-3b"             # phase 4m: full width and vocab
CE_LAYERS = 2                      # 4m: of its 36 layers
CE_SHAPE = (4, 4096)               # 4m: a step's rows and tokens
CE_MICROBATCHES = 2
CE_TOL = 1e-6                      # 4m: token_nll against cross_entropy
# the dry run's qwen2.5-3b train_4k on 16x16 with the loss split over
# `model`: its peak a device (before the split: 13.62 GB)
CE_PEAK_LIMIT = 2.0e9
CARD_BYTES = 80e9                  # an H100's device memory
CHECKPOINT_LAYERS = 1
PROBE_BYTES = 512 << 20
WRITE_LIMIT = 44 << 30             # the run's own budget under the 45 GiB
WRITERS = 4                        # (D)'s writer ranks
QUANT_PREFIXES = ("opt/mu", "opt/nu")
ENGINE_ORDER = ("aggregated", "datastates", "snapshot", "torchsave")


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
    their plain loops, bit for bit, at the training path's shape, at the
    serving prefill's, at edge shapes, on misaligned views (the 4-byte copy path) and with the 0.999^t
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
    # the serving prefill's shape (S a whole number of ring stages)
    a, b, dh = inputs(SERVE_RGLRU)
    if rk.copy_variant(a, b) != "bulk":
        fail(f"rglru_scan at {SERVE_RGLRU} would take the "
             f"{rk.copy_variant(a, b)} copy path")
    serve_err = check(f"{SERVE_RGLRU}", a, b, dh)[1]
    results["rglru_scan"].update(
        serve_max_abs_err=serve_err,
        max_abs_err=max(results["rglru_scan"]["max_abs_err"], serve_err))
    del a, b, dh
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


def writer_spans(shape, writers: int) -> list[tuple[int, int]]:
    """Flat (start, stop) value spans each writer rank quantized: its rows
    of a leaf split by ``partition_spans`` (the whole leaf when short)."""
    from repro_torch.core.aggregation import partition_spans
    n = 1
    for d in shape:
        n *= d
    if writers == 1 or not shape or shape[0] < writers:
        return [(0, n)]
    row = n // shape[0]
    return [(lo * row, hi * row)
            for lo, hi in partition_spans(shape[0], writers)]


def check_restored(restored: dict, state: dict, quantized: set,
                   writers: int = 1) -> None:
    """Unquantized leaves bit-exact; quantized ones equal to the plain
    dequantize(quantize(x)) of the saved values, computed on the card (per
    writer rank's rows when ``writers`` ranks saved the state)."""
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
        for lo, hi in writer_spans(tuple(w.shape), writers):
            for a in range(lo, hi, step):
                b = min(a + step, hi)
                part = src[a:b]
                rows = -(-part.numel() // LANE_COLS)
                qv, sv = quantize_blocks_plain(part, rows)
                ref = dequantize_blocks_plain(qv, sv, w.dtype,
                                              n=part.numel())
                if not torch.equal(bits(out[a:b]), bits(ref)):
                    fail(f"{key}: restored values differ from the plain "
                         f"dequantize(quantize(x)) at [{a}, {b})")


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


def storage_probe(root: str, nbytes: int) -> dict:
    """The storage rate the main path runs against: one ``nbytes`` host
    buffer written and read back through the same engine and settings
    (aggregated, O_DIRECT where the filesystem takes it), with no device
    work at all."""
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
    log(f"storage probe ({nbytes} B, {eng.config.backend}): write "
        f"{out['write_gbps']:.3f} GB/s, read {out['read_gbps']:.3f} GB/s")
    return out


def odirect_probe(root: str) -> dict:
    """Whether this filesystem takes O_DIRECT: one open with the flag and
    one aligned 4 KiB write through it (``io_engine.open_for`` falls back
    to buffered I/O silently when the open fails)."""
    import mmap
    path = os.path.join(root, "odirect_probe")
    out = dict(open=False, write=False, error="")
    try:
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC | os.O_DIRECT,
                     0o644)
    except OSError as e:
        out["error"] = f"open: {e}"
    else:
        out["open"] = True
        buf = mmap.mmap(-1, 4096)            # page-aligned
        try:
            out["write"] = os.pwrite(fd, buf, 0) == 4096
        except OSError as e:
            out["error"] = f"write: {e}"
        finally:
            os.close(fd)
            buf.close()
    if os.path.exists(path):
        os.remove(path)
    log(f"O_DIRECT probe in {root}: open {'yes' if out['open'] else 'no'}, "
        f"aligned write {'yes' if out['write'] else 'no'}"
        + (f" ({out['error']})" if out["error"] else ""))
    return out


def du(path: str) -> int:
    """Bytes of every file under ``path`` (0 when it does not exist)."""
    total = 0
    for d, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(d, f))
    return total


class WriteTally:
    """Bytes this run wrote to the machine's disk, by what wrote them: the
    chip machine takes at most 45 GiB of writes per call, deleted files
    included, and kills the call past it."""

    def __init__(self):
        self.parts: dict[str, int] = {}

    def add(self, what: str, nbytes: int) -> None:
        self.parts[what] = self.parts.get(what, 0) + int(nbytes)

    @property
    def total(self) -> int:
        return sum(self.parts.values())

    def check(self, label: str) -> None:
        log(f"write tally {label}: {self.total} B "
            f"({self.total / 2**30:.2f} GiB, limit "
            f"{WRITE_LIMIT / 2**30:.1f} GiB)")
        if self.total >= WRITE_LIMIT:
            fail(f"wrote {self.total} B, over the {WRITE_LIMIT} B budget")


def cold_reads(path: str) -> str:
    """Make the next read of ``path`` cold: drop the page cache where this
    process may (root), else evict each file of ``path`` with
    POSIX_FADV_DONTNEED after a sync. Returns which of the two ran."""
    os.sync()
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3")
        return "drop_caches"
    except OSError:
        pass
    for d, _dirs, files in os.walk(path):
        for name in files:
            fd = os.open(os.path.join(d, name), os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
    return "fadvise"


def save_estimate(tensors: dict, quant: set) -> int:
    """Bytes one save of ``tensors`` writes: packed quantized payloads for
    ``quant``, raw bytes for the rest (alignment and manifests aside)."""
    from repro_torch.core import quant_codec
    return sum(quant_codec.packed_nbytes(t.numel()) if k in quant
               else t.numel() * t.element_size() for k, t in tensors.items())


def multi_writer_estimate(tensors: dict, quant: set, writers: int) -> int:
    """Bytes one ``writers``-rank save of ``tensors`` writes: each rank's
    rows of the leaves whose leading dim holds ``writers`` spans (quantized
    per rank), and a full copy per rank of the rest — the 1-layer state's
    stacked block leaves (leading dim 1) are replicated, as the reference's
    row partition replicates them."""
    from repro_torch.core import quant_codec
    from repro_torch.core.aggregation import partition_spans
    total = 0
    for k, t in tensors.items():
        if t.ndim == 0:
            continue                       # host scalars: the lean object
        row = t.numel() // t.shape[0] if t.shape[0] else 0
        spans = (partition_spans(t.shape[0], writers)
                 if t.shape[0] >= writers else [(0, t.shape[0])] * writers)
        for lo, hi in spans:
            n = (hi - lo) * row
            total += (quant_codec.packed_nbytes(n) if k in quant
                      else n * t.element_size())
    return total


def planned_writes(save_bytes: int, probe_bytes: int,
                   train_bytes: int, multi_bytes: int,
                   zoo_bytes: int, xlstm_bytes: int) -> dict:
    """What the run will write: the probe; (A) a save, its level-1 flush
    and the promote on restore; (B) step 1 and its upload (the delta steps
    are a few MB); (C) one save per engine; (D) one 4-writer save
    (``multi_bytes``); phase 4's one checkpoint; 4e's zoo example
    (``zoo_bytes``); 4f's failover: xlstm-350m's step 2 at level 0, its
    level-1 flush and its promote after node loss, and what the torn save
    of step 4 may write before the kill (``TORN_ALLOWANCE``); and 1 GiB for
    the delta steps, manifests, 4c's and 4d's narrow saves, the chaos
    campaign and alignment. 4k's checkpoint is added by
    ``mesh_writers_depth``, which sizes it to what is left."""
    return {"probe": probe_bytes, "(A)": 3 * save_bytes,
            "(B)": 2 * save_bytes, "(C)": len(ENGINE_ORDER) * save_bytes,
            "(D)": multi_bytes, "phase 4": train_bytes, "4e zoo": zoo_bytes,
            "4f failover": 3 * xlstm_bytes, "4f torn step": TORN_ALLOWANCE,
            "margin": 1 << 30}


def mesh_writers_config(groups: int):
    """4k's model: xlstm-350m at full width, ``groups`` whole (mLSTM,
    sLSTM) groups of its 12."""
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM_ARCH)
    return cfg.replace(num_layers=groups * len(cfg.block_pattern))


def mesh_writers_depth(planned: int) -> tuple[int, int]:
    """(groups, bytes) of 4k: the most whole groups of xlstm-350m whose
    ``WRITERS``-writer checkpoint (reckoned on ``meta``) fits the write
    budget beside the rest of the plan (``planned`` bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.train.steps import init_train_state
    for groups in range(get_config(XLSTM_ARCH).num_groups, 0, -1):
        need = multi_writer_estimate(flat_leaves(init_train_state(
            mesh_writers_config(groups), device="meta")), set(), WRITERS)
        if planned + need < WRITE_LIMIT:
            return groups, need
    fail("no depth of xlstm-350m fits 4k's checkpoint in the write budget")


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


def timed_restore(mgr, state: dict, step: int) -> tuple:
    """(restored state, wall seconds) of a restore onto ``state``'s
    devices, synchronised on both sides."""
    device = next(iter(flat_leaves(state).values())).device
    sync(device)
    t0 = time.perf_counter()
    restored = mgr.restore(state, step=step)
    sync(device)
    return restored, time.perf_counter() - t0


def restore_row(rm, wall: float, total: int) -> dict:
    return dict(wall_s=wall, gbps_state=total / wall / 1e9,
                read_s=rm.read_seconds, read_stall_s=rm.read_stall_seconds,
                decode_s=rm.decode_seconds, assemble_s=rm.assemble_seconds,
                prefetch_s=rm.prefetch_seconds)


def release(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()


def level1_node_loss(state: dict, root: str, quant: set, tally: WriteTally,
                     ) -> dict:
    """(A) An async quantized save at level 0 (the embedding mutated in
    place right after ``wait_snapshotted()``), its level-1 flush, node loss
    (level 0 deleted), and a restore onto the card through
    ``RestorePrefetcher`` that promotes the step back to level 0."""
    from repro_torch.core import MultiLevelCheckpointer
    tensors = flat_leaves(state)
    device = next(iter(tensors.values())).device
    total = state_bytes(tensors)
    level0, level1 = os.path.join(root, "A0"), os.path.join(root, "A1")
    kw = dict(quantize_prefixes=QUANT_PREFIXES, device=device, keep=None)
    emb = tensors["params/embed"]
    saved_emb = emb.clone()
    out: dict = {}
    with MultiLevelCheckpointer(level0, level1, async_save=True, **kw) as ml:
        t0 = time.perf_counter()
        m = ml.save(1, state)
        ml.wait_snapshotted()
        snap = time.perf_counter() - t0
        emb.add_(1.0)
        ml.local.wait()
        wall = time.perf_counter() - t0
        tally.add("(A) level-0 save", du(level0))
        log(f"(A) async save at level 0: blocking {m.blocking_seconds:.3f} s"
            f", snapshotted {snap:.3f} s, wall {wall:.3f} s, written "
            f"{m.written_bytes} B, {total / wall / 1e9:.3f} GB/s of state, "
            f"staging copy {m.d2h_seconds:.3f} s, flush "
            f"{m.flush_seconds:.3f} s, commit {m.commit_seconds:.3f} s")
        out["save"] = dict(blocking_s=m.blocking_seconds, snapshotted_s=snap,
                           wall_s=wall, total_bytes=m.total_bytes,
                           written_bytes=m.written_bytes,
                           staging_copy_s=m.d2h_seconds,
                           gbps_state=total / wall / 1e9,
                           gbps_written=m.written_bytes / wall / 1e9,
                           stall=stall("save"))
        t0 = time.perf_counter()
        ml.wait()                           # the level-1 flush
        wait_s = time.perf_counter() - t0
        fs = ml.last_flush_stats
        tally.add("(A) level-1 flush", du(level1))
        log(f"(A) level-1 flush: {fs.files} files, {fs.bytes} B in "
            f"{fs.seconds:.3f} s ({fs.gbps:.3f} GB/s; read "
            f"{fs.read_gbps:.3f}, write {fs.write_gbps:.3f} GB/s), "
            f"{fs.extents} extents, {fs.hedged} hedged ({fs.hedge_wins} "
            f"won), backend {fs.backend}; wait() {wait_s:.3f} s")
        out["flush"] = dict(files=fs.files, bytes=fs.bytes,
                            seconds=fs.seconds, gbps=fs.gbps,
                            read_gbps=fs.read_gbps, write_gbps=fs.write_gbps,
                            extents=fs.extents, hedged=fs.hedged,
                            hedge_wins=fs.hedge_wins, backend=fs.backend,
                            wait_s=wait_s)
    emb.copy_(saved_emb)                 # the values the save snapshotted
    del saved_emb
    shutil.rmtree(level0)                # node loss
    os.makedirs(level0)
    with MultiLevelCheckpointer(level0, level1, **kw) as ml:
        restored, wall = timed_restore(ml, state, 1)
        rm = ml.last_restore_metrics
        promoted = ml.local.all_steps()
        if promoted != [1]:
            fail(f"(A) the prefetched step was not promoted to level 0: "
                 f"level 0 holds {promoted}")
        tally.add("(A) promote to level 0", du(level0))
        log(f"(A) node-loss restore onto {device}: wall {wall:.3f} s "
            f"({total / wall / 1e9:.3f} GB/s of state), prefetch "
            f"{rm.prefetch_seconds:.3f} s, read {rm.read_seconds:.3f} s, "
            f"decode {rm.decode_seconds:.3f} s, assemble "
            f"{rm.assemble_seconds:.3f} s; step 1 promoted to level 0")
        out["restore"] = dict(restore_row(rm, wall, total),
                              promoted=promoted, stall=stall("restore"))
    check_restored(restored, state, quant)
    del restored
    release(device)
    shutil.rmtree(level0, ignore_errors=True)
    shutil.rmtree(level1, ignore_errors=True)
    log("(A) restored state checked")
    return out


def object_store_delta(state: dict, root: str, quant: set,
                       tally: WriteTally) -> dict:
    """(B) A delta chain through the object-store tier: step 1 (every
    chunk) uploaded, a contiguous 1% change of four tensors, step 2 (dirty
    chunks only) uploaded by dedup, node loss, and a stream restore of
    step 2 from the store straight onto the card."""
    from repro_torch.core import RemoteCheckpointer, SimObjectStore
    from repro_torch.core.manifest import MANIFEST_NAME
    from repro_torch.core.serialization import extract_tensors, serialize_lean
    leaves = flat_leaves(state)
    device = next(iter(leaves.values())).device
    total = state_bytes(leaves)
    level0, bucket = os.path.join(root, "B0"), os.path.join(root, "bucket")
    kw = dict(quantize_prefixes=QUANT_PREFIXES, device=device, keep=None)
    changed = {}
    for key in ("params/embed", "opt/mu/embed",
                "opt/nu/blocks/b0_attn/mlp/wd", "params/blocks/b0_attn/wq"):
        n = leaves[key].numel()
        a = n // 3
        changed[key] = (a, a + n // 100)          # a contiguous 1% slice
    out: dict = {}
    store = SimObjectStore(bucket)
    with RemoteCheckpointer(level0, store, delta=True, **kw) as rc:
        t0 = time.perf_counter()
        m1 = rc.save(1, state)
        wall1 = time.perf_counter() - t0
        if m1.chunks_dirty != m1.chunks_total:
            fail("delta step 1 must write every chunk")
        tally.add("(B) level-0 saves", du(level0))
        rc.wait()
        up1 = rc.last_upload_stats
        tally.add("(B) uploads", du(bucket))
        log(f"(B) delta step 1: blocking {m1.blocking_seconds:.3f} s, wall "
            f"{wall1:.3f} s, written {m1.written_bytes} B, d2h "
            f"{m1.d2h_bytes} B, chunks {m1.chunks_dirty}/{m1.chunks_total}, "
            f"fingerprint {m1.fingerprint_seconds:.3f} s; upload "
            f"{up1.objects} objects, {up1.bytes} B in {up1.seconds:.3f} s "
            f"({up1.bytes / up1.seconds / 1e9:.3f} GB/s)")
        out["save1"] = dict(blocking_s=m1.blocking_seconds, wall_s=wall1,
                            written_bytes=m1.written_bytes,
                            d2h_bytes=m1.d2h_bytes, chunks=m1.chunks_total,
                            fingerprint_s=m1.fingerprint_seconds,
                            diff_s=m1.diff_seconds, stall=stall("save"))
        out["upload1"] = dict(objects=up1.objects, bytes=up1.bytes,
                              seconds=up1.seconds,
                              chunks_shipped=up1.chunks_shipped)
        for key, (a, b) in changed.items():
            leaves[key].view(-1)[a:b] += 1.0 if key.startswith("params") \
                else 1e-3
        sync(device)
        before0, before_b = du(level0), du(bucket)
        t0 = time.perf_counter()
        m2 = rc.save(2, state)
        wall2 = time.perf_counter() - t0
        tally.add("(B) level-0 saves", du(level0) - before0)
        rc.wait()
        up2 = rc.last_upload_stats
        tally.add("(B) uploads", du(bucket) - before_b)
        _, lean = extract_tensors(state)
        bound, bound_chunks = dirty_bound(state, changed, quant,
                                          len(serialize_lean(lean)))
        manifest = os.path.getsize(os.path.join(
            level0, "step_00000002", MANIFEST_NAME))
        log(f"(B) delta step 2: blocking {m2.blocking_seconds:.3f} s, wall "
            f"{wall2:.3f} s, written {m2.written_bytes} B (bound {bound}), "
            f"d2h {m2.d2h_bytes} B, chunks {m2.chunks_dirty}/"
            f"{m2.chunks_total} (bound {bound_chunks}), fingerprint "
            f"{m2.fingerprint_seconds:.3f} s; upload {up2.objects} objects, "
            f"{up2.bytes} B (bound {bound + manifest}: dirty chunks, lean "
            f"blob, manifest) in {up2.seconds:.3f} s, {up2.chunks_shipped} "
            f"packs shipped, {up2.chunks_skipped} skipped "
            f"({up2.bytes_skipped} B kept off the wire)")
        out["save2"] = dict(blocking_s=m2.blocking_seconds, wall_s=wall2,
                            written_bytes=m2.written_bytes,
                            d2h_bytes=m2.d2h_bytes,
                            chunks_dirty=m2.chunks_dirty,
                            chunks_total=m2.chunks_total,
                            written_bound=bound,
                            fingerprint_s=m2.fingerprint_seconds,
                            diff_s=m2.diff_seconds, stall=stall("save"))
        out["upload2"] = dict(objects=up2.objects, bytes=up2.bytes,
                              bound=bound + manifest, seconds=up2.seconds,
                              chunks_shipped=up2.chunks_shipped,
                              chunks_skipped=up2.chunks_skipped,
                              bytes_skipped=up2.bytes_skipped)
        if not 0 < m2.chunks_dirty <= bound_chunks:
            fail(f"step 2 dirtied {m2.chunks_dirty} chunks, bound "
                 f"{bound_chunks}")
        if m2.written_bytes > bound:
            fail(f"step 2 wrote {m2.written_bytes} B, bound {bound}")
        if up2.bytes > bound + manifest:
            fail(f"step 2 uploaded {up2.bytes} B, bound {bound + manifest}")
        if rc.tier.committed_steps() != [1, 2]:
            fail(f"the store committed {rc.tier.committed_steps()}")
    shutil.rmtree(level0)                # node loss
    os.makedirs(level0)
    with RemoteCheckpointer(level0, SimObjectStore(bucket),
                            restore_mode="stream", **kw) as rc:
        restored, wall = timed_restore(rc, state, 2)
        rm = rc.last_restore_metrics
        rs = rc._remote_mgr().engine.last_range_stats
        left = [os.path.relpath(os.path.join(d, f), level0)
                for d, _dirs, fs in os.walk(level0) for f in fs]
        if left or rc.local.all_steps():
            fail(f"(B) the stream restore left files at level 0: {left[:4]}")
        tally.add("(B) stream-restore manifest", rc.store.head(
            f"{rc.tier.step_key(2)}/{MANIFEST_NAME}").size)
        p50, p99 = rs.range_percentile(0.5), rs.range_percentile(0.99)
        log(f"(B) stream restore of step 2 onto {device} (nothing staged at "
            f"level 0): wall {wall:.3f} s ({total / wall / 1e9:.3f} GB/s of "
            f"state), read stall {rm.read_stall_seconds:.3f} s, decode "
            f"{rm.decode_seconds:.3f} s, assemble {rm.assemble_seconds:.3f} "
            f"s; ranges {rs.ranges}, {rs.bytes} B at {rs.gbps:.3f} GB/s, "
            f"range p50 {p50 * 1e3:.2f} ms, p99 {p99 * 1e3:.2f} ms, "
            f"{rs.hedged} hedged ({rs.hedge_wins} won), {rs.retries} "
            f"retries")
        out["stream_restore"] = dict(
            restore_row(rm, wall, total), ranges=rs.ranges,
            range_bytes=rs.bytes, range_gbps=rs.gbps, range_p50_s=p50,
            range_p99_s=p99, hedged=rs.hedged, hedge_wins=rs.hedge_wins,
            retries=rs.retries, stall=stall("restore"))
    check_restored(restored, state, quant)
    del restored
    release(device)
    shutil.rmtree(level0, ignore_errors=True)
    shutil.rmtree(bucket, ignore_errors=True)
    log("(B) restored state checked")
    return out


def engine_comparison(state: dict, root: str, quant: set,
                      tally: WriteTally) -> dict:
    """(C) The paper's engine comparison: the same state saved (async,
    quantized moments) and restored through each engine with its own
    defaults; reads made cold before each restore."""
    from repro_torch.core import CheckpointManager
    from repro_torch.core.io_engine import resolve_backend
    tensors = flat_leaves(state)
    device = next(iter(tensors.values())).device
    total = state_bytes(tensors)
    rows: dict = {}
    for engine in ENGINE_ORDER:
        path = os.path.join(root, f"C_{engine}")
        with CheckpointManager(path, engine=engine, async_save=True,
                               quantize_prefixes=QUANT_PREFIXES,
                               device=device, keep=None) as mgr:
            t0 = time.perf_counter()
            m = mgr.save(1, state)
            blocking = time.perf_counter() - t0
            mgr.wait_snapshotted()
            snap = time.perf_counter() - t0
            mgr.wait()
            wall = time.perf_counter() - t0
            st = mgr.engine.last_save_stats
            cfg = mgr.engine.config
            written = du(path)
            tally.add("(C) engine saves", written)
            cold = cold_reads(path)
            restored, rwall = timed_restore(mgr, state, 1)
            rm = mgr.last_restore_metrics
            rst = mgr.engine.last_restore_stats
        row = dict(engine=engine, blocking_s=blocking,
                   reported_blocking_s=m.blocking_seconds,
                   snapshotted_s=snap, wall_s=wall,
                   written_bytes=m.written_bytes, on_disk_bytes=written,
                   write_gbps=m.written_bytes / wall / 1e9,
                   files=st.files, io_requests=st.io_requests,
                   alloc_s=st.alloc_seconds, copy_s=st.copy_seconds,
                   backend=resolve_backend(cfg.backend), direct=cfg.direct,
                   cold=cold, restore_wall_s=rwall,
                   read_gbps=m.written_bytes / rwall / 1e9,
                   read_stall_s=rm.read_stall_seconds,
                   read_files=rst.files, read_io_requests=rst.io_requests,
                   read_alloc_s=rst.alloc_seconds)
        log(f"(C) {engine}: blocking {blocking:.3f} s (SaveMetrics "
            f"{m.blocking_seconds:.3f}), snapshotted {snap:.3f} s, save wall "
            f"{wall:.3f} s, written {m.written_bytes} B at "
            f"{row['write_gbps']:.3f} GB/s; files {st.files}, io_requests "
            f"{st.io_requests}, alloc {st.alloc_seconds:.3f} s, copy "
            f"{st.copy_seconds:.3f} s; backend {row['backend']}, direct "
            f"{cfg.direct}; restore ({cold}) wall {rwall:.3f} s at "
            f"{row['read_gbps']:.3f} GB/s, read stall "
            f"{rm.read_stall_seconds:.3f} s, read files {rst.files}, "
            f"requests {rst.io_requests}, alloc {rst.alloc_seconds:.3f} s")
        rows[engine] = row
        check_restored(restored, state, quant)
        del restored
        release(device)
        shutil.rmtree(path, ignore_errors=True)
    agg = rows["aggregated"]
    ratios = {e: dict(write=agg["write_gbps"] / r["write_gbps"],
                      read=agg["read_gbps"] / r["read_gbps"])
              for e, r in rows.items() if e != "aggregated"}
    log("(C) aggregated over each baseline (this run; the paper's 3.9x over "
        "DataStates-LLM and 7.6x over TorchSnapshot are its own machine's "
        "write rates): " + ", ".join(
            f"{e} write {r['write']:.2f}x read {r['read']:.2f}x"
            for e, r in ratios.items()))
    log("(C) every engine's restored state checked")
    return dict(rows=rows, ratios=ratios)


def stall_by_rank(root: str, since: float) -> list[dict]:
    """Attribution of the last ``root`` span of each thread that ran one
    after ``since`` (``trace.clock()``; one per writer rank) — printed, and
    returned in thread order."""
    from repro_torch.core import trace
    evs = [e for e in trace.drain() if e.t0 >= since]
    tids = []
    for e in evs:
        if e.kind == "span" and e.name == root and e.tid not in tids:
            tids.append(e.tid)
    if not tids:
        fail(f"no {root} span was traced")
    out = []
    for n, tid in enumerate(tids):
        rep = trace.stall_report([e for e in evs if e.tid == tid], root=root)
        parts = {k: v for k, v in sorted(rep.attribution.items(),
                                         key=lambda kv: -kv[1]) if v}
        log(f"  rank thread {n}: {root} wall {rep.wall:.3f} s by category: "
            + ", ".join(f"{k} {v:.3f} s ({100 * v / rep.wall:.1f}%)"
                        for k, v in parts.items()))
        out.append(dict(wall_s=rep.wall, **parts))
    return out


def reader_windows(readers: list, state: dict) -> dict:
    """The M readers' windows of ``restore_sharded`` put back together into
    one state like ``state`` (each window checked to be the reader's row
    span), for ``check_restored``."""
    import numpy as np
    import torch
    from repro_torch.core import LocalShard
    from repro_torch.core.aggregation import partition_spans
    want = flat_leaves(state)
    m = len(readers)
    out = {}
    for key, w in want.items():
        if w.ndim == 0:                   # a host scalar of the lean object
            out[key] = torch.tensor(np.array(flat_leaves(readers[0])[key]),
                                    device=w.device)
            continue
        leaves = [flat_leaves(r)[key] for r in readers]
        if w.shape[0] < m:
            out[key] = leaves[0]
            continue
        full = torch.empty_like(w)
        for r, (leaf, span) in enumerate(zip(
                leaves, partition_spans(w.shape[0], m))):
            if not isinstance(leaf, LocalShard) or \
                    tuple(leaf.index[0]) != span:
                fail(f"(D) reader {r} of {key}: window "
                     f"{getattr(leaf, 'index', None)}, expected rows {span}")
            if leaf.data.device != w.device:
                fail(f"(D) reader {r} of {key} is on {leaf.data.device}")
            full[span[0]:span[1]] = leaf.data
        out[key] = full
    return reader_tree(out)


def dtensor_restore(mw, state: dict, quant: set, root: str) -> dict:
    """Restore through ``mw``'s first manager into DTensor templates on a
    1-rank NCCL group's ``DeviceMesh("cuda", (1,))``: ``Shard(0)`` on the
    2-D leaves, ``Replicate`` on the others; each ``.to_local()`` checked
    against the state."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    device = next(iter(flat_leaves(state).values())).device
    pg = os.path.join(root, "pg")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{pg}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device.type, (1,))

        def template(v):
            if not isinstance(v, torch.Tensor) or v.ndim == 0:
                return v
            place = [Shard(0)] if v.ndim == 2 else [Replicate()]
            return DTensor.from_local(v, mesh, place, run_check=False)

        tmpl = reader_tree({k: template(v)
                            for k, v in flat_leaves(state).items()})
        t0 = time.perf_counter()
        got = mw.restore(tmpl, step=1)
        sync(device)
        wall = time.perf_counter() - t0
        leaves = flat_leaves(got)
        dt = [k for k, v in leaves.items() if isinstance(v, DTensor)]
        sharded = [k for k in dt if leaves[k].placements == (Shard(0),)]
        local = reader_tree({k: v.to_local() if isinstance(v, DTensor)
                             else v for k, v in leaves.items()})
        del got, leaves, tmpl
        check_restored(local, state, quant, writers=mw.num_ranks)
        del local
    finally:
        dist.destroy_process_group()
    log(f"(D) DTensor restore (1-rank {device.type} mesh): {len(dt)} "
        f"DTensor leaves "
        f"({len(sharded)} Shard(0)), wall {wall:.3f} s; every to_local() "
        f"checked")
    return dict(wall_s=wall, dtensors=len(dt), sharded=len(sharded))


def reader_tree(flat: dict) -> dict:
    """Nested dicts from ``flat_leaves``-style keys."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def multi_writer(state: dict, root: str, quant: set, tally: WriteTally
                 ) -> dict:
    """(D) The paper's "many processes" axis on one card: 4 writer ranks
    (threads, each with its own manager and engine) save the CUDA state's
    row views asynchronously into one SINGLE_FILE O_DIRECT checkpoint with
    the default ``EngineConfig``, each quantizing its rows of the moments on
    the card; rank 0 merge-commits. Then a cold restore onto the card
    through rank 0's manager, an elastic 4 → 2 restore, and a restore into
    DTensor templates. B1 and B2 must be launched within (D)."""
    from repro_torch.core import MultiWriterCheckpointer, trace
    from repro_torch.kernels import _lib
    since = trace.clock()        # the rank threads' spans are (D)'s
    tensors = flat_leaves(state)
    device = next(iter(tensors.values())).device
    total = state_bytes(tensors)
    path = os.path.join(root, "D")
    writers = WRITERS
    before = dict(_lib.LAUNCHES)
    out: dict = {"writers": writers}
    with MultiWriterCheckpointer(path, writers, engine="aggregated",
                                 async_save=True, keep=None,
                                 quantize_prefixes=QUANT_PREFIXES,
                                 device=device) as mw:
        cfg = mw.managers[0].config
        t0 = time.perf_counter()
        m = mw.save(1, state)
        blocking = time.perf_counter() - t0
        mw.wait_snapshotted()
        snap = time.perf_counter() - t0
        mw.wait()
        wall = time.perf_counter() - t0
        written = du(path)
        tally.add("(D) multi-writer save", written)
        data = os.path.join(path, "step_00000001", "data")
        files = sorted(os.listdir(data))
        ranks = [dict(rank=r, total_bytes=pm.total_bytes,
                      wall_s=pm.end_to_end_seconds,
                      flush_s=pm.flush_seconds, commit_s=pm.commit_seconds,
                      staging_copy_s=pm.d2h_seconds)
                 for r, pm in enumerate(m.per_rank)]
        log(f"(D) {writers}-writer async save ({cfg.strategy!s}, direct "
            f"{cfg.direct}): blocking {blocking:.3f} s (MultiSaveMetrics "
            f"{m.blocking_seconds:.3f}), snapshotted {snap:.3f} s, "
            f"end-to-end {m.end_to_end_seconds:.3f} s (wall {wall:.3f} s), "
            f"{m.total_bytes} B at {m.aggregate_gbps:.3f} GB/s aggregate; "
            f"files {files}")
        for r in ranks:
            log(f"  rank {r['rank']}: {r['total_bytes']} B, wall "
                f"{r['wall_s']:.3f} s, flush {r['flush_s']:.3f} s, commit "
                f"{r['commit_s']:.3f} s, staging copy "
                f"{r['staging_copy_s']:.3f} s")
        if len(files) != 1:
            fail(f"(D) SINGLE_FILE save wrote {files}")
        out["save"] = dict(blocking_s=blocking,
                           reported_blocking_s=m.blocking_seconds,
                           snapshotted_s=snap,
                           end_to_end_s=m.end_to_end_seconds, wall_s=wall,
                           total_bytes=m.total_bytes, on_disk_bytes=written,
                           aggregate_gbps=m.aggregate_gbps, files=files,
                           direct=cfg.direct,
                           ranks=ranks, stall=stall_by_rank("save", since))
        out["save"]["strategy"] = str(getattr(cfg.strategy, "value",
                                              cfg.strategy))
        cold = cold_reads(path)
        restored, rwall = timed_restore(mw, state, 1)
        rm = mw.last_restore_metrics
        log(f"(D) restore ({cold}) onto {device} through rank 0's manager: "
            f"wall {rwall:.3f} s ({total / rwall / 1e9:.3f} GB/s of state), "
            f"read stall {rm.read_stall_seconds:.3f} s, decode "
            f"{rm.decode_seconds:.3f} s")
        out["restore"] = dict(restore_row(rm, rwall, total), cold=cold,
                              stall=stall("restore"))
        check_restored(restored, state, quant, writers=writers)
        del restored
        release(device)
        sync(device)
        t0 = time.perf_counter()
        readers = mw.restore_sharded(2, step=1)
        sync(device)
        nwall = time.perf_counter() - t0
        log(f"(D) elastic {writers} -> 2 restore onto {device}: wall "
            f"{nwall:.3f} s")
        whole = reader_windows(readers, state)
        del readers
        check_restored(whole, state, quant, writers=writers)
        del whole
        release(device)
        out["n_to_m"] = dict(readers=2, wall_s=nwall)
        out["dtensor"] = dtensor_restore(mw, state, quant, root)
        release(device)
    out["launches"] = {k: _lib.LAUNCHES[k] - before[k]
                       for k in ("quantize_blocks", "dequantize_blocks")}
    log(f"(D) restored states checked (whole, 2 readers, DTensor); kernel "
        f"launches within (D): {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"(D) never launched {name}")
    shutil.rmtree(path, ignore_errors=True)
    return out


def run_main_path(state: dict, root: str, probe_bytes: int,
                  tally: WriteTally) -> dict:
    """Drive ``state`` (a qwen2.5-3b-layout train state) through the
    port's storage stack on the device its tensors live on: (A) level 0 →
    level 1 → node loss → restore, (B) a delta chain through the object
    store, (C) the four engines, (D) four concurrent writer ranks. Each
    checkpoint kernel must be launched over the four."""
    from repro_torch.core import trace
    from repro_torch.kernels import _lib
    tensors = flat_leaves(state)
    device = next(iter(tensors.values())).device
    total = state_bytes(tensors)
    log(f"main path: {len(tensors)} tensors, {total} bytes "
        f"({total / 2**30:.2f} GiB) on {device}")
    quant = {k for k in tensors if k.startswith(QUANT_PREFIXES)
             and tensors[k].numel() * tensors[k].element_size() >= 1 << 16}
    os.makedirs(root, exist_ok=True)
    out: dict = {"state_bytes": total, "tensors": len(tensors),
                 "save_estimate": save_estimate(tensors, quant),
                 "multi_writer_estimate": multi_writer_estimate(
                     tensors, quant, WRITERS),
                 "odirect": odirect_probe(root),
                 "storage": storage_probe(root, probe_bytes)}
    tally.add("storage probe", probe_bytes)
    trace.enable()
    _lib.reset_launches()
    try:
        out["A"] = level1_node_loss(state, root, quant, tally)
        tally.check("after (A)")
        out["B"] = object_store_delta(state, root, quant, tally)
        tally.check("after (B)")
        out["C"] = engine_comparison(state, root, quant, tally)
        tally.check("after (C)")
        out["D"] = multi_writer(state, root, quant, tally)
        tally.check("after (D)")
    finally:
        trace.disable()
    out["launches"] = {k: _lib.LAUNCHES[k] for k in CHECKPOINT_KERNELS}
    log(f"kernel launches over (A)+(B)+(C)+(D): {out['launches']}")
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


def device_profile(prof, wall_s: float, steps: int, top: int = 8,
                   label: str = "run 2 profile") -> dict:
    """Kernel time from a ``torch.profiler`` run (kernel events only, so no
    time is counted twice): per group of kernels, the busiest kernels, and
    the device's busy share of the profiled window's host wall (the
    profiler adds host overhead, so the window is slower than a plain
    step)."""
    from torch.autograd import DeviceType
    averages = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in averages
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    # the host waiting for the device (a blocking copy waits this way)
    syncs = sum(e.count for e in averages
                if e.key == "cudaStreamSynchronize")
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
    log(f"  {label} ({steps} steps): kernels {busy_ms:.1f} ms "
        f"({busy_ms / steps:.1f} ms per step) in {wall_s * 1e3:.1f} ms of "
        f"profiled host wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy); "
        + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f}%)"
                    for g, ms in groups.items()))
    # operators the host dispatched (each ``aten::`` call, nested included)
    host_ops = sum(e.count for e in averages
                   if e.device_type == DeviceType.CPU
                   and e.key.startswith("aten::"))
    log(f"    {syncs} cudaStreamSynchronize calls; {host_ops} aten operator "
        f"calls on the host ({host_ops // steps} per step)")
    for key, ms, n in rows[:top]:
        log(f"    {ms:9.2f} ms  {n:6d} x  {key[:90]}")
    return dict(kernel_ms=busy_ms, wall_ms=wall_s * 1e3, steps=steps,
                stream_syncs=syncs, host_ops=host_ops, groups_ms=groups,
                top=[dict(name=k, ms=ms, count=n) for k, ms, n in rows[:top]])


def train_config():
    """Phase 4's model: recurrentgemma-2b at ``TRAIN_LAYERS`` of its 26
    layers, the first blocks of its 13-block pattern, every width kept."""
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-2b")
    return cfg.replace(num_layers=TRAIN_LAYERS,
                       block_pattern=cfg.block_pattern[:TRAIN_LAYERS])


def run_training(cfg, root: str, tally: WriteTally, *, phase: str,
                 kernels: tuple, profile: bool, on_resume=None
                 ) -> tuple[dict, dict]:
    """Phase 4 (and 4f): ``cfg`` through the port's Trainer at batch 8 x 255
    tokens, with an async checkpoint followed by an in-place step, and a
    resume in a fresh Trainer. ``kernels`` must each be launched over the
    two runs; ``profile`` runs run 2 under torch.profiler; ``on_resume``,
    when given, is called with run 2's restored state once its digests
    are checked (it is the saved state then). Returns the measurements
    and the digests of every leaf of the saved train state; the
    checkpoint stays under ``root`` for the serving phases."""
    import torch
    from repro_torch.core import trace
    from repro_torch.kernels import _lib, rglru as rk
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    layout = flat_leaves(init_train_state(cfg, device="meta"))
    total = state_bytes(layout)
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    log(f"{phase} training path: {cfg.name}, {cfg.num_layers} layers, "
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

    out: dict = {"arch": cfg.name, "layers": cfg.num_layers,
                 "state_bytes": total, "tensors": len(layout)}
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
    tally.add(f"phase {phase} checkpoint", du(root))
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
        if on_resume is not None:
            on_resume(state)
        if profile:
            # run 2 saves nothing: profile its two steps for the device's
            # view
            from torch.profiler import ProfilerActivity, profile as prof_of
            with prof_of(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                r2 = t2.run((state, start))
        else:
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
    out["launches"] = {k: _lib.LAUNCHES[k] for k in kernels}
    out["rglru_copy_launches"] = dict(rk.COPY_LAUNCHES)
    trace.disable()
    out["run2"] = dict(steps=log_steps("run 2", r2, B * S), restore=restore,
                       wall_s=r2["wall_seconds"],
                       peak_device_bytes=torch.cuda.max_memory_allocated(),
                       profile=(device_profile(prof, r2["wall_seconds"], 2)
                                if profile else None))
    del r2
    torch.cuda.empty_cache()
    out["train_steps"] = 5
    log(f"{phase} kernel launches over runs 1 and 2 (5 train steps, the "
        f"digests included): {out['launches']} (rglru_scan by copy variant "
        f"{out['rglru_copy_launches']})")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the phase {phase} "
                 f"training path")
    return out, saved[2]


def param_digests(saved: dict) -> dict:
    """The params' entries of a train state's digests, keyed without the
    ``params/`` prefix."""
    return {k[len("params/"):]: v for k, v in saved.items()
            if k.startswith("params/")}


def narrow_config():
    """recurrentgemma-2b's blocks at narrow widths, in float32."""
    from repro_torch.configs import get_config
    return get_config("recurrentgemma-2b").replace(
        dtype="float32", num_layers=3, block_pattern=("rglru", "rglru",
                                                      "attn_local"),
        d_model=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
        lru_dim=200, vocab_size=512, sliding_window=16)


NARROW_WIDTHS = dict(d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                     vocab_size=512, dtype="float32")


def card_vs_cpu_cases() -> list:
    """Phase 4b's cases: (label, float32 config, tokens per sequence). The
    narrow recurrentgemma; xLSTM (one mLSTM and one sLSTM block) at S =
    255, the quadratic mLSTM form, and at S = 512, the chunkwise form with
    two chunks; olmoe's MoE blocks (8 experts, top-2: some tokens drop at
    its capacity factor); musicgen's frontend prefix (8 projected frames)."""
    from repro_torch.configs import get_config
    xlstm = get_config(XLSTM_ARCH).replace(num_layers=2, **NARROW_WIDTHS)
    return [
        ("recurrentgemma", narrow_config(), 63),
        ("xlstm S=255", xlstm, 255),
        ("xlstm S=512", xlstm, 512),
        ("moe", get_config(MOE_ARCH).replace(
            num_layers=2, num_experts=8, experts_per_token=2, moe_d_ff=128,
            **NARROW_WIDTHS), 63),
        ("frontend", get_config("musicgen-large").replace(
            num_layers=2, d_ff=256, frontend_dim=64, frontend_len=8,
            **NARROW_WIDTHS), 63),
    ]


def cpu_vs_card(cfg, tokens: int, label: str) -> dict:
    """Phase 4b: two train steps of a narrow float32 config on the card
    and on the CPU from one set of weights and batches (batch 2).
    Tolerances: loss rtol 1e-4 (cuBLAS and the CPU sum in other orders;
    the MoE's dispatch-gather backward adds atomically on the card); params
    within 5e-5 + 1e-4 relative (a few learning-rate-sized AdamW steps)."""
    import torch
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 matmuls
    cpu_state = init_train_state(cfg, seed=0, device="cpu")
    states = {"cuda": tree_map_with_path(lambda _p, t: t.cuda(), cpu_state),
              "cpu": cpu_state}
    data = SyntheticPipeline(DataConfig(
        cfg.vocab_size, tokens + 1, 2, seed=0,
        frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim))
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
        fail(f"4b {label}: card vs CPU losses {losses}")
    got = flat_leaves(states["cuda"]["params"])
    param_err = 0.0
    for k, want in flat_leaves(states["cpu"]["params"]).items():
        diff = (got[k].cpu().double() - want.double()).abs()
        param_err = max(param_err, float(diff.max()))
        if bool((diff > 5e-5 + 1e-4 * want.double().abs()).any()):
            fail(f"4b {label}: card vs CPU params differ at {k}: max "
                 f"{float(diff.max())}")
    log(f"4b card vs CPU, narrow float32 {label} ({cfg.name} blocks, "
        f"{tokens} tokens), 2 steps: losses {losses['cuda']} vs "
        f"{losses['cpu']} (max rel {loss_err:.2e}), params max abs diff "
        f"{param_err:.2e}")
    return dict(label=label, arch=cfg.name, tokens=tokens, losses=losses,
                loss_rel_err=loss_err, param_max_abs_err=param_err)


def multilevel_resume(root: str, tally: WriteTally) -> dict:
    """Phase 4c: ``Trainer(multilevel_remote=)`` on 4b's narrow config on
    the card. Run 1 trains 2 steps and saves step 2 at level 0 and level 1
    (every leaf digested on the card as the save is called); level 0 is
    deleted; run 2, a fresh Trainer, resumes step 2 through the prefetcher
    with every digest equal, and trains one more step."""
    import math
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = narrow_config()
    level0, level1 = os.path.join(root, "l0"), os.path.join(root, "l1")
    shutil.rmtree(root, ignore_errors=True)

    def trainer(steps):
        return Trainer(cfg, TrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=level0,
            multilevel_remote=level1, keep=1, log_every=1, seed=0),
            data_cfg=DataConfig(cfg.vocab_size, 64, 2, seed=0),
            device="cuda")

    t1 = trainer(2)
    saved: dict = {}
    save = t1.ckpt.save

    def digesting_save(step, state):
        saved[step] = digests(state["train"])
        return save(step, state)

    t1.ckpt.save = digesting_save
    try:
        t1.run()
    finally:
        t1.close()
    tally.add("4c saves and flush", du(level0) + du(level1))
    shutil.rmtree(level0)                # node loss
    t2 = trainer(3)
    try:
        state, start = t2.initial_state()
        if start != 2 or list(saved) != [2]:
            fail(f"4c resumed at step {start}; run 1 saved {list(saved)}")
        got = digests(state)
        bad = [k for k in saved[2] if not torch.equal(got[k], saved[2][k])]
        if got.keys() != saved[2].keys() or bad:
            fail(f"4c: restored leaves differ from the saved ones: {bad[:3]}")
        rm = t2.ckpt.last_restore_metrics
        if rm.prefetch_seconds <= 0 or t2.ckpt.local.all_steps() != [2]:
            fail("4c: the resume did not go through the level-1 prefetcher")
        tally.add("4c promote", du(level0))
        r2 = t2.run((state, start))
    finally:
        t2.close()
    losses = [m["loss"] for m in r2["metrics"]]
    if [m["step"] for m in r2["metrics"]] != [2] or \
            not all(math.isfinite(x) for x in losses):
        fail(f"4c: run 2 logged {r2['metrics']}")
    log(f"4c: level-1 resume of step 2 after level-0 loss in "
        f"{t2.restore_attr['restore_seconds']:.3f} s (prefetch "
        f"{rm.prefetch_seconds:.3f} s), {len(got)} leaf digests equal, "
        f"step 2 promoted to level 0; step 2 loss {losses[0]:.4f}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(restore_s=t2.restore_attr["restore_seconds"],
                prefetch_s=rm.prefetch_seconds, leaves=len(got),
                losses=losses)


def io_written() -> int:
    """Bytes this process has passed to write calls so far (``wchar`` of
    /proc/self/io: every thread, O_DIRECT writes included)."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    fail("/proc/self/io has no wchar line")


def multiwriter_resume(root: str, tally: WriteTally) -> dict:
    """Phase 4d: ``Trainer(ckpt_writers=2, async_ckpt=True)`` on 4b's
    narrow config on the card: run 1 trains 3 steps, saving step 2 through
    two writer ranks and training step 3 in place right after the
    multi-writer snapshot barrier; run 2, a fresh single-writer Trainer,
    resumes step 2 and trains step 3. Its loss and final parameters must
    equal run 1's bit for bit."""
    import math
    import torch
    from repro_torch.core import MultiWriterCheckpointer
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = narrow_config()
    shutil.rmtree(root, ignore_errors=True)

    def trainer(writers, every):
        return Trainer(cfg, TrainerConfig(
            steps=3, ckpt_every=every, ckpt_dir=root, async_ckpt=True,
            ckpt_writers=writers, keep=None, log_every=1, seed=0),
            data_cfg=DataConfig(cfg.vocab_size, 64, 2, seed=0),
            device="cuda")

    t1 = trainer(2, 2)
    if not isinstance(t1.ckpt, MultiWriterCheckpointer):
        fail("4d: ckpt_writers=2 did not build a MultiWriterCheckpointer")
    try:
        r1 = t1.run()
    finally:
        t1.close()
    tally.add("4d saves", du(root))
    t2 = trainer(0, 5)
    try:
        state, start = t2.initial_state()
        if start != 2:
            fail(f"4d resumed at step {start}")
        r2 = t2.run((state, start))
    finally:
        t2.close()
    l1 = {m["step"]: m["loss"] for m in r1["metrics"]}
    l2 = {m["step"]: m["loss"] for m in r2["metrics"]}
    if sorted(l1) != [0, 1, 2] or sorted(l2) != [2] or \
            not all(math.isfinite(x) for x in l1.values()):
        fail(f"4d: run 1 logged {l1}, run 2 {l2}")
    if l2[2] != l1[2]:
        fail(f"4d: resumed step 2 loss {l2[2]!r} is not run 1's {l1[2]!r}")
    a, b = flat_leaves(r1["state"]), flat_leaves(r2["state"])
    bad = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
    if a.keys() != b.keys() or bad:
        fail(f"4d: final state differs from the uninterrupted run's at "
             f"{bad[:3]}")
    snap = r1["ckpt_snapshot_wait_seconds"]
    log(f"4d: 2-writer async save of step 2, step 3 in place after the "
        f"barrier (wait_snapshotted {snap:.3f} s); a single-writer Trainer "
        f"resumed step 2 in {t2.restore_attr['restore_seconds']:.3f} s: "
        f"step 2 loss {l2[2]:.6f} and all {len(a)} final leaves bit-equal "
        f"to the uninterrupted run's")
    shutil.rmtree(root, ignore_errors=True)
    return dict(loss=l2[2], leaves=len(a), snapshot_wait_s=snap,
                restore_s=t2.restore_attr["restore_seconds"])


# ------------------------------------------------------------ phase 4e
SERVE_SHAPE = (8, 64, 32)          # requests, prompt tokens, new tokens
SERVE_TOL = 0.05                   # decode against prefill: max |diff| / max
#                                    |logit|, tests/test_models.py's yardstick
SERVING_KERNELS = ("rglru_scan", "fingerprint_chunks")
SERVE_ARCH = "qwen2.5-3b"          # the second model, never checkpointed
PROFILE_SHAPE = (4, 4)             # prompt and new tokens of the profiled
#                                    decode window (7 steps)


@functools.lru_cache(maxsize=1)
def serve_example():
    """``examples/torch_serve_swap.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_serve_swap", os.path.join(HERE, "examples",
                                         "torch_serve_swap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def zoo_estimate() -> int:
    """Bytes the zoo example writes at most: each model's params saved
    once, and once more if its delta save were all dirty."""
    from repro_torch.train.steps import init_train_state
    zoo = serve_example()
    return 2 * sum(state_bytes(flat_leaves(init_train_state(
        zoo.zoo_config(a), device="meta")["params"])) for a in zoo.ARCHS)


def params_only(rec):
    """``window_fn`` of a params-only swap-in of a Trainer checkpoint: the
    params and the 0-d leaves whole, every other leaf with rows (the
    optimizer moments) an empty window, so none of it is read."""
    shape = tuple(rec.global_shape)
    whole = tuple((0, s) for s in shape)
    if rec.key.startswith("train/params/") or not shape:
        return [(whole, None)]
    return [(((0, 0),) + whole[1:], None)]


def swap_in(root: str, device, phase: str = "4e (a)") -> tuple[dict, dict]:
    """4e (a): a fresh ``CheckpointManager`` restores the newest step of
    ``root`` (a Trainer checkpoint) onto ``device`` and keeps only its
    params, the moments left unread (``params_only``)."""
    import torch
    from repro_torch.core import CheckpointManager

    device = torch.device(device)
    with CheckpointManager(root, device=device) as mgr:
        step = mgr.latest_step()
        sync(device)
        t0 = time.perf_counter()
        restored = mgr.restore(step=step, window_fn=params_only)
        sync(device)
        wall = time.perf_counter() - t0
        rm = mgr.last_restore_metrics
    params = restored["train"]["params"]
    del restored
    nbytes = state_bytes(flat_leaves(params))
    out = dict(step=step, wall_s=wall, params_bytes=nbytes,
               gbps=nbytes / wall / 1e9, read_s=rm.read_seconds,
               read_stall_s=rm.read_stall_seconds,
               assemble_s=rm.assemble_seconds, h2d_s=rm.h2d_seconds)
    log(f"{phase} swap-in of step {step}'s params "
        f"({len(flat_leaves(params))} tensors, {nbytes} B; the moments "
        f"left unread) onto {device} in "
        f"{wall:.3f} s ({out['gbps']:.3f} GB/s); read stall "
        f"{rm.read_stall_seconds:.3f} s, assemble {rm.assemble_seconds:.3f}"
        f" s")
    return params, out


def serve_requests(cfg, params, device, *, phase: str = "4e",
                   gate: bool = True, mesh=None, keep=None) -> dict:
    """4e (b)/(c), 4f, 4g, 4i: ``SERVE_SHAPE`` seeded requests through one
    ``make_prefill_step`` call and ``steps.generate`` (the prompt
    teacher-forced through ``decode_step``, then greedy tokens). The decode
    logits at the last prompt position must agree with the prefill's
    within ``SERVE_TOL`` (reported only, without ``gate``); prefill
    launches the RG-LRU scan once per RG-LRU block, each on the bulk-copy
    path, and decode never. With ``mesh`` (4i) the params are DTensors at
    the serve layouts, the prompt goes in at the tokens' layout, and the
    prefill and decode run with the Partitioner's activation layout, the
    decode cache laid out by ``serve_cache_layouts``. ``keep`` (a dict)
    gains the generated tokens and the logits at the last prompt position
    (whole, on the host)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.kernels import _lib, rglru as rk
    from repro_torch.models.config import RGLRU
    from repro_torch.train.steps import generate, make_prefill_step
    device = torch.device(device)
    B, S, new = SERVE_SHAPE
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
        dtype=torch.int32, device=device)
    act, layouts, whole = None, None, (lambda t: t)
    if mesh is not None:
        from repro_torch.launch.specs import serve_cache_layouts
        from repro_torch.models import transformer as T
        from repro_torch.sharding.partition import Layout, Partitioner
        part = Partitioner(cfg, mesh)
        act = Layout(mesh, part.activation_spec(B))
        prompt = part.tokens_sharding(B).distribute(prompt)
        layouts = serve_cache_layouts(cfg, mesh, T.init_cache(
            cfg, B, S + new, device="meta"))
        whole = lambda t: t.full_tensor()       # noqa: E731
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    b5 = _lib.LAUNCHES["rglru_scan"]
    bulk = rk.COPY_LAUNCHES["bulk"]
    sync(device)
    t0 = time.perf_counter()
    pre = make_prefill_step(cfg, act_sharding=act)(params,
                                                   {"tokens": prompt})
    sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_b5 = _lib.LAUNCHES["rglru_scan"] - b5
    prefill_bulk = rk.COPY_LAUNCHES["bulk"] - bulk
    rec: dict = {}
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, steps=new, record=rec,
                    act_sharding=act, cache_layouts=layouts)
    generate_s = time.perf_counter() - t0
    pre, rec["prompt_logits"] = whole(pre), whole(rec["prompt_logits"])
    if keep is not None:
        keep.update(tokens=toks.cpu(), prompt_logits=rec["prompt_logits"]
                    .cpu())
    decode_b5 = _lib.LAUNCHES["rglru_scan"] - b5 - prefill_b5
    want_b5 = (cfg.block_pattern.count(RGLRU) * cfg.num_groups
               if device.type == "cuda" else 0)
    if prefill_b5 != want_b5 or decode_b5:
        fail(f"{cfg.name}: rglru_scan launched {prefill_b5} times in the "
             f"prefill (want {want_b5}) and {decode_b5} in decode (want 0)")
    if prefill_bulk != prefill_b5:
        fail(f"{cfg.name}: {prefill_b5 - prefill_bulk} of the prefill's "
             f"rglru_scan launches left the bulk-copy path")
    if not (bool(torch.isfinite(pre).all())
            and bool(torch.isfinite(rec["prompt_logits"]).all())):
        fail(f"{cfg.name}: non-finite prefill or decode logits")
    if tuple(toks.shape) != (B, new) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{cfg.name}: generated {tuple(toks.shape)} tokens, or ids "
             f"outside the vocabulary")
    ratio = float((rec["prompt_logits"] - pre).abs().max()) / \
        float(pre.abs().max())
    if gate and not ratio < SERVE_TOL:
        fail(f"{cfg.name}: decode logits at the last prompt position differ "
             f"from the prefill's by {ratio:.4f} of the largest logit "
             f"(limit {SERVE_TOL})")
    steps = rec["step_s"]
    greedy = steps[S - 1:]
    out = dict(requests=B, prompt_tokens=S, new_tokens=new,
               prefill_s=prefill_s, prefill_rglru_launches=prefill_b5,
               decode_steps=len(steps),
               decode_median_ms=statistics.median(steps) * 1e3,
               decode_min_ms=min(steps) * 1e3,
               decode_max_ms=max(steps) * 1e3,
               tokens_per_s=B * new / sum(greedy), generate_s=generate_s,
               decode_vs_prefill=ratio, peak_device_bytes=(torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else None))
    log(f"{phase} {cfg.name}: {B} requests x {S}-token prompts, {new} new "
        f"tokens each; prefill {prefill_s * 1e3:.2f} ms ({prefill_b5} "
        f"rglru_scan launches), decode median {out['decode_median_ms']:.2f}"
        f" ms per step over {len(steps)} steps (min "
        f"{out['decode_min_ms']:.2f}, max {out['decode_max_ms']:.2f}), "
        f"{out['tokens_per_s']:.1f} generated tokens/s, decode vs prefill "
        f"{ratio:.5f} of the largest logit "
        f"({f'limit {SERVE_TOL}' if gate else 'reported, no gate'}), peak "
        f"device memory {out['peak_device_bytes']} B")
    return out


def check_params(params: dict, want: dict) -> None:
    """The swapped-in params against phase 4's digests of the saved state
    (plain fingerprint, bit-equal to the kernel's: phase 2)."""
    import torch
    from repro_torch.kernels import fingerprint as fpk
    got = flat_leaves(params)
    if got.keys() != want.keys():
        fail("4e: the swapped-in params have other leaves than the saved")
    bad = [k for k, t in got.items() if not torch.equal(
        fpk.fingerprint_chunks_plain(t.contiguous(), CHUNK).cpu(), want[k])]
    if bad:
        fail(f"4e: {len(bad)} swapped-in params differ from the saved "
             f"ones, e.g. {bad[:3]}")


def card_vs_cpu_decode(steps: int = 24) -> dict:
    """4e (e): ``steps`` decode steps of 4b's narrow float32 recurrentgemma
    (its 16-token ring wraps) on the card and on the CPU from one set of
    weights and tokens. Tolerance: logits and every cache leaf within rtol
    1e-4, atol 1e-5 (cuBLAS and the CPU sum in other orders)."""
    import numpy as np
    import torch
    from repro_torch.core.serialization import tree_map_with_path
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import init_train_state, make_serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = narrow_config()
    cpu = init_train_state(cfg, seed=0, device="cpu")["params"]
    params = {"cpu": cpu,
              "cuda": tree_map_with_path(lambda _p, t: t.cuda(), cpu)}
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, steps)), dtype=torch.int32)
    serve = make_serve_step(cfg)
    logits: dict = {}
    caches = {}
    for dev in params:
        cache = T.init_cache(cfg, 2, steps, device=dev)
        for t in range(steps):
            pos = torch.full((2, 1), t, dtype=torch.int32, device=dev)
            out, cache = serve(params[dev], cache,
                               tokens[:, t:t + 1].to(dev), pos)
            logits.setdefault(dev, []).append(out.cpu())
        caches[dev] = flat_leaves(cache)
    err = 0.0
    pairs = list(zip(logits["cuda"], logits["cpu"])) + [
        (caches["cuda"][k].cpu(), caches["cpu"][k]) for k in caches["cpu"]]
    for got, want in pairs:
        diff = (got.double() - want.double()).abs()
        err = max(err, float(diff.max()))
        if bool((diff > 1e-5 + 1e-4 * want.double().abs()).any()):
            fail(f"4e card vs CPU decode differs: max {float(diff.max())}")
    log(f"4e (e) card vs CPU, narrow float32 decode, {steps} steps: logits "
        f"and {len(caches['cpu'])} cache leaves within rtol 1e-4 / atol "
        f"1e-5, max abs diff {err:.2e}")
    return dict(steps=steps, max_abs_err=err)


def serve_path(root: str, zoo_root: str, tally: WriteTally,
               params_digests: dict, kept: dict) -> dict:
    """Phase 4e: the serving path. (a) full-width recurrentgemma-2b's
    params (10 of 26 layers) swapped in from phase 4's checkpoint under
    ``root`` and checked against its digests, (b) served; (c) full-width
    qwen2.5-3b, initialised on the card, served; (d) the zoo example on
    the card; (e) a narrow decode on the card against the CPU; last, each
    served model's decode under the profiler. The RG-LRU scan (prefill)
    and the fingerprint kernel (the example's delta saves) must be
    launched. ``kept`` gains each served model's tokens and last prompt
    logits (``serve_requests``), which 4i is held to."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import layers as L, transformer as T
    torch.cuda.empty_cache()
    out: dict = {}
    out["swap_in_reads"] = cold_reads(root)
    _lib.reset_launches()
    params, out["swap_in"] = swap_in(root, "cuda")
    check_params(params, params_digests)
    log(f"4e (a): {len(params_digests)} swapped-in params equal the saved "
        f"state's digests")
    cfg = train_config()
    out[cfg.name] = serve_requests(cfg, params, "cuda",
                                   keep=kept.setdefault(cfg.name, {}))
    del params
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = T.cast_params(T.init_params(cfg, seed=0, device="cuda"),
                           L.dtype_of(cfg))
    log(f"4e (c) {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, initialised on the card in "
        f"{time.perf_counter() - t0:.3f} s "
        f"({state_bytes(flat_leaves(params))} B of params)")
    out[cfg.name] = serve_requests(cfg, params, "cuda",
                                   keep=kept.setdefault(cfg.name, {}))
    del params
    torch.cuda.empty_cache()
    w0 = io_written()
    t0 = time.perf_counter()
    out["zoo"] = serve_example().main(zoo_root, device="cuda")
    out["zoo"]["seconds"] = time.perf_counter() - t0
    written = io_written() - w0
    tally.add("4e zoo example (write calls)", written)
    shutil.rmtree(zoo_root, ignore_errors=True)
    log(f"4e (d) zoo example on the card: {len(out['zoo']['swaps'])} "
        f"swap-ins and {len(out['zoo']['updates'])} delta updates in "
        f"{out['zoo']['seconds']:.1f} s, {written} B passed to write calls")
    out["launches"] = {k: _lib.LAUNCHES[k] for k in SERVING_KERNELS}
    log(f"kernel launches over phase 4e: {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the serving path")
    out["cpu_vs_card"] = card_vs_cpu_decode()
    out["decode_profiles"] = decode_profiles()
    return out


def decode_profiles() -> dict:
    """4e, last: each served model's decode (``SERVE_SHAPE``'s batch,
    weights from ``init_params``: the kernels do not depend on the values)
    for ``PROFILE_SHAPE`` under ``torch.profiler`` — kernel time per step,
    the device's busy share and the host's stream syncs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.train.steps import generate
    ps, pn = PROFILE_SHAPE
    out: dict = {}
    for arch in ("recurrentgemma-2b", SERVE_ARCH, XLSTM_ARCH, MOE_ARCH):
        cfg = get_config(arch)
        params = T.cast_params(T.init_params(cfg, seed=0, device="cuda"),
                               L.dtype_of(cfg))
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_SHAPE[0], ps)), dtype=torch.int32,
            device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(cfg, params, prompt, steps=pn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[arch] = device_profile(prof, wall, ps + pn - 1,
                                   label=f"4e {arch} decode profile")
        del params
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phases 4f, 4g
def cli_args(l0: str, l1: str, *extra: str) -> list:
    """The failover child's command-line arguments (4f): full xlstm-350m,
    two-level, its other options at their defaults."""
    return ["--arch", XLSTM_ARCH, "--full", "--ckpt-dir", l0, "--remote-dir",
            l1, "--log-every", "1", *extra]


def proc_written(pid: int) -> int | None:
    """``wchar`` of /proc/<pid>/io: what a child passed to write calls so
    far (None when it cannot be read)."""
    try:
        with open(f"/proc/{pid}/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def failover_child(l0: str, l1: str, tally: WriteTally
                   ) -> tuple[dict, float]:
    """4f (i): the training CLI as the failover child, SIGKILLed once step
    2 is committed at level 1 and step 4's save has begun at level 0 (its
    ``.tmp-`` dir exists), watched every 5 ms. Returns its logged losses,
    the flush as the watch saw it and what the kill left, and the kill's
    time (``time.perf_counter``)."""
    import signal
    import threading
    from repro_torch.core.checkpoint import step_dir_name
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH", "")) if p))
    torn_step = 2 * FAILOVER_CKPT_EVERY
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *cli_args(
        l0, l1, "--ckpt-every", str(FAILOVER_CKPT_EVERY), "--steps",
        str(torn_step + 2))]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []

    def read():
        for line in child.stdout:
            lines.append(line.rstrip("\n"))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    step2 = step_dir_name(FAILOVER_CKPT_EVERY)
    seen: dict = {}
    written = None
    try:
        while True:
            now = time.perf_counter()
            for name, path in (("level0", os.path.join(l0, step2)),
                               ("level1", os.path.join(l1, step2))):
                if name not in seen and os.path.exists(
                        os.path.join(path, "manifest.json")):
                    seen[name] = now
            torn = [n for n in (os.listdir(l0) if os.path.isdir(l0) else ())
                    if n.startswith(step_dir_name(torn_step) + ".tmp-")]
            written = proc_written(child.pid) or written
            if "level1" in seen and torn:
                child.send_signal(signal.SIGKILL)
                t_kill = time.perf_counter()
                break
            if child.poll() is not None:
                reader.join(timeout=10)
                fail(f"4f (i) the child exited {child.returncode} before "
                     f"the kill:\n" + "\n".join(lines[-40:]))
            if now - t0 > 900:
                fail("4f (i) no save of step 4 within 900 s")
            time.sleep(0.005)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        reader.join(timeout=10)
    left = {"level0": sorted(os.listdir(l0)), "level1": sorted(os.listdir(l1))}
    if left["level0"][:1] != [step2] or len(left["level0"]) != 2 \
            or left["level1"] != [step2]:
        fail(f"4f (i) the kill left {left}")
    losses = {}
    for line in lines:
        if line.startswith("step "):
            _, step, _, loss, _, secs = line.split()
            losses[int(step)] = (float(loss), float(secs))
    if sorted(losses) != list(range(torn_step)) or not all(
            math.isfinite(x) for x, _ in losses.values()):
        fail(f"4f (i) the child logged {losses}")
    flushed = du(os.path.join(l1, step2))
    flush_s = seen["level1"] - seen["level0"]
    # write calls miss what io_uring writes, and /proc may be unreadable:
    # at least step 2's two copies and the torn save's allowance
    tallied = max(written or 0, du(os.path.join(l0, step2)) + flushed
                  + TORN_ALLOWANCE)
    tally.add("4f (i) failover child", tallied)
    out = dict(losses={s: x for s, (x, _) in sorted(losses.items())},
               step_s={s: t for s, (_, t) in sorted(losses.items())},
               kill_s=t_kill - t0, flush_s=flush_s, flush_bytes=flushed,
               flush_gbps=flushed / flush_s / 1e9, write_calls=written,
               tallied_bytes=tallied, left=left)
    log(f"4f (i) {' '.join(cmd[1:4])} ... killed {out['kill_s']:.1f} s after "
        f"its start (step walls " + " / ".join(
            f"{t:.3f}" for t in out["step_s"].values()) + " s); level-1 "
        f"flush of step 2 as watched: {flushed} B in {flush_s:.3f} s "
        f"({out['flush_gbps']:.3f} GB/s); the kill left {left}; the child "
        f"passed {written} B to write calls, tallied {tallied} B")
    return out, t_kill


def failover_path(cfg, root: str, tally: WriteTally, on_resume
                  ) -> tuple[dict, dict]:
    """Phase 4f (i)-(iii): full xlstm-350m killed mid-save, resumed from
    level 0, recovered from level 1 after node loss (see ``failover_child``
    and the module docstring). ``on_resume`` is called with (ii)'s restored
    state once its losses are checked. Returns the measurements and step
    2's digests; step 2 is left at level 0 (promoted) under ``root``."""
    import torch
    from repro_torch.core.checkpoint import step_dir_name
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as launch_train
    from repro_torch.train.steps import init_train_state

    def trainer(steps: int):
        # saves every 5 steps: (ii) and (iii) stop before they save again
        args = launch_train.parser().parse_args(cli_args(
            l0, l1, "--ckpt-every", "5", "--steps", str(steps)))
        return launch_train.build_trainer(args)

    l0, l1 = os.path.join(root, "l0"), os.path.join(root, "l1")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total = state_bytes(flat_leaves(init_train_state(cfg, device="meta")))
    free = shutil.disk_usage(root).free
    if free < 3 * total + (2 << 30):
        fail(f"{root}: {free} B free, the failover needs three copies of "
             f"{total} B")
    log(f"4f failover path: {cfg.name}, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}; train state {total} B")
    _lib.reset_launches()
    out: dict = {"state_bytes": total}
    out["run1"], t_kill = failover_child(l0, l1, tally)
    step = FAILOVER_CKPT_EVERY

    # (ii) the restart: step 2 from level 0, the torn step skipped
    t2 = trainer(2 * step)
    try:
        after_gc = sorted(os.listdir(l0))
        state, start = t2.initial_state()
        sync(t2.device)
        resumed = time.perf_counter()
        if start != step:
            fail(f"4f (ii) resumed at step {start}, not {step}")
        saved = digests(state)
        r2 = t2.run((state, start))
        for m in r2["metrics"]:
            want = out["run1"]["losses"][m["step"]]
            if abs(m["loss"] - want) > 1e-6 * abs(want):
                fail(f"4f (ii) step {m['step']} loss {m['loss']!r}, the "
                     f"killed run's {want!r}")
        if [m["step"] for m in r2["metrics"]] != [step, step + 1]:
            fail(f"4f (ii) re-ran steps {r2['metrics']}")
    finally:
        t2.close()
    out["run2"] = dict(
        after_gc=after_gc, torn_reaped=len(after_gc) == 1,
        kill_to_resume_s=resumed - t_kill,
        restore=dict(t2.restore_attr),
        losses={m["step"]: m["loss"] for m in r2["metrics"]},
        step_s={m["step"]: m["seconds"] for m in r2["metrics"]})
    del state, r2
    torch.cuda.empty_cache()
    log(f"4f (ii) resumed step {step} from level 0 "
        f"{out['run2']['kill_to_resume_s']:.3f} s after the kill (restore "
        f"{out['run2']['restore']['restore_seconds']:.3f} s); level 0 after "
        f"the start-up reap: {after_gc}; steps {step} and {step + 1} "
        f"re-run, losses {out['run2']['losses']} equal the killed run's "
        f"within 1e-6 relative")

    # (iii) node loss: level 0 gone, step 2 prefetched from level 1
    shutil.rmtree(l0)
    t3 = trainer(step)
    try:
        state, start = t3.initial_state()
        rm = t3.ckpt.last_restore_metrics
        if start != step:
            fail(f"4f (iii) resumed at step {start}, not {step}")
        got = digests(state)
        bad = [k for k in saved if not torch.equal(got[k], saved[k])]
        if got.keys() != saved.keys() or bad:
            fail(f"4f (iii) {len(bad)} leaves restored from level 1 differ "
                 f"from step {step} as saved, e.g. {bad[:3]}")
        on_resume(state)
    finally:
        t3.close()
    del state
    torch.cuda.empty_cache()
    if sorted(os.listdir(l0)) != [step_dir_name(step)]:
        fail(f"4f (iii) level 0 holds {sorted(os.listdir(l0))} after the "
             f"prefetch")
    tally.add("4f (iii) promote at level 0", du(l0))
    out["run3"] = dict(restore=dict(t3.restore_attr),
                       prefetch_s=rm.prefetch_seconds)
    r3 = out["run3"]["restore"]
    log(f"4f (iii) node loss: step {step} restored from level 1 through the "
        f"prefetcher in {r3['restore_seconds']:.3f} s (read stall "
        f"{r3['restore_read_stall_s']:.3f} s, prefetch "
        f"{rm.prefetch_seconds:.3f} s), promoted to level 0; "
        f"{len(saved)} leaf digests equal step {step}'s as saved")
    out["launches"] = {k: _lib.LAUNCHES[k] for k in XLSTM_KERNELS}
    log(f"4f kernel launches over (i)-(iii): {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the 4f failover path")
    return out, saved


def xlstm_path(root: str, tally: WriteTally) -> dict:
    """Phase 4f, the slice's path: full-width, full-depth xlstm-350m (24
    layers, d_model 1024, 4 heads, up-projection 2048, vocab 50304; no cut)
    killed mid-save, resumed and recovered from level 1
    (``failover_path``), then served from the recovered step 2: its params
    swapped in (reads made cold, params only through ``window_fn``) and
    ``SERVE_SHAPE`` requests prefilled and decoded through the mLSTM and
    sLSTM caches in bf16 (decode vs prefill reported), then again on the
    same weights in float32 under the ``SERVE_TOL`` yardstick. Between the
    recovery and the swap-in, phase 4h (b): step 2 restored onto a 2x2
    mesh of CPU ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import tree_map_with_path
    cfg = get_config(XLSTM_ARCH)
    l0 = os.path.join(root, "l0")
    try:
        windows: dict = {}
        out, saved = failover_path(cfg, root, tally, lambda state:
                                   windows.update(window_crcs(
                                       cfg, state, MESH_RESTORE)))
        saved = param_digests(saved)
        out["mesh_restore"] = cpu_mesh_restore(cfg, l0, windows)
        out["swap_in_reads"] = cold_reads(l0)
        params, out["swap_in"] = swap_in(l0, "cuda", phase="4f")
        check_params(params, saved)
        log(f"4f: {len(saved)} swapped-in params equal the saved state's "
            f"digests")
        # served as trained, in bf16: at full depth the two forms of the
        # recurrences (prefill: quadratic mLSTM, hoisted sLSTM GEMM;
        # decode: one step) round apart in bf16 and the 24 blocks amplify
        # it, in the reference too (its bf16 decode vs prefill at this
        # config is 0.114 of the largest logit on the CPU), so the ratio is
        # reported here and the yardstick held on the same weights in
        # float32
        out["serve"] = serve_requests(cfg, params, "cuda",
                                      phase="4f (bf16)", gate=False)
        f32 = tree_map_with_path(lambda _p, t: t.float(), params)
        del params
        out["serve_f32"] = serve_requests(cfg.replace(dtype="float32"), f32,
                                          "cuda", phase="4f (float32)")
        del f32
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    r1, r2, r3, sv = out["run1"], out["run2"], out["run3"], out["serve"]
    log(f"4f {cfg.name} summary: step wall (i) " + " / ".join(
        f"{t:.3f}" for t in r1["step_s"].values()) + ", (ii) " + " / ".join(
        f"{t:.3f}" for t in r2["step_s"].values()) + f" s; level-1 flush "
        f"{r1['flush_s']:.3f} s for {r1['flush_bytes']} B "
        f"({r1['flush_gbps']:.3f} GB/s); kill to resume "
        f"{r2['kill_to_resume_s']:.3f} s; node-loss restore "
        f"{r3['restore']['restore_seconds']:.3f} s (read stall "
        f"{r3['restore']['restore_read_stall_s']:.3f} s); bf16 prefill "
        f"{sv['prefill_s'] * 1e3:.2f} ms, decode median "
        f"{sv['decode_median_ms']:.2f} ms per step, "
        f"{sv['tokens_per_s']:.1f} tokens/s, decode vs prefill "
        f"{sv['decode_vs_prefill']:.5f}; float32 decode vs prefill "
        f"{out['serve_f32']['decode_vs_prefill']:.2e} (limit {SERVE_TOL})")
    out["step_profile"] = xlstm_step_profile()
    return out


def xlstm_step_profile() -> dict:
    """4f, last: where an xlstm-350m train step's time goes, from one group
    (one mLSTM and one sLSTM block) at full width — 1/12 of the model's
    blocks, so the profiler's event count stays small: one warm-up step,
    then one step under torch.profiler (kernel time by group, the card's
    busy share of the step's host wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = get_config(XLSTM_ARCH).replace(num_layers=2)
    state = init_train_state(cfg, seed=0, device="cuda")
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, S + 1, B, seed=0))
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in data.batch_at(s).items()} for s in range(2)]
    step = make_train_step(cfg)
    state, m = step(state, batches[0])
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[1])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    return device_profile(prof, wall, 1, label=f"4f {cfg.name} train step "
                          f"profile, one group at full width ({B} x {S} "
                          f"tokens)")


# ------------------------------------------------------------ phase 4h
def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def local_leaves(state) -> dict:
    """key -> this rank's block of every leaf of a DTensor state (a leaf
    that is no DTensor fails the run)."""
    from repro_torch.sharding.dtensor import is_dtensor
    out = {}
    for k, v in flat_leaves(state).items():
        if not is_dtensor(v):
            fail(f"restored leaf {k} is {type(v).__name__}, not a DTensor")
        out[k] = v.to_local()
    return out


def rglru_launches_per_step(cfg) -> int:
    """B5 launches of one train step: forward, the remat recompute (when
    on) and the fused backward of every RG-LRU block."""
    blocks = sum(k == "rglru" for k in cfg.block_pattern) * cfg.num_groups
    return blocks * (3 if cfg.remat else 2)


def mesh_step_profile(trainer, state) -> dict:
    """One more train step (step 4) of the mesh Trainer's DTensor state
    under torch.profiler, outside the Trainer so nothing is saved: the
    card's kernel time and the host's operator calls beside run 2's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.steps import make_train_step
    step_fn = make_train_step(trainer.cfg, trainer.opt_cfg,
                              grad_shardings=trainer.grad_shardings,
                              act_sharding=trainer.act_sharding)
    batch = {k: trainer.batch_layouts[k].distribute(
        torch.as_tensor(v, device=trainer.device))
        for k, v in trainer.pipeline.batch_at(4).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
    wall = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"4h (a) profiled step 4 loss {loss}")
    log(f"  4h (a) mesh step 4 (profiled): loss {loss:.4f}, {wall:.3f} s")
    return device_profile(prof, wall, 1, label="4h (a) mesh step 4 profile")


def mesh_batch(trainer, step: int) -> dict:
    """Step ``step``'s batch at the mesh Trainer's layouts."""
    import torch
    return {k: trainer.batch_layouts[k].distribute(
        torch.as_tensor(v, device=trainer.device))
        for k, v in trainer.pipeline.batch_at(step).items()}


def mesh_step(trainer, state, step: int) -> float:
    """One train step of the mesh Trainer's DTensor state on step
    ``step``'s batch, outside the Trainer (nothing is saved); its loss."""
    from repro_torch.train.steps import make_train_step
    step_fn = make_train_step(trainer.cfg, trainer.opt_cfg,
                              grad_shardings=trainer.grad_shardings,
                              act_sharding=trainer.act_sharding)
    _, metrics = step_fn(state, mesh_batch(trainer, step))
    return float(metrics["loss"])


def step_peak(trainer, state, step: int, phase: str) -> dict:
    """The card's memory over one warm train step of a mesh Trainer's
    state (``mesh_step``), ``reset_peak_memory_stats()`` just before it:
    ``max_memory_allocated()``, and the bytes already allocated beside the
    step's arguments (state and batch), which the dry run does not see."""
    import torch
    from repro_torch.launch.dryrun import storages
    batch = mesh_batch(trainer, step)
    args = sum(storages((state, batch)).values())
    del batch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = mesh_step(trainer, state, step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss):
        fail(f"{phase} memory step {step} loss {loss}")
    out = dict(max_memory_allocated=peak, allocated_before=before,
               argument_bytes=args, resident_bytes=before - args,
               step_peak_bytes=peak - (before - args))
    log(f"  {phase} warm step {step} (reset_peak_memory_stats before it): "
        f"max_memory_allocated {peak} B; allocated before it {before} B, "
        f"of which the step's arguments {args} B; the step's own peak "
        f"{out['step_peak_bytes']} B")
    return out


def mesh_resume(cfg, root: str, saved: dict, run1: dict, run2: dict
                ) -> dict:
    """Phase 4h (a): phase 4's checkpoint of step 2 resumed by a third
    Trainer with ``mesh=make_host_mesh(1, 1)`` on a 1-rank NCCL group —
    the restore through ``restore(shardings=)`` onto a ``meta`` template
    with the Partitioner's layouts, every leaf a DTensor whose local block
    must equal the saved state's digest — and trained steps 2 and 3 on
    DTensors (it checkpoints every 5: nothing is written). Each loss must
    lie within 1e-4 relative of run 2's at the same step, and B5 must run
    under ``local_map`` as many times as in phase 4's steps. Its step
    walls print beside run 1's (unprofiled) and run 2's (profiled); a
    step 4, profiled, follows (``mesh_step_profile``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        trainer = Trainer(cfg, TrainerConfig(
            steps=4, ckpt_every=5, ckpt_dir=root, async_ckpt=True, keep=1,
            log_every=1, seed=0), device="cuda", mesh=make_host_mesh(1, 1))
        try:
            state, start = trainer.initial_state()
            restore_s = trainer.restore_attr["restore_seconds"]
            got = digests(local_leaves(state))
            if start != 2 or got.keys() != saved.keys():
                fail(f"4h (a) resumed step {start} with {len(got)} leaves; "
                     f"phase 4 saved step 2 with {len(saved)}")
            bad = [k for k in saved if not torch.equal(got[k], saved[k])]
            if bad:
                fail(f"4h (a): {len(bad)} restored local blocks differ from "
                     f"the saved state, e.g. {bad[:3]}")
            log(f"4h (a) {cfg.name} resumed onto a 1x1 cuda mesh through "
                f"restore(shardings=) in {restore_s:.3f} s; {len(saved)} "
                f"DTensor leaves, every local block's digest equal to the "
                f"saved state's")
            _lib.reset_launches()
            out = trainer.run((state, start))
            launches = _lib.LAUNCHES["rglru_scan"]
            memory = step_peak(trainer, out["state"], 4, "4h (a)")
            prof_out = mesh_step_profile(trainer, out["state"])
        finally:
            trainer.close()
        del state
    finally:
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated()
    finite_losses(out, [2, 3])
    steps = log_steps("4h (a) mesh run", out, B * S)
    diffs = []
    for m3, m2 in zip(steps, run2["steps"]):
        rel = abs(m3["loss"] - m2["loss"]) / abs(m2["loss"])
        diffs.append(rel)
        if rel > 1e-4:
            fail(f"4h (a) step {m3['step']} loss {m3['loss']} is {rel:.2e} "
                 f"from run 2's {m2['loss']} (limit 1e-4 relative)")
    want = rglru_launches_per_step(cfg) * len(steps)
    if launches != want:
        fail(f"4h (a): rglru_scan launched {launches} times under the mesh, "
             f"{want} expected")
    log(f"4h (a) losses within {max(diffs):.2e} relative of run 2's "
        f"(limit 1e-4); step wall on the mesh "
        + " / ".join(f"{m['seconds']:.3f}" for m in steps)
        + " s vs run 2's (profiled) "
        + " / ".join(f"{m['seconds']:.3f}" for m in run2["steps"])
        + " s and run 1's (not) "
        + " / ".join(f"{m['seconds']:.3f}" for m in run1["steps"])
        + f" s; rglru_scan {launches} launches through local_map "
        f"({launches // len(steps)} per step); peak device memory {peak} B")
    r2p = run2.get("profile") or {}
    if prof_out and r2p:
        log(f"4h (a) profiled, per step, mesh vs run 2: kernels "
            f"{prof_out['kernel_ms']:.1f} vs "
            f"{r2p['kernel_ms'] / r2p['steps']:.1f} ms, host wall "
            f"{prof_out['wall_ms']:.1f} vs "
            f"{r2p['wall_ms'] / r2p['steps']:.1f} ms, aten calls "
            f"{prof_out['host_ops']} vs {r2p['host_ops'] // r2p['steps']}")
    torch.cuda.empty_cache()
    return dict(restore_s=restore_s, steps=steps, loss_rel_diff=diffs,
                launches={"rglru_scan": launches}, peak_device_bytes=peak,
                profile=prof_out, memory=memory)


# ------------------------------------------------------------ phase 4i
def mesh_swap_in(root: str, cfg, mesh) -> tuple[dict, dict]:
    """4i (a): the newest step of ``root`` (a Trainer checkpoint) swapped
    in params-only at ``serve_specs``' param layouts (TP only) through
    ``restore(shardings=, window_fn=)``: each param read at its layout,
    every other leaf with rows an empty window, so no moment byte is read
    (``RestoreMetrics.read_bytes`` must equal the bytes of the param
    extents that meet the rank's windows and of the 0-d leaves)."""
    from repro_torch.core import CheckpointManager
    from repro_torch.core.checkpoint import mesh_device, step_dir_name
    from repro_torch.core.manifest import Manifest
    from repro_torch.core.pipeline import dtensor_window
    from repro_torch.core.resharding import dedupe_shards, plan_window
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import Partitioner
    layouts = {"train/params/" + k: v for k, v in flat_leaves(Partitioner(
        cfg, mesh).param_shardings(T.init_params(cfg, device="meta")))
        .items()}
    device = mesh_device(mesh)
    with CheckpointManager(root, device=device) as mgr:
        step = mgr.latest_step()
        sync(device)
        t0 = time.perf_counter()
        restored = mgr.restore(step=step, shardings=layouts,
                               window_fn=params_only)
        sync(device)
        wall = time.perf_counter() - t0
        rm = mgr.last_restore_metrics
    manifest = Manifest.load(os.path.join(root, step_dir_name(step)))
    want = 0
    for key, rec in manifest.tensors.items():
        if key in layouts:
            win = dtensor_window(mesh, layouts[key].placements,
                                 tuple(rec.global_shape))[0]
        elif rec.global_shape:
            continue
        else:
            win = ()
        rec.shards = dedupe_shards(rec)
        want += sum({(p.shard.path, p.shard.offset): p.shard.nbytes
                     for p in plan_window(rec, win)}.values())
    moments = [k for k, t in flat_leaves(restored["train"]["opt"]).items()
               if t.ndim and t.numel()]
    if rm.read_bytes != want or moments:
        fail(f"4i (a) swap-in read {rm.read_bytes} B, its windows' extents "
             f"hold {want} B; moment leaves read: {moments[:3]}")
    params = restored["train"]["params"]
    del restored
    nbytes = state_bytes(local_leaves(params))
    out = dict(step=step, wall_s=wall, read_bytes=rm.read_bytes,
               params_bytes=nbytes, gbps=nbytes / wall / 1e9,
               read_stall_s=rm.read_stall_seconds,
               assemble_s=rm.assemble_seconds)
    log(f"4i (a) swap-in of step {step}'s params onto the 1x1 mesh at the "
        f"serve layouts ({len(layouts)} DTensors, {nbytes} B; read "
        f"{rm.read_bytes} B = the param windows' extents, no moment byte) "
        f"in {wall:.3f} s ({out['gbps']:.3f} GB/s); read stall "
        f"{rm.read_stall_seconds:.3f} s")
    return params, out


def held_to_unsharded(tag: str, got: dict, want: dict, mesh_out: dict,
                      plain_out: dict, against: str = "4e") -> dict:
    """4i's and 4j's gates against the unsharded run of the same params
    (phase ``against``): the greedy tokens equal; the logits at the last
    prompt position reported as their largest difference, absolute and of
    the largest logit."""
    if not bool((got["tokens"] == want["tokens"]).all()):
        n = int((got["tokens"] != want["tokens"]).sum())
        fail(f"{tag}: {n} of {got['tokens'].numel()} greedy tokens on the "
             f"mesh differ from {against}'s unsharded run")
    diff = float((got["prompt_logits"] - want["prompt_logits"]).abs().max())
    rel = diff / float(want["prompt_logits"].abs().max())
    log(f"{tag}: greedy tokens equal to {against}'s "
        f"({got['tokens'].numel()}); last prompt logits within {diff:.3e} "
        f"of {against}'s ({rel:.2e} of the "
        f"largest); decode median {mesh_out['decode_median_ms']:.2f} ms per "
        f"step on the mesh vs {plain_out['decode_median_ms']:.2f} unsharded"
        f", prefill {mesh_out['prefill_s'] * 1e3:.2f} vs "
        f"{plain_out['prefill_s'] * 1e3:.2f} ms, "
        f"{mesh_out['tokens_per_s']:.1f} vs {plain_out['tokens_per_s']:.1f}"
        f" tokens/s")
    was = MESH_SERVE_BEFORE.get(tag)
    if was:
        log(f"{tag} beside the runs before attention and the lookup "
            f"split over model: prefill {mesh_out['prefill_s'] * 1e3:.2f} "
            f"ms (then {was['prefill_ms'][0]}–{was['prefill_ms'][1]}), "
            f"decode median {mesh_out['decode_median_ms']:.2f} ms per step "
            f"(then {was['decode_median_ms'][0]}–"
            f"{was['decode_median_ms'][1]})")
    return dict(logits_max_abs_diff=diff, logits_rel_diff=rel)


def serve_mesh(root: str, saved: dict, kept: dict, serving: dict) -> dict:
    """Phase 4i, serving on a mesh: a 1-rank NCCL group and
    ``make_host_mesh(1, 1)``. (a) phase 4's checkpoint swapped in
    params-only at the serve layouts (``mesh_swap_in``), every local block
    equal to the saved state's digest (the fingerprint kernel on the
    card), then ``SERVE_SHAPE`` requests prefilled on DTensors (B5 under
    ``local_map``) and decoded by ``generate`` through DTensor caches laid
    out by ``serve_cache_layouts``; (b) full-width, full-depth qwen2.5-3b
    initialised on the card as in 4e (c), distributed to the serve
    layouts and served the same way. Gates of each: decode vs prefill
    within ``SERVE_TOL`` and the greedy tokens equal to 4e's unsharded
    run of the same params (``kept``); B5 7 times in (a)'s prefill."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    torch.cuda.empty_cache()
    out: dict = {"swap_in_reads": cold_reads(root)}
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        _lib.reset_launches()
        cfg = train_config()
        params, out["swap_in"] = mesh_swap_in(root, cfg, mesh)
        got = digests(local_leaves(params))
        want = param_digests(saved)
        bad = [k for k in want if k not in got
               or not torch.equal(got[k], want[k])]
        if got.keys() != want.keys() or bad:
            fail(f"4i (a): {len(bad)} swapped-in local blocks differ from "
                 f"the saved state, e.g. {bad[:3]}")
        log(f"4i (a): {len(want)} local blocks equal the saved state's "
            f"digests")
        mine: dict = {}
        out[cfg.name] = serve_requests(cfg, params, "cuda", phase="4i (a)",
                                       mesh=mesh, keep=mine)
        out[cfg.name].update(held_to_unsharded(
            "4i (a)", mine, kept[cfg.name], out[cfg.name],
            serving[cfg.name]))
        del params
        torch.cuda.empty_cache()
        cfg = get_config(SERVE_ARCH)
        params = T.cast_params(T.init_params(cfg, seed=0, device="cuda"),
                               L.dtype_of(cfg))
        params = shard_tree(params, Partitioner(cfg, mesh).param_shardings(
            params))
        mine = {}
        out[cfg.name] = serve_requests(cfg, params, "cuda", phase="4i (b)",
                                       mesh=mesh, keep=mine)
        out[cfg.name].update(held_to_unsharded(
            "4i (b)", mine, kept[cfg.name], out[cfg.name],
            serving[cfg.name]))
        del params
        out["launches"] = {k: _lib.LAUNCHES[k] for k in SERVING_KERNELS}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"kernel launches over phase 4i: {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"kernel {name} was never launched in phase 4i")
    return out


MESH_RESTORE = (2, 2)       # 4h (b): (data, model) of the CPU ranks' mesh


def crc_of(t) -> int:
    """zlib CRC-32 of a host tensor's bytes."""
    import zlib
    import torch
    return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def window_crcs(cfg, state: dict, mesh_shape: tuple) -> dict:
    """4h (b), expected: ``{"rank/key": crc32}`` of every rank's window of
    every leaf of ``state`` (the saved train state, on the card) under the
    Partitioner's layouts on a (data, model) mesh of ``mesh_shape``; the
    ranks' coordinates are row-major, as ``init_device_mesh``'s. Each
    distinct window is copied to the host and CRC'd once."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding.partition import Partitioner, window
    from repro_torch.train.steps import init_train_state
    t0 = time.perf_counter()
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    specs = {k: v.spec for k, v in flat_leaves(Partitioner(
        cfg, mesh).state_shardings(init_train_state(cfg, device="meta")))
        .items()}
    out: dict = {}
    for key, t in flat_leaves(state).items():
        seen: dict = {}
        for rank in range(mesh.size):
            coord = divmod(rank, mesh_shape[1])
            win = window(specs[key], mesh, tuple(t.shape), coord)
            if win not in seen:
                block = t
                for dim, (lo, hi) in enumerate(win):
                    block = block.narrow(dim, lo, hi - lo)
                seen[win] = crc_of(block.cpu())
            out[f"{rank}/{key}"] = seen[win]
    log(f"4h (b) window CRCs of the saved state's {len(specs)} leaves on a "
        f"{mesh_shape[0]}x{mesh_shape[1]} mesh in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def cpu_mesh_restore(cfg, root: str, want: dict) -> dict:
    """Phase 4h (b): 4 CPU processes on a gloo group restore the
    checkpoint under ``root`` (4f's full xlstm-350m, step 2) onto a 2x2
    mesh through ``restore(shardings=)``, each reading its windows only;
    each reports its bytes, wall and a CRC of every local block, checked
    against ``want`` (``window_crcs`` of the saved state). Reads only."""
    world = MESH_RESTORE[0] * MESH_RESTORE[1]
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    reports = [os.path.join(root + f".rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-restore-rank",
         str(r), "--world", str(world), "--port", str(port), "--ckpt", root,
         "--report", reports[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        fail(f"4h (b) ranks exited {[p.returncode for p in procs]}:\n"
             + "\n".join(log[-2000:] for log in logs))
    ranks = []
    for r, path in enumerate(reports):
        with open(path) as f:
            rep = json.load(f)
        os.remove(path)
        bad = [k for k, crc in rep.pop("crcs").items()
               if want.get(f"{r}/{k}") != crc]
        if bad or len(want) != world * rep["keys"]:
            fail(f"4h (b) rank {r}: {len(bad)} local blocks differ from "
                 f"their windows of the saved state, e.g. {bad[:3]}")
        ranks.append(rep)
        log(f"4h (b) rank {r}: {rep['keys']} local blocks, {rep['bytes']} B "
            f"of windows, restore wall {rep['wall_s']:.3f} s (read stall "
            f"{rep['read_stall_s']:.3f} s, peak staged "
            f"{rep['peak_staged_bytes']} B); every CRC equal to its "
            f"window's")
    total = sum(r["bytes"] for r in ranks)
    log(f"4h (b) {cfg.name} step 2 onto a {MESH_RESTORE[0]}x"
        f"{MESH_RESTORE[1]} gloo mesh of CPU ranks: {total} B of windows "
        f"over {world} ranks in {wall:.1f} s (processes included)")
    return dict(ranks=ranks, wall_s=wall)


def mesh_restore_rank(args) -> None:
    """One CPU rank of 4h (b) (this script with ``--mesh-restore-rank``)."""
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import Partitioner
    from repro_torch.train.steps import init_train_state
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{args.port}", rank=args.mesh_restore_rank,
                            world_size=args.world)
    try:
        mesh = make_host_mesh(*MESH_RESTORE, device="cpu")
        cfg = get_config(XLSTM_ARCH)
        meta = init_train_state(cfg, device="meta")
        layouts = {"train/" + k: v for k, v in flat_leaves(
            Partitioner(cfg, mesh).state_shardings(meta)).items()}
        t0 = time.perf_counter()
        with CheckpointManager(args.ckpt, device="cpu") as mgr:
            got = mgr.restore({"train": meta}, step=2, shardings=layouts)
            rm = mgr.last_restore_metrics
        wall = time.perf_counter() - t0
        blocks = local_leaves(got["train"])
        rep = dict(crcs={k: crc_of(v) for k, v in blocks.items()},
                   keys=len(blocks), wall_s=wall,
                   read_stall_s=rm.read_stall_seconds,
                   peak_staged_bytes=rm.peak_staged_bytes,
                   bytes=sum(v.numel() * v.element_size()
                             for v in blocks.values()))
        with open(args.report, "w") as f:
            json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def mesh_cli() -> dict:
    """Phase 4h (c): ``python -m repro_torch.launch.train --mesh 1x1
    --steps 2 --ckpt-every 0`` (reduced xlstm-350m, the default) on the
    card, run directly: its own 1-rank NCCL group. Its loss must be
    finite."""
    import math
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh", "1x1",
         "--steps", "2", "--ckpt-every", "0"], env=env, cwd=HERE,
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"4h (c) CLI exited {run.returncode}:\n{run.stdout[-2000:]}\n"
             f"{run.stderr[-4000:]}")
    summary = [ln for ln in run.stdout.splitlines() if ln.startswith("arch=")]
    loss = [ln for ln in run.stdout.splitlines() if ln.startswith("loss:")]
    if not summary or "device=cuda mesh=1x1" not in summary[0] or not loss \
            or not all(math.isfinite(float(x)) for x in
                       loss[0].split()[1::2]):
        fail(f"4h (c) CLI printed {summary} {loss}")
    log(f"4h (c) CLI on a 1x1 cuda mesh: {summary[0]}; {loss[0]} in "
        f"{seconds:.1f} s (process included)")
    return dict(seconds=seconds, summary=summary[0], loss=loss[0])


def moe_serve() -> tuple[dict, dict]:
    """Phase 4g: full-width olmoe-1b-7b (16 layers, 64 experts, top-8,
    6.92 B params), initialised on the card, cast to bf16 and never
    checkpointed, served with ``SERVE_SHAPE`` requests twice: at capacity
    factor ``MOE_GATED_CAPACITY`` under the ``SERVE_TOL`` yardstick (no
    drops, so prefill and decode route alike), then at the config's own
    factor with the ratio reported only (the prefill's 512 tokens get 80
    slots per expert, decode's 8 tokens 8, so they may route apart). Then
    phase 4j (a) serves the same params on a 1x1 mesh
    (``moe_mesh_serve``). Returns 4g's and 4j (a)'s measurements."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L, transformer as T
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = T.cast_params(T.init_params(cfg, seed=0, device="cuda"),
                           L.dtype_of(cfg))
    torch.cuda.synchronize()
    nbytes = state_bytes(flat_leaves(params))
    out = dict(params_bytes=nbytes, init_s=time.perf_counter() - t0)
    log(f"4g {cfg.name}: {cfg.num_layers} layers, {cfg.num_experts} "
        f"experts, top-{cfg.experts_per_token}, d_model {cfg.d_model}; "
        f"initialised on the card in {out['init_s']:.3f} s ({nbytes} B of "
        f"params)")
    gated = cfg.replace(moe_capacity_factor=MOE_GATED_CAPACITY)
    kept: dict = {}
    out["capacity_gated"] = serve_requests(
        gated, params, "cuda", phase=f"4g (capacity {MOE_GATED_CAPACITY})",
        keep=kept)
    out["capacity_config"] = serve_requests(
        cfg, params, "cuda", phase=f"4g (capacity "
        f"{cfg.moe_capacity_factor})", gate=False)
    t0 = time.perf_counter()
    on_mesh = moe_mesh_serve(gated, params, kept, out["capacity_gated"])
    log(f"4j (a): {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out, on_mesh


def moe_mesh_serve(cfg, params, kept: dict, plain: dict,
                   device: str = "cuda") -> dict:
    """Phase 4j (a), expert-parallel MoE served on a 1-rank NCCL group and
    ``make_host_mesh(1, 1)``: 4g's bf16 params distributed to the serve
    layouts (the Partitioner's, as ``serve_specs``'; every expert stack
    split over ``model``: on one rank, no copy), 4g's requests at capacity
    ``MOE_GATED_CAPACITY`` prefilled and decoded through ``moe_apply``'s
    mesh path. Gates: decode vs prefill within ``SERVE_TOL`` and the greedy
    tokens equal to 4g's; the last prompt logits' largest difference from
    4g's, prefill ms, decode ms per step beside 4g's and peak memory are
    reported. (``device="cpu"`` rehearses it on a gloo group.)"""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import Partitioner, shard_tree
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=device)
        dparams = shard_tree(params, Partitioner(cfg, mesh).param_shardings(
            params))
        wg = dparams["blocks"]["b0_attn"]["moe"]["wg"]
        log(f"4j (a) {cfg.name} expert stacks at {tuple(wg.placements)}, "
            f"local {tuple(wg.to_local().shape)}")
        mine: dict = {}
        out = serve_requests(cfg, dparams, device, phase="4j (a)",
                             mesh=mesh, keep=mine)
        out.update(held_to_unsharded("4j (a)", mine, kept, out, plain,
                                     against="4g"))
        was = MOE_MESH_BEFORE["4j (a)"]
        log(f"4j (a) beside the earlier slices' runs: prefill "
            f"{out['prefill_s'] * 1e3:.2f} ms (then {was['prefill_ms'][0]}–"
            f"{was['prefill_ms'][1]}), decode median "
            f"{out['decode_median_ms']:.2f} ms per step (then "
            f"{was['decode_median_ms'][0]}–{was['decode_median_ms'][1]}), "
            f"peak {out['peak_device_bytes']} B (then "
            f"{was['peak_device_bytes']})")
        del dparams
    finally:
        dist.destroy_process_group()
    return out


def moe_mesh_train(cfg=None, device: str = "cuda") -> dict:
    """Phase 4j (b), expert-parallel MoE trained: olmoe-1b-7b at full
    width (64 experts of 2048 x 1024, top-8) cut to ``MOE_TRAIN_LAYERS``
    layers so that its train state (reckoned on ``meta`` and printed
    beside full depth's) fits the card beside its grads and activations.
    Two ``Trainer`` steps unsharded, then two from the same seed with
    ``mesh=make_host_mesh(1, 1)`` on a 1-rank NCCL group (nothing is
    written); each mesh loss within 1e-4 relative of the unsharded one.
    Step walls and peak memory of both runs are reported. (A narrow
    ``cfg`` and ``device="cpu"`` rehearse it on a gloo group.)"""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    full = get_config(MOE_ARCH)
    cfg = cfg or moe_train_config()
    cuda = device == "cuda"
    total = state_bytes(flat_leaves(init_train_state(cfg, device="meta")))
    whole = state_bytes(flat_leaves(init_train_state(full, device="meta")))
    out: dict = {"layers": cfg.num_layers, "state_bytes": total,
                 "full_depth_state_bytes": whole}
    log(f"4j (b) {cfg.name} training: {cfg.num_layers} of "
        f"{full.num_layers} layers, every width kept; train state {total} B "
        f"(full depth {whole} B); batch {TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]} "
        f"tokens")
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]

    def two_steps(tag: str, mesh=None) -> dict:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, TrainerConfig(steps=2, ckpt_every=0,
                                             log_every=1, seed=0),
                          device=device, mesh=mesh)
        try:
            res = trainer.run()
        finally:
            trainer.close()
        finite_losses(res, [0, 1])
        run = dict(steps=log_steps(tag, res, tokens),
                   peak_device_bytes=torch.cuda.max_memory_allocated()
                   if cuda else None)
        if cuda and mesh is not None:
            run["memory"] = step_peak(trainer, res["state"], 2, "4j (b)")
        del res
        return run

    out["unsharded"] = two_steps("4j (b) unsharded")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        out["mesh"] = two_steps("4j (b) 1x1 mesh",
                                make_host_mesh(1, 1, device=device))
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    diffs = []
    for m, u in zip(out["mesh"]["steps"], out["unsharded"]["steps"]):
        rel = abs(m["loss"] - u["loss"]) / abs(u["loss"])
        diffs.append(rel)
        if rel > 1e-4:
            fail(f"4j (b) step {m['step']} loss {m['loss']} on the mesh is "
                 f"{rel:.2e} from the unsharded {u['loss']} (limit 1e-4 "
                 f"relative)")
    out["loss_rel_diff"] = diffs
    was = MOE_MESH_BEFORE["4j (b)"]["peak_device_bytes"]
    peak = out["mesh"]["peak_device_bytes"]
    if cuda and peak > was * (1 + MOE_PEAK_SLACK):
        fail(f"4j (b)'s peak on the mesh, {peak} B, is more than "
             f"{MOE_PEAK_SLACK:.0%} above the earlier slices' {was} B")
    log(f"4j (b) losses within {max(diffs):.2e} relative of the unsharded "
        f"run's (limit 1e-4); step walls on the mesh "
        + " / ".join(f"{m['seconds']:.3f}" for m in out["mesh"]["steps"])
        + " s vs unsharded "
        + " / ".join(f"{m['seconds']:.3f}" for m in out["unsharded"]["steps"])
        + f" s; peak device memory {out['mesh']['peak_device_bytes']} B vs "
        f"{out['unsharded']['peak_device_bytes']} B (the mesh's before: "
        f"{MOE_MESH_BEFORE['4j (b)']['peak_device_bytes']} B)")
    return out


def moe_train_config():
    """4j (b)'s model: olmoe-1b-7b at full width, ``MOE_TRAIN_LAYERS`` of
    its 16 layers."""
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).replace(num_layers=MOE_TRAIN_LAYERS)


# ------------------------------------------------------------ phase 4l
def xlstm_mesh(cfg=None, device: str = "cuda") -> dict:
    """Phase 4l, the xLSTM blocks split over ``model``: xlstm-350m at full
    width and depth (``cfg``: the CLI's default arch, weights of seed 0 in
    its bf16), unsharded and then on a 1-rank NCCL group and
    ``make_host_mesh(1, 1)`` (nothing is written): (a) one prefill of 8 x
    255 seeded tokens (``TRAIN_SHAPE``'s), the last position's greedy
    tokens equal to the unsharded run's; (b) ``SERVE_SHAPE``'s requests
    through ``serve_requests`` (prefill, then ``generate`` through the
    mLSTM and sLSTM caches at ``serve_cache_layouts``), the greedy tokens
    equal to the unsharded run's; (c) two ``Trainer`` steps from seed 0
    unsharded, then two on the mesh, each loss within 1e-5 relative, and a
    warm third step on the mesh whose peak the dry run predicts. On the
    mesh the mLSTM core and the sLSTM recurrence run ``_mlstm_block`` and
    ``_slstm_local`` on local blocks (a model axis of one rank exchanges
    nothing). Prefill ms, decode ms per step and step walls are printed
    beside the unsharded ones. (A narrow ``cfg`` and ``device="cpu"``
    rehearse it on a gloo group.)"""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.partition import Layout, Partitioner, \
        shard_tree
    from repro_torch.train.steps import make_prefill_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = cfg or get_config(XLSTM_ARCH)
    cuda = device == "cuda"
    B, S = TRAIN_SHAPE[:2]
    log(f"4l {cfg.name}: {cfg.num_layers} of 24 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} mLSTM heads, {cfg.dtype}; prefill "
        f"{B} x {S} tokens, {SERVE_SHAPE[0]} requests served, 2 Trainer "
        f"steps of {B} x {S} tokens, unsharded and on a 1x1 mesh")
    params = T.cast_params(T.init_params(cfg, seed=0, device=device),
                           L.dtype_of(cfg))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=device)
    out: dict = {}

    def prefill(p, toks, act=None) -> tuple[torch.Tensor, float]:
        sync(toks.device)
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg, act_sharding=act)(
            p, {"tokens": toks})
        sync(toks.device)
        wall = time.perf_counter() - t0
        logits = logits.full_tensor() if act is not None else logits
        if not bool(torch.isfinite(logits).all()):
            fail(f"4l: non-finite prefill logits ({'mesh' if act else ''})")
        return logits.float().cpu(), wall

    def two_steps(tag: str, mesh=None) -> dict:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, TrainerConfig(steps=2, ckpt_every=0,
                                             log_every=1, seed=0),
                          device=device, mesh=mesh)
        try:
            res = trainer.run()
        finally:
            trainer.close()
        finite_losses(res, [0, 1])
        run = dict(steps=log_steps(tag, res, B * S),
                   peak_device_bytes=torch.cuda.max_memory_allocated()
                   if cuda else None)
        if cuda and mesh is not None:
            run["memory"] = step_peak(trainer, res["state"], 2, "4l (c)")
        del res
        return run

    plain_logits, plain_s = prefill(params, tokens)
    kept: dict = {}
    plain = serve_requests(cfg, params, device, phase="4l (b) unsharded",
                           gate=False, keep=kept)
    out["unsharded"] = two_steps("4l (c) unsharded")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=device)
        part = Partitioner(cfg, mesh)
        dparams = shard_tree(params, part.param_shardings(params))
        act = Layout(mesh, part.activation_spec(B))
        logits, mesh_s = prefill(dparams, part.tokens_sharding(B)
                                 .distribute(tokens), act)
        if not bool(torch.equal(logits.argmax(-1), plain_logits.argmax(-1))):
            fail("4l (a): the prefill's greedy tokens on the mesh differ "
                 "from the unsharded run's")
        diff = float((logits - plain_logits).abs().max())
        out["prefill"] = dict(mesh_ms=mesh_s * 1e3, unsharded_ms=plain_s
                              * 1e3, logits_max_abs_diff=diff)
        log(f"4l (a) prefill of {B} x {S} tokens: {mesh_s * 1e3:.2f} ms on "
            f"the mesh vs {plain_s * 1e3:.2f} ms unsharded (each model's "
            f"first call); greedy tokens equal, last logits within "
            f"{diff:.3e}")
        mine: dict = {}
        out["serve"] = serve_requests(cfg, dparams, device, phase="4l (b)",
                                      gate=False, mesh=mesh, keep=mine)
        out["serve"].update(held_to_unsharded("4l (b)", mine, kept,
                                              out["serve"], plain,
                                              against="4l (b) unsharded"))
        out["serve_unsharded"] = plain
        del dparams
        out["mesh"] = two_steps("4l (c) 1x1 mesh", mesh)
    finally:
        dist.destroy_process_group()
    del params
    if cuda:
        torch.cuda.empty_cache()
    diffs = []
    for m, u in zip(out["mesh"]["steps"], out["unsharded"]["steps"]):
        rel = abs(m["loss"] - u["loss"]) / abs(u["loss"])
        diffs.append(rel)
        if rel > 1e-5:
            fail(f"4l (c) step {m['step']} loss {m['loss']} on the mesh is "
                 f"{rel:.2e} from the unsharded {u['loss']} (limit 1e-5 "
                 f"relative)")
    out["loss_rel_diff"] = diffs
    log(f"4l (c) losses within {max(diffs):.2e} relative of the unsharded "
        f"run's (limit 1e-5); step walls on the mesh "
        + " / ".join(f"{m['seconds']:.3f}" for m in out["mesh"]["steps"])
        + " s vs unsharded "
        + " / ".join(f"{m['seconds']:.3f}" for m in out["unsharded"]["steps"])
        + f" s; peak device memory {out['mesh']['peak_device_bytes']} B vs "
        f"{out['unsharded']['peak_device_bytes']} B")
    return out


# ------------------------------------------------------------ phase 4m
def ce_config():
    """4m's model: qwen2.5-3b at full width and vocab, ``CE_LAYERS`` of its
    36 layers."""
    from repro_torch.configs import get_config
    return get_config(CE_ARCH).replace(num_layers=CE_LAYERS)


def old_chunked_cross_entropy(params, cfg, h, labels, chunk: int):
    """The loss before it split over ``model``, on plain tensors: the table
    cast again for every chunk, then ``logsumexp`` and the gold logit's
    ``gather`` (the composition ``token_nll`` replaced)."""
    import torch
    from repro_torch.models import transformer as T
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a in range(0, h.shape[1], chunk):
        logits = T._unembed(params, cfg, h[:, a:a + chunk])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, a:a + chunk].long()
                            [..., None])[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (h.shape[0] * h.shape[1])


def ce_mesh(cfg=None, device: str = "cuda") -> dict:
    """Phase 4m, the train step's loss split over ``model``: ``cfg``
    (``ce_config``: qwen2.5-3b at full width and vocab, 2 layers, bf16,
    weights of seed 0; nothing written). (a) Three steps of
    ``make_train_step(microbatches=2)`` on one seeded batch of
    ``CE_SHAPE`` (4 x 4096 tokens), unsharded and on a 1-rank NCCL group
    and ``make_host_mesh(1, 1)``: every loss equal to the last bit, and
    the last (warm) step's peak on the mesh against the dry run's "4m"
    cell. (b) ``token_nll`` against the plain ``cross_entropy`` on one
    chunk's (2, 512, 151936) float32 logits: the mean within ``CE_TOL``
    relative, the logits' grad within ``CE_TOL`` of its largest value;
    forward + backward ms of the two, and of a microbatch's whole loss
    (``chunked_cross_entropy``: unembed, the Function, its backward)
    beside the composition it replaced (``old_chunked_cross_entropy``).
    (A narrow ``cfg`` and ``device="cpu"`` rehearse it on a gloo
    group.)"""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dryrun import act_layout, storages
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.sharding.partition import Partitioner, shard_tree
    from repro_torch.train.steps import (CE_CHUNK, chunked_cross_entropy,
                                         cross_entropy, init_train_state,
                                         make_train_step, token_nll)
    cfg = cfg or ce_config()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    B, S = CE_SHAPE
    M = CE_MICROBATCHES
    rng = np.random.default_rng(4)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    log(f"4m {cfg.name}: {cfg.num_layers} of 36 layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; 3 steps of "
        f"{B} x {S} tokens in {M} microbatches, unsharded and on a 1x1 mesh")
    out: dict = {}

    def three_steps(tag: str, mesh=None) -> dict:
        release(dev)
        state = init_train_state(cfg, seed=0, device=device)
        b, kw = batch, {}
        if mesh is not None:
            part = Partitioner(cfg, mesh)
            sh = part.state_shardings(state)
            state = shard_tree(state, sh)
            tok = part.tokens_sharding(B)
            b = {k: tok.distribute(v) for k, v in batch.items()}
            kw = dict(grad_shardings=sh["opt"]["mu"],
                      act_sharding=act_layout(cfg, mesh, B // M))
        step = make_train_step(cfg, microbatches=M, **kw)
        run: dict = dict(losses=[], step_s=[], memory=None)
        for i in range(3):
            warm = i == 2 and cuda
            sync(dev)
            if warm:
                args = sum(storages((state, b)).values())
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = float(step(state, b)[1]["loss"])
            sync(dev)
            run["step_s"].append(time.perf_counter() - t0)
            if warm:
                peak = torch.cuda.max_memory_allocated()
                run["memory"] = dict(
                    max_memory_allocated=peak, allocated_before=before,
                    argument_bytes=args, resident_bytes=before - args,
                    step_peak_bytes=peak - (before - args))
            if not math.isfinite(loss):
                fail(f"4m (a) {tag} step {i} loss {loss}")
            run["losses"].append(loss)
        del state, b
        release(dev)
        log(f"4m (a) {tag}: losses " + ", ".join(
            f"{x!r}" for x in run["losses"]) + "; step walls " + " / ".join(
            f"{t:.3f}" for t in run["step_s"]) + " s" + (
            f"; warm step's own peak {run['memory']['step_peak_bytes']} B"
            if run["memory"] else ""))
        return run

    out["unsharded"] = three_steps("unsharded")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        out["mesh"] = three_steps("1x1 mesh", make_host_mesh(1, 1,
                                                            device=device))
    finally:
        dist.destroy_process_group()
    if out["mesh"]["losses"] != out["unsharded"]["losses"]:
        fail(f"4m (a): the 1x1 mesh's losses {out['mesh']['losses']} differ "
             f"from the unsharded {out['unsharded']['losses']}")

    # (b) the Function against the composition, and the loss's time
    params = T.cast_params(T.init_params(cfg, seed=0, device=device),
                           L.dtype_of(cfg))
    key = "embed" if cfg.tie_embeddings else "head"
    head = {k: params[k] for k in ("final_norm", key)}
    del params
    n = B // M
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    h = torch.randn(n, S, cfg.d_model, generator=gen, device=dev).to(
        L.dtype_of(cfg))
    labels = batch["labels"][:n]
    with torch.no_grad():
        logits = T._unembed(head, cfg, h[:, :CE_CHUNK])
    first = labels[:, :CE_CHUNK]

    def ce_grad(fn):
        x = logits.detach().requires_grad_(True)
        loss = fn(x)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    def composition(x):
        return cross_entropy(x, first)

    def function(x):
        return torch.mean(token_nll(x, first))

    want, g_want = ce_grad(composition)
    got, g_got = ce_grad(function)
    loss_rel = abs(float(got) - float(want)) / abs(float(want))
    grad_err = float((g_got - g_want).abs().max()) / float(
        g_want.abs().max())
    del g_got, g_want
    if loss_rel > CE_TOL or grad_err > CE_TOL:
        fail(f"4m (b): token_nll {float(got)!r} against cross_entropy "
             f"{float(want)!r} ({loss_rel:.3e} relative), the logits' grad "
             f"{grad_err:.3e} of the largest (limit {CE_TOL:.0e})")

    def whole_loss(fn):
        hh = h.detach().requires_grad_(True)
        t = head[key].detach().requires_grad_(True)
        loss = fn({**head, key: t}, cfg, hh, labels)
        torch.autograd.grad(loss, (hh, t))

    timer = cuda_ms if cuda else (lambda fn, reps: float("nan"))
    out["check"] = dict(loss_rel_diff=loss_rel, grad_max_err=grad_err,
                        logits_shape=list(logits.shape))
    out["ms"] = dict(
        chunk_function=timer(lambda: ce_grad(function), 10),
        chunk_composition=timer(lambda: ce_grad(composition), 10),
        microbatch_loss=timer(lambda: whole_loss(chunked_cross_entropy), 5),
        microbatch_old_loss=timer(lambda: whole_loss(
            lambda *a: old_chunked_cross_entropy(*a, CE_CHUNK)), 5))
    ms = out["ms"]
    log(f"4m (b) token_nll against cross_entropy on {tuple(logits.shape)} "
        f"float32 logits: mean {loss_rel:.3e} relative, grad {grad_err:.3e} "
        f"of the largest (limit {CE_TOL:.0e}); forward + backward "
        f"{ms['chunk_function']:.4f} ms vs {ms['chunk_composition']:.4f} ms "
        f"the composition; a microbatch's loss ({n} x {S} tokens, "
        f"{S // CE_CHUNK} chunks with the unembed) {ms['microbatch_loss']:.4f}"
        f" ms vs {ms['microbatch_old_loss']:.4f} ms before the split")
    del head, h, logits
    release(dev)
    return out


# ------------------------------------------------------------ phase 4k
def mesh_writers(cfg, root: str, tally: WriteTally,
                 device: str = "cuda") -> dict:
    """Phase 4k, the slice's path: ``Trainer(mesh=make_host_mesh(1, 1),
    ckpt_writers=WRITERS, async_ckpt=True)`` on a 1-rank NCCL group (the
    Trainer's own gloo group carries the commits) for ``cfg``, xlstm-350m
    at full width. (a) Steps 0-2, step 2 saved through the writer threads
    over the rank's local blocks (each leaf digested with B3 as the save
    is called), step 3 in place right after ``wait_snapshotted()``; then
    a step 3 of the same state outside the Trainer (the uninterrupted
    run's). (b) A fresh mesh Trainer with the same writers resumes step 2
    (every local block's digest equal to the save's) and reruns steps 2
    and 3: losses equal to (a)'s to the last bit. (c) A single-writer
    ``CheckpointManager`` on the card restores the same step: the same
    digests. (A narrow ``cfg`` and ``device="cpu"`` rehearse it on a gloo
    group; B3 does not launch there, so only the launch check fails.)"""
    import torch
    import torch.distributed as dist
    from repro_torch.core import CheckpointManager, MultiWriterCheckpointer
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    meta = init_train_state(cfg, device="meta")
    total = state_bytes(flat_leaves(meta))
    out: dict = {"layers": cfg.num_layers, "writers": WRITERS,
                 "state_bytes": total}
    log(f"4k {cfg.name}: {cfg.num_layers} of 24 layers, every width kept; "
        f"train state {total} B; {WRITERS} writer threads on a 1x1 {device} "
        f"mesh; batch {B} x {S} tokens")
    shutil.rmtree(root, ignore_errors=True)
    dev = torch.device(device)
    release(dev)
    _lib.reset_launches()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=device)

        def trainer(steps, every):
            return Trainer(cfg, TrainerConfig(
                steps=steps, ckpt_every=every, ckpt_dir=root,
                async_ckpt=True, ckpt_writers=WRITERS, keep=1, log_every=1,
                seed=0), device=device, mesh=mesh)

        t1 = trainer(3, 2)
        if not isinstance(t1.ckpt, MultiWriterCheckpointer) or \
                t1.ckpt.group.num_ranks != WRITERS:
            fail(f"4k: the mesh Trainer built {type(t1.ckpt).__name__}")
        saved: dict = {}
        save = t1.ckpt.save

        def digesting_save(step, state):
            saved[step] = digests(local_leaves(state["train"]))
            return save(step, state)

        t1.ckpt.save = digesting_save
        try:
            r1 = t1.run()
            losses = finite_losses(r1, [0, 1, 2])
            t0 = time.perf_counter()
            losses.append(mesh_step(t1, r1["state"], 3))
            step3_s = time.perf_counter() - t0
        finally:
            t1.close()
        snap = r1["ckpt_snapshot_wait_seconds"]
        out["steps"] = log_steps("4k (a)", r1, B * S)
        log(f"  4k (a) step 3 (outside the Trainer): {step3_s:.3f} s, loss "
            f"{losses[3]:.4f}")
        del r1
        written = du(root)
        tally.add("4k multi-writer checkpoint", written)
        sm = t1.save_log[0]
        step_dir = os.path.join(root, "step_00000002")
        ranks = sorted(n for n in os.listdir(step_dir)
                       if n.startswith("MANIFEST.rank-"))
        if list(saved) != [2] or len(ranks) != WRITERS or \
                sm.num_ranks != WRITERS:
            fail(f"4k saved {list(saved)} with rank manifests {ranks}")
        writers = [dict(rank=r, total_bytes=pm.total_bytes,
                        wall_s=pm.end_to_end_seconds,
                        flush_s=pm.flush_seconds)
                   for r, pm in enumerate(sm.per_rank)]
        out["save"] = dict(
            wall_s=sm.end_to_end_seconds, blocking_s=sm.blocking_seconds,
            snapshot_wait_s=snap, total_bytes=sm.total_bytes,
            on_disk_bytes=written, aggregate_gbps=sm.aggregate_gbps,
            writers=writers)
        log(f"4k (a) async save of step 2 through {WRITERS} writer threads: "
            f"wall {sm.end_to_end_seconds:.3f} s, blocking "
            f"{sm.blocking_seconds:.3f} s, wait_snapshotted() "
            f"{out['save']['snapshot_wait_s']:.3f} s, {sm.total_bytes} B at "
            f"{sm.aggregate_gbps:.3f} GB/s aggregate")
        for w in writers:
            log(f"  writer {w['rank']}: {w['total_bytes']} B, wall "
                f"{w['wall_s']:.3f} s, flush {w['flush_s']:.3f} s")
        out["losses"] = losses

        t2 = trainer(4, 5)      # checkpoints every 5: nothing written
        try:
            state, start = t2.initial_state()
            got = digests(local_leaves(state))
            bad = [k for k in saved[2] if not torch.equal(got[k],
                                                          saved[2][k])]
            if start != 2 or got.keys() != saved[2].keys() or bad:
                fail(f"4k (b) resumed step {start}; leaves differing from "
                     f"the save: {bad[:3]}")
            r2 = t2.run((state, start))
        finally:
            t2.close()
        del state
        rerun = finite_losses(r2, [2, 3])
        out["resumed_steps"] = log_steps("4k (b)", r2, B * S)
        del r2
        if rerun != losses[2:]:
            fail(f"4k (b) reran steps 2 and 3 with losses {rerun!r}, (a) "
                 f"had {losses[2:]!r}")
        out["resume"] = dict(
            restore_s=t2.restore_attr["restore_seconds"],
            read_stall_s=t2.restore_attr.get("restore_read_stall_s"),
            losses=rerun)
        log(f"4k (b) resumed step 2 in {out['resume']['restore_s']:.3f} s "
            f"(read stall {out['resume']['read_stall_s']:.3f} s), "
            f"{len(got)} local blocks' digests equal to the save's; steps 2 "
            f"and 3 rerun with losses {rerun} equal to (a)'s to the last bit")
    finally:
        dist.destroy_process_group()
    release(dev)
    with CheckpointManager(root, device=dev) as mgr:
        sync(dev)
        t0 = time.perf_counter()
        plain = mgr.restore(state_template={"train": meta, "data": None},
                            step=2)
        sync(dev)
        wall = time.perf_counter() - t0
        rm = mgr.last_restore_metrics
    got = digests(plain["train"])
    del plain
    bad = [k for k in saved[2] if not torch.equal(got[k], saved[2][k])]
    if got.keys() != saved[2].keys() or bad:
        fail(f"4k (c) single-writer restore differs at {bad[:3]}")
    out["single_writer_restore"] = dict(wall_s=wall,
                                        read_stall_s=rm.read_stall_seconds)
    out["launches"] = {k: _lib.LAUNCHES[k] for k in XLSTM_KERNELS}
    log(f"4k (c) a single-writer CheckpointManager restored step 2 onto "
        f"the card in {wall:.3f} s (read stall {rm.read_stall_seconds:.3f} "
        f"s), every digest equal; kernel launches in 4k: {out['launches']}")
    for name, count in out["launches"].items():
        if count <= 0:
            fail(f"4k never launched {name}")
    shutil.rmtree(root, ignore_errors=True)
    release(dev)
    return out


# ------------------------------------------------- the dry run vs the card
def dryrun_cells(path: str) -> None:
    """Run ``measure_cell`` on a 1x1 fake mesh for 4h (a)'s, 4j (b)'s and
    4l's train steps (their configs, depths, batch and one microbatch) and
    4m's (its config, ``CE_SHAPE`` and ``CE_MICROBATCHES``), and
    the ``PRODUCTION_MOE``, ``PRODUCTION_GQA`` and ``PRODUCTION_XLSTM``
    cells on 16x16 in three processes beside them (one fake process group
    a process); the records go to ``path``. The run starts it as a process
    of its own (``meta`` tensors, no card)."""
    sys.path.insert(0, SRC)
    import multiprocessing

    import torch
    torch.set_num_threads(2)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _run_cell_args, measure_cell
    from repro_torch.models.config import ShapeConfig
    shape = ShapeConfig("train_smoke", TRAIN_SHAPE[1], TRAIN_SHAPE[0],
                        "train")
    out: dict = {"production": {}, "production_gqa": {},
                 "production_xlstm": {}}
    todo = PRODUCTION_MOE + PRODUCTION_GQA + PRODUCTION_XLSTM
    with multiprocessing.get_context("spawn").Pool(
            3, initializer=torch.set_num_threads, initargs=(1,),
            maxtasksperchild=1) as pool:
        cells = pool.imap(_run_cell_args, [(arch, name, False, True)
                                           for arch, name in todo])
        ce_shape = ShapeConfig("train_4m", CE_SHAPE[1], CE_SHAPE[0],
                               "train")
        for phase, cfg, sc, mb in (
                ("4h (a)", train_config(), shape, 1),
                ("4j (b)", moe_train_config(), shape, 1),
                ("4l", get_config(XLSTM_ARCH), shape, 1),
                ("4m", ce_config(), ce_shape, CE_MICROBATCHES)):
            t0 = time.perf_counter()
            rec = measure_cell(cfg, sc, (1, 1), ("data", "model"),
                               microbatches=mb)
            rec["wall_s"] = time.perf_counter() - t0
            out[phase] = rec
        for (arch, name), rec in zip(todo, cells):
            key = "production" if (arch, name) in PRODUCTION_MOE else \
                "production_xlstm" if (arch, name) in PRODUCTION_XLSTM \
                else "production_gqa"
            out[key][f"{arch} {name}"] = rec
    with open(path, "w") as f:
        json.dump(out, f)


def dryrun_vs_card(proc, path: str, measured: dict) -> dict:
    """Each dry-run peak (``dryrun_cells``, run beside the phases) against
    the step's own peak on the card (``step_peak``): within
    ``DRYRUN_TOL``."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or not os.path.exists(path):
        fail(f"the dry run of 4h (a), 4j (b), 4l and 4m exited "
             f"{proc.returncode}")
    with open(path) as f:
        recs = json.load(f)
    out = {}
    for phase, card in measured.items():
        rec = recs[phase]
        if rec["status"] != "ok":
            fail(f"dry run of {phase}: {rec.get('error')}")
        pd = rec["per_device"]
        want = card["step_peak_bytes"]
        ratio = pd["peak_hbm_bytes"] / want
        row = dict(predicted_peak_bytes=pd["peak_hbm_bytes"],
                   argument_bytes=pd["argument_bytes"],
                   output_bytes=pd["output_bytes"],
                   alias_bytes=pd["alias_bytes"],
                   temp_bytes=pd["temp_bytes"], card=card, ratio=ratio,
                   dryrun_wall_s=rec["wall_s"])
        out[phase] = row
        log(f"dry run vs card, {phase} ({rec['arch']}, 1x1, "
            f"{rec['shape']}, {rec['microbatches']} microbatch(es); "
            f"{rec['wall_s']:.1f} s on meta): predicted peak "
            f"{pd['peak_hbm_bytes']} B (argument {pd['argument_bytes']}, "
            f"output {pd['output_bytes']}, temp {pd['temp_bytes']}, alias "
            f"{pd['alias_bytes']}); card: the step's peak {want} B "
            f"(max_memory_allocated {card['max_memory_allocated']} B less "
            f"{card['resident_bytes']} B resident beside the arguments, "
            f"whose {card['argument_bytes']} B the dry run counts "
            f"{pd['argument_bytes']}); predicted / measured {ratio:.4f} "
            f"(limit 1 +- {DRYRUN_TOL})")
        if abs(ratio - 1) > DRYRUN_TOL:
            fail(f"the dry run's peak for {phase} is {ratio:.4f} of the "
                 f"card's")
    out["production"] = production_moe(recs["production"])
    out["production_gqa"] = production_gqa(recs["production_gqa"])
    out["production_xlstm"] = production_xlstm(recs["production_xlstm"])
    return out


def whole_vocab_gathers(rec: dict) -> list:
    """A train cell's all-gathers of a loss chunk's logits with the whole
    vocab (a data rank's rows x ``CE_CHUNK`` x V elements, or a last dim
    of V): none where the loss keeps the vocab split over ``model``."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    from repro_torch.train.steps import CE_CHUNK
    cfg, sc = get_config(rec["arch"]), SHAPES_BY_NAME[rec["shape"]]
    if sc.kind != "train":
        return []
    V = cfg.vocab_size
    rows = max(sc.global_batch // rec["microbatches"] // 16, 1)
    return [s for s in rec["per_device"]["all_gather_shapes"]
            if s[-1] == V or math.prod(s) == rows * CE_CHUNK * V]


def production_moe(recs: dict) -> dict:
    """The ``PRODUCTION_MOE`` cells' dry-run records on 16x16: peak,
    FLOPs and collective bytes by kind, per device, printed (the
    ``train_4k`` cells beside the parent's, ``PRODUCTION_MOE_BEFORE``); a
    cell that failed, a ``prefill_32k`` peak above ``CARD_BYTES``, or a
    ``train_4k`` all-gather of whole-vocab logits fails the run."""
    out = {}
    for cell, rec in recs.items():
        if rec["status"] != "ok":
            fail(f"dry run of {cell} on 16x16: {rec.get('error')}")
        pd = rec["per_device"]
        coll = {k: v for k, v in pd["collective_bytes"].items() if v}
        out[cell] = dict(peak_hbm_bytes=pd["peak_hbm_bytes"],
                         argument_bytes=pd["argument_bytes"],
                         temp_bytes=pd["temp_bytes"], flops=pd["flops"],
                         collective_bytes=coll,
                         all_gather_shapes=pd["all_gather_shapes"],
                         step_s=rec["step_s"])
        before = ""
        if cell in PRODUCTION_MOE_BEFORE:
            peak0, flops0, coll0 = PRODUCTION_MOE_BEFORE[cell]
            out[cell]["before"] = dict(peak_hbm_bytes=peak0, flops=flops0,
                                       collective_bytes=coll0)
            before = (f" (before the loss split: peak {peak0}, {flops0:.4e} "
                      f"FLOPs, " + ", ".join(
                          f"{k.replace('_', '-')} {v}"
                          for k, v in coll0.items()) + ")")
        log(f"dry run {cell} on 16x16 (per device, no card): peak "
            f"{pd['peak_hbm_bytes']} B (argument {pd['argument_bytes']}, "
            f"temp {pd['temp_bytes']}), {pd['flops']:.4e} FLOPs, collective "
            f"bytes " + ", ".join(f"{k} {v}" for k, v in coll.items())
            + before + f"; {rec['step_s']:.1f} s on meta")
        gathers = whole_vocab_gathers(rec)
        if gathers:
            fail(f"the dry run of {cell} all-gathers whole-vocab logits: "
                 f"{gathers}")
        if cell.endswith("prefill_32k") and \
                pd["peak_hbm_bytes"] > CARD_BYTES:
            fail(f"the dry run's peak for {cell} on 16x16, "
                 f"{pd['peak_hbm_bytes']} B, is over an 80 GB card")
    return out


def production_gqa(recs: dict) -> dict:
    """The ``PRODUCTION_GQA`` cells' dry-run records on 16x16: peak, FLOPs
    and collective bytes by kind, per device, printed beside the parent's
    (``PRODUCTION_GQA_BEFORE``); a cell that failed, a ``prefill_32k``
    peak above ``CARD_BYTES``, an all-gather of the whole (V, d) embedding
    table, a decode step that all-gathers ``DECODE_GATHER_LIMIT`` bytes
    or more, or a ``train_4k`` peak of ``CE_PEAK_LIMIT`` or more or an
    all-gather of its whole-vocab logits fails the run."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    out = {}
    for cell, rec in recs.items():
        if rec["status"] != "ok":
            fail(f"dry run of {cell} on 16x16: {rec.get('error')}")
        pd = rec["per_device"]
        coll = {k: v for k, v in pd["collective_bytes"].items() if v}
        peak0, flops0, coll0 = PRODUCTION_GQA_BEFORE[cell]
        cfg = get_config(rec["arch"])
        table = [s for s in pd["all_gather_shapes"] if len(s) == 2
                 and s[0] * s[1] == cfg.vocab_size * cfg.d_model]
        out[cell] = dict(peak_hbm_bytes=pd["peak_hbm_bytes"],
                         argument_bytes=pd["argument_bytes"],
                         temp_bytes=pd["temp_bytes"], flops=pd["flops"],
                         collective_bytes=coll,
                         all_gather_shapes=pd["all_gather_shapes"],
                         step_s=rec["step_s"],
                         before=dict(peak_hbm_bytes=peak0, flops=flops0,
                                     collective_bytes=coll0))
        log(f"dry run {cell} on 16x16 (per device, no card): peak "
            f"{pd['peak_hbm_bytes']} B (before {peak0:.4g}), "
            f"{pd['flops']:.4e} FLOPs (before {flops0:.4g}), collective "
            f"bytes " + ", ".join(f"{k} {v}" for k, v in coll.items())
            + " (before " + ", ".join(f"{k.replace('_', '-')} {v:.4g}"
                                      for k, v in coll0.items())
            + f"); {rec['step_s']:.1f} s on meta")
        if table:
            fail(f"the dry run of {cell} all-gathers the whole embedding "
                 f"table: {table}")
        gathers = whole_vocab_gathers(rec)
        if gathers:
            fail(f"the dry run of {cell} all-gathers whole-vocab logits: "
                 f"{gathers}")
        if rec["mode"] == "train" and pd["peak_hbm_bytes"] >= CE_PEAK_LIMIT:
            fail(f"the dry run's peak for {cell} on 16x16, "
                 f"{pd['peak_hbm_bytes']} B, is not under "
                 f"{CE_PEAK_LIMIT:.1e} (the loss split over model)")
        if rec["mode"] == "prefill" and pd["peak_hbm_bytes"] > CARD_BYTES:
            fail(f"the dry run's peak for {cell} on 16x16, "
                 f"{pd['peak_hbm_bytes']} B, is over an 80 GB card")
        if rec["mode"] == "decode" and \
                coll.get("all-gather", 0) >= DECODE_GATHER_LIMIT:
            fail(f"the dry run's decode step of {cell} all-gathers "
                 f"{coll['all-gather']} B a device (limit "
                 f"{DECODE_GATHER_LIMIT:.0f})")
    return out


def production_xlstm(recs: dict) -> dict:
    """The ``PRODUCTION_XLSTM`` cell's dry-run record on 16x16: peak, FLOPs
    and collective bytes by kind, per device, printed beside the parent's
    (``PRODUCTION_XLSTM_BEFORE``). A failed cell, FLOPs over
    ``XLSTM_FLOPS_LIMIT``, a peak over ``XLSTM_PEAK_LIMIT``, an all-gather
    of a whole (d, d) or (d, 4d) sLSTM gate weight, or all-gathers of v's
    size with every head beyond u1's one an mLSTM block (v, q or k made
    whole) fails the run."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME
    out = {}
    for cell, rec in recs.items():
        if rec["status"] != "ok":
            fail(f"dry run of {cell} on 16x16: {rec.get('error')}")
        pd = rec["per_device"]
        coll = {k: v for k, v in pd["collective_bytes"].items() if v}
        peak0, flops0, coll0 = PRODUCTION_XLSTM_BEFORE[cell]
        cfg, sc = get_config(rec["arch"]), SHAPES_BY_NAME[rec["shape"]]
        d = cfg.d_model
        weights = [s for s in pd["all_gather_shapes"]
                   if len(s) == 2 and s[0] * s[1] in (d * d, 4 * d * d)]
        v = sc.global_batch // 16 * sc.seq_len * int(cfg.proj_factor * d)
        whole_v = sum(n for k, n in pd["all_gather_counts"].items()
                      if math.prod(int(x) for x in k.split("x")) == v)
        mlstm = cfg.num_layers // len(cfg.block_pattern)
        out[cell] = dict(peak_hbm_bytes=pd["peak_hbm_bytes"],
                         argument_bytes=pd["argument_bytes"],
                         temp_bytes=pd["temp_bytes"], flops=pd["flops"],
                         collective_bytes=coll,
                         all_gather_counts=pd["all_gather_counts"],
                         step_s=rec["step_s"],
                         before=dict(peak_hbm_bytes=peak0, flops=flops0,
                                     collective_bytes=coll0))
        log(f"dry run {cell} on 16x16 (per device, no card): peak "
            f"{pd['peak_hbm_bytes']} B (before {peak0}), "
            f"{pd['flops']:.4e} FLOPs (before {flops0:.4e}), collective "
            f"bytes " + ", ".join(f"{k} {v}" for k, v in coll.items())
            + " (before " + ", ".join(f"{k.replace('_', '-')} {v}"
                                      for k, v in coll0.items())
            + f"); all-gathers of v's size with every head {whole_v} (u1's,"
            f" one for each of {mlstm} mLSTM blocks); {rec['step_s']:.1f} s "
            f"on meta")
        if pd["flops"] > XLSTM_FLOPS_LIMIT or \
                pd["peak_hbm_bytes"] > XLSTM_PEAK_LIMIT:
            fail(f"the dry run of {cell} on 16x16: {pd['flops']:.4e} FLOPs "
                 f"(limit {XLSTM_FLOPS_LIMIT:.1e}), peak "
                 f"{pd['peak_hbm_bytes']} B (limit {XLSTM_PEAK_LIMIT:.1e})")
        if weights or whole_v != mlstm:
            fail(f"the dry run of {cell} all-gathers whole gate weights "
                 f"{weights} or {whole_v} tensors of v's size with every "
                 f"head (u1's: {mlstm})")
    return out


CHAOS_SEEDS = (0, 42)              # the gate seeds of the JAX package's
CHAOS_MIN_FAULTS = 200             # tests/chaos/campaign.py
# every kind class that must fire across the gate run (prefixes of
# CampaignStats.by_kind), the JAX package's gate list
REQUIRED_KINDS = ("crash:", "torn:", "short:", "errno:", "corrupt:",
                  "crash:gather", "errno:gather",
                  "crash:rput", "errno:rget", "stall:rget", "short:rget",
                  "corrupt:remote")


def chaos_gate(root: str, tally: WriteTally) -> dict:
    """Phase 5: the port's seeded chaos campaign on the card (restores land
    there; the ``delta-gather`` cell fingerprints a CUDA tensor) for the
    gate seeds. Zero invariant violations, >= 200 faults fired, and every
    kind class of ``REQUIRED_KINDS``."""
    from repro_torch.core import chaos
    shutil.rmtree(root, ignore_errors=True)
    w0 = io_written()
    t0 = time.perf_counter()
    total, kinds, runs = 0, set(), []
    for seed in CHAOS_SEEDS:
        ts = time.perf_counter()
        try:
            stats = chaos.run_campaign(seed, min_faults=CHAOS_MIN_FAULTS,
                                       base_dir=os.path.join(root, str(seed)),
                                       device="cuda")
        except chaos.InvariantViolation as e:
            fail(f"chaos seed {seed}: invariant violation\n{e}")
        for line in stats.summary().splitlines():
            log(f"  {line}")
        total += stats.faults
        kinds.update(stats.by_kind)
        runs.append(dict(seed=seed, trials=stats.trials, faults=stats.faults,
                         no_fire=stats.no_fire, seconds=time.perf_counter()
                         - ts, by_kind=dict(stats.by_kind)))
    seconds = time.perf_counter() - t0
    written = io_written() - w0
    tally.add("phase 5 campaign (write calls)", written)
    missing = [p for p in REQUIRED_KINDS
               if not any(k.startswith(p) for k in kinds)]
    if missing:
        fail(f"chaos: fault kind classes never fired: {missing}")
    if total < CHAOS_MIN_FAULTS:
        fail(f"chaos: only {total} faults fired")
    log(f"phase 5 chaos gate on the card: {total} faults over seeds "
        f"{CHAOS_SEEDS}, zero invariant violations, every kind class fired; "
        f"{seconds:.1f} s, {written} B passed to write calls")
    shutil.rmtree(root, ignore_errors=True)
    return dict(seeds=runs, faults=total, seconds=seconds,
                written_bytes=written)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    # one CPU rank of phase 4h (b), started by the run itself
    for flag in ("--mesh-restore-rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=-1, help=argparse.SUPPRESS)
    for flag in ("--ckpt", "--report", "--dryrun-cells"):
        ap.add_argument(flag, default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_restore_rank >= 0:
        mesh_restore_rank(args)
        return 0
    if args.dryrun_cells:
        dryrun_cells(args.dryrun_cells)
        return 0
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs only on the card")
    from repro_torch.configs import get_config
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
    # the dry run of 4h (a)'s and 4j (b)'s steps, on meta beside the phases
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    dry_path = os.path.join(HERE, "build", "smoke_dryrun.json")
    dry_log = open(os.path.join(HERE, "build", "smoke_dryrun.log"), "w")
    dry = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--dryrun-cells", dry_path], cwd=HERE,
                           stdout=dry_log, stderr=subprocess.STDOUT)
    atexit.register(lambda: dry.poll() is None and (dry.kill(), dry.wait()))

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

    # phase 3: checkpoint path at full width, depth cut
    from repro_torch.configs import make_train_state, train_state_inventory
    from repro_torch.train.steps import init_train_state
    state = make_train_state(train_state_inventory("qwen2.5-3b"),
                             device="cuda", seed=0, layers=CHECKPOINT_LAYERS)
    torch.cuda.synchronize()
    log(f"checkpoint path: qwen2.5-3b train state, depth cut to "
        f"{CHECKPOINT_LAYERS} of 36 stacked layers (every width kept)")
    # the disk-write plan, checked before anything is written
    tensors = flat_leaves(state)
    quant = {k for k in tensors if k.startswith(QUANT_PREFIXES)}
    plan = planned_writes(
        save_estimate(tensors, quant), PROBE_BYTES,
        state_bytes(flat_leaves(init_train_state(train_config(),
                                                 device="meta"))),
        multi_writer_estimate(tensors, quant, WRITERS), zoo_estimate(),
        state_bytes(flat_leaves(init_train_state(get_config(XLSTM_ARCH),
                                                 device="meta"))))
    groups, plan["4k"] = mesh_writers_depth(sum(plan.values()))
    log(f"4k depth: {groups} of 12 (mLSTM, sLSTM) groups of {XLSTM_ARCH}, "
        f"{plan['4k']} B to write (full depth "
        f"{plan['4f failover'] // 3} B of train state)")
    log(f"write plan: {sum(plan.values())} B "
        f"({sum(plan.values()) / 2**30:.2f} GiB, limit "
        f"{WRITE_LIMIT / 2**30:.1f} GiB): " + ", ".join(
            f"{k} {v}" for k, v in plan.items()))
    if sum(plan.values()) >= WRITE_LIMIT:
        fail("the run's planned disk writes exceed its budget")
    del tensors
    tally = WriteTally()
    root = os.path.join(HERE, "build", "smoke_ckpt")
    t0 = time.perf_counter()
    try:
        main_path = run_main_path(state, root, PROBE_BYTES, tally)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    log(f"checkpoint path: {time.perf_counter() - t0:.1f} s")

    # phase 4: training path, full width at 10 of 26 layers; phase 4e, the
    # serving path, swaps in its checkpoint
    train_root = os.path.join(HERE, "build", "smoke_train")
    t0 = time.perf_counter()
    try:
        training, saved = run_training(
            train_config(), train_root, tally, phase="4",
            kernels=TRAINING_KERNELS, profile=True)
        log(f"training path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        kept: dict = {}
        serving = serve_path(train_root, os.path.join(HERE, "build",
                                                      "smoke_zoo"),
                             tally, param_digests(saved), kept)
        log(f"4e: {time.perf_counter() - t0:.1f} s")
        # phase 4h (a): the same checkpoint resumed onto a 1x1 CUDA mesh
        t0 = time.perf_counter()
        mesh = mesh_resume(train_config(), train_root, saved,
                           training["run1"], training["run2"])
        log(f"4h (a): {time.perf_counter() - t0:.1f} s")
        # phase 4i: the same checkpoint served on a 1x1 CUDA mesh
        t0 = time.perf_counter()
        serve_on_mesh = serve_mesh(train_root, saved, kept, serving)
        log(f"4i: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(train_root, ignore_errors=True)
    del saved
    # phase 4f: the slice's path, full xlstm-350m trained, resumed, served
    t0 = time.perf_counter()
    xlstm = xlstm_path(os.path.join(HERE, "build", "smoke_xlstm"), tally)
    log(f"4f: {time.perf_counter() - t0:.1f} s")
    # phase 4g: full olmoe-1b-7b served; 4j: the same served on a 1x1
    # mesh, then trained there at a cut depth
    t0 = time.perf_counter()
    moe, moe_mesh = moe_serve()
    log(f"4g and 4j (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_mesh["train"] = moe_mesh_train()
    log(f"4j (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh["cli"] = mesh_cli()
    log(f"4h (c): {time.perf_counter() - t0:.1f} s")
    # phase 4k: writer threads in the rank of a 1x1 mesh
    t0 = time.perf_counter()
    writers = mesh_writers(mesh_writers_config(groups),
                           os.path.join(HERE, "build", "smoke_mw_mesh"), tally)
    log(f"4k: {time.perf_counter() - t0:.1f} s")
    # phase 4l: the xLSTM blocks split over model, on a 1x1 mesh
    t0 = time.perf_counter()
    xlstm_on_mesh = xlstm_mesh()
    log(f"4l: {time.perf_counter() - t0:.1f} s")
    # phase 4m: the train step's loss split over model, on a 1x1 mesh
    t0 = time.perf_counter()
    ce_on_mesh = ce_mesh()
    log(f"4m: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training["cpu_vs_card"] = [cpu_vs_card(cfg, tokens, label) for
                               label, cfg, tokens in card_vs_cpu_cases()]
    log(f"4b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training["multilevel_resume"] = multilevel_resume(
        os.path.join(HERE, "build", "smoke_ml"), tally)
    log(f"4c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training["multiwriter_resume"] = multiwriter_resume(
        os.path.join(HERE, "build", "smoke_mw"), tally)
    log(f"4d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chaos_run = chaos_gate(os.path.join(HERE, "build", "smoke_chaos"), tally)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    tally.check("at the end")
    main_path["write_tally"] = dict(tally.parts, total=tally.total)
    t0 = time.perf_counter()
    dry_vs_card = dryrun_vs_card(dry, dry_path, {
        "4h (a)": mesh["memory"],
        "4j (b)": moe_mesh["train"]["mesh"]["memory"],
        "4l": xlstm_on_mesh["mesh"]["memory"],
        "4m": ce_on_mesh["mesh"]["memory"]})
    log(f"dry run vs card: {time.perf_counter() - t0:.1f} s waited")

    launches = {name: main_path["launches"].get(name, 0)
                + training["launches"].get(name, 0)
                + serving["launches"].get(name, 0)
                + xlstm["launches"].get(name, 0)
                + mesh["launches"].get(name, 0)
                + serve_on_mesh["launches"].get(name, 0)
                + writers["launches"].get(name, 0)
                for name in KERNELS}
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
                           training=training, serving=serving, xlstm=xlstm,
                           moe=moe, moe_mesh=moe_mesh, mesh=mesh,
                           serve_mesh=serve_on_mesh, mesh_writers=writers,
                           xlstm_mesh=xlstm_on_mesh, ce_mesh=ce_on_mesh,
                           dryrun_vs_card=dry_vs_card,
                           chaos=chaos_run), f,
                      indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
