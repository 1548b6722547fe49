"""A cell small enough for the CPU, for the benchmark's own tests.

``tiny_tree(dir, kind)`` writes a config, a traffic and a workload under
``dir`` in the layout the harness reads and returns the matching
``BENCHMARK.json`` object: ``kind`` is "save" (async saves in the
window), "train" (no saves) or "resume". The model is a float32 audio
decoder with a conditioning prefix, fed Zipf 1.3 tokens, as the cells are.
"""

from __future__ import annotations

import json
from pathlib import Path

# The limits of the numbers that compare steps, set from this size's own
# readings on the CPU (PERF.md): the program over 12 seeds at most
# 1.07e-6 / 4.52e-7 / 1.45e-6 (the first two steps' loss, grad, change),
# the TF32 control over 6 at least 3.13e-5 / 1.12e-4 / 1.70e-4.
TINY_LIMITS = {"loss_gap": 6e-6, "grad_gap": 1e-5, "change_gap": 1e-5}


def tiny_tree(d: Path, kind: str) -> dict:
    for sub in ("configs", "traffic", "workloads"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    model = {"name": "tiny-audio", "family": "audio", "num_layers": 1,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
             "head_dim": 16, "d_ff": 128, "vocab_size": 64, "act": "gelu",
             "frontend": "audio_frames", "frontend_dim": 24,
             "frontend_len": 8, "norm_eps": 1e-6, "rope_theta": 10000.0,
             "dtype": "float32", "remat": True, "tie_embeddings": False}
    conf = {"model": model,
            "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                          "weight_decay": 0.1, "grad_clip": 1.0,
                          "warmup_steps": 0}}
    traffic = {"batch": 4, "seq_len": 32, "zipf": [1.3, 1.3]}
    limits = dict(TINY_LIMITS)
    if kind != "train":
        traffic["save"] = {"engine": "aggregated", "async": True, "keep": 3,
                           "in_window": 2 if kind == "save" else 0}
        limits["saved_leaves_differing"] = 0
    if kind == "resume":
        traffic["resume"] = {"steps_per_resume": 2}
        limits["restored_leaves_differing"] = 0
    work = {"warm_steps": 2, "reference_rows": 2, "limits": limits}
    for sub, obj in (("configs/tiny", conf), ("traffic/t", traffic),
                     ("workloads/c", work)):
        (d / f"{sub}.json").write_text(json.dumps(obj), encoding="utf-8")
    return {"configs": [{"name": "tiny", "file": "configs/tiny.json"}],
            "workloads": [{"name": "c", "config": "tiny", "traffic": "t",
                           "chips": 1}],
            "end_to_end": [], "per_layer": []}
