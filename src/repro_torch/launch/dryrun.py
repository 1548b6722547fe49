"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step with XLA and reads XLA's memory and cost analyses
and the HLO's collectives; those numbers have no counterpart without XLA.
This dry run proves what the layouts alone decide, for every cell at
production scale (16 x 16 and 2 x 16 x 16 meshes, which no host holds, as
``AbstractMesh``es): every leaf's layout resolves with even splits, and
per device it reports

    argument_bytes  — the step's arguments: state + batch (train), params +
                      batch (prefill), params + cache + token + pos (decode)
    local_shapes    — every argument leaf's per-device shape

beside the model's ``params`` / ``active_params``. Pure full-attention
archs skip ``long_500k``, as in the reference. FLOPs, temporaries and
collective volumes are not computed here.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --all --both-meshes
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCH_IDS, get_config
from ..models.config import SHAPES_BY_NAME
from .mesh import make_production_mesh
from .specs import arg_leaves, cell_args, input_specs, local_bytes


def run_cell(arch: str, shape_name: str, multi_pod: bool = False) -> dict:
    """Specs of one cell on the 16x16 mesh, or 2x16x16 with ``multi_pod``."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.kind, "status": "ok"}
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md §6)")
        return rec
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod)
        info = input_specs(cfg, shape, mesh)
        args = cell_args(info)
        leaves = [(f"{i}/{k}", s) for i, t in enumerate(args)
                  for k, s in arg_leaves(t)]
        for _, s in leaves:        # every split even, as the rules promise
            s.layout.placements_for(s.shape)
        rec.update({
            "devices": mesh.size,
            "specs_s": round(time.perf_counter() - t0, 3),
            "per_device": {
                "argument_bytes": local_bytes(*args),
                "local_shapes": {k: list(s.local_shape) for k, s in leaves},
            },
            "model": {
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
            },
        })
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS
                 for shape in SHAPES_BY_NAME]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, multi_pod=mp)
            results.append(rec)
            pd = rec.get("per_device", {})
            print(f"[{rec['status']:7s}] {arch:22s} {shape:12s} "
                  f"{rec['mesh']:8s} "
                  f"args={pd.get('argument_bytes', 0) / 1e9:8.3f}GB "
                  f"leaves={len(pd.get('local_shapes', {})):4d}"
                  + (f"  !! {rec.get('error', '')[:120]}"
                     if rec["status"] == "error" else ""),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells ok, "
          f"{len(bad)} errors")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
