"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--bf16-seeds 4,5,6] [--out FILE]

For each of ``--seeds``: the program's first three steps at the cell's
size through the trainer, the float32 reference, and the numbers that
decide ``correct`` (the lower readings). For each of ``--control-seeds``:
the same numbers for the reference put in the program's place, computed
with TF32 matmul operands (the control), for the reference on half of
each batch with the mean over the rest, and for the reference with one
label token altered (the faults a one-chip training cell can have besides
a state left unchanged, which reads 1 by the measure of the change). For
each of ``--bf16-seeds``: the program's readings with the configuration's
type set to bfloat16. One JSON line a reading, on standard output and in
``--out``. Needs the card. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _one_label(vocab: int):
    def alter(batch: dict) -> dict:
        labels = batch["labels"].clone()
        labels[0, 0] = (labels[0, 0] + 1) % vocab
        return {**batch, "labels": labels}
    return alter


def detail(run, ref: dict, prog: dict | None = None) -> dict:
    """Each step's loss gap and the leaves that set the worst gaps."""
    prog = prog or {"loss": run.prog_loss, "grad": run.prog_grad,
                    "change": run.prog_change}
    out = {"loss_gaps": [abs(a - b) / abs(b)
                         for a, b in zip(prog["loss"], ref["loss"])]}
    for name in ("grad", "change"):
        gaps = {k: abs(float(prog[name][k]) - float(v)) / float(v)
                for k, v in ref[name].items() if float(v) > 0}
        worst = sorted(gaps, key=gaps.get)[-2:]
        out[f"{name}_worst"] = {k: gaps[k] for k in worst}
    return out


def main() -> int:
    import torch
    from portbench import bench
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--bf16-seeds", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    sink = open(a.out, "a", encoding="utf-8") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def seeds(arg):
        return [int(s) for s in arg.split(",") if s]

    programs = [(s, "program") for s in seeds(a.seeds)] + \
        [(s, "program_bf16") for s in seeds(a.bf16_seeds)]
    for seed, kind in programs:
        t0 = time.perf_counter()
        run = bench.Run(spec, a.workload, seed, 0.0, False, t0)
        if kind == "program_bf16":
            run.m = {**run.m, "dtype": "bfloat16"}
        run.first_steps()
        run.free_program()
        ref = run.reference()
        nums = run.compare(ref)
        emit({"cell": a.workload, "seed": seed, "kind": kind,
              **nums, **detail(run, ref),
              "seconds": time.perf_counter() - t0})
        del run
        torch.cuda.empty_cache()
    for seed in seeds(a.control_seeds):
        run = bench.Run(spec, a.workload, seed, 0.0, False, time.perf_counter())
        from repro_torch.train.steps import init_train_state
        run.layout = init_train_state(bench.model_config(run.m),
                                      device="meta")
        ref = run.reference()
        for kind, kw in (("control_tf32", {"precision": "tf32"}),
                         ("fault_half_batch", {"batches": _half}),
                         ("fault_one_label",
                          {"batches": _one_label(run.m["vocab_size"])})):
            t0 = time.perf_counter()
            other = run.reference(**kw)
            nums = run.compare(ref, other)
            emit({"cell": a.workload, "seed": seed, "kind": kind, **nums,
                  **detail(run, ref, other),
                  "seconds": time.perf_counter() - t0})
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
