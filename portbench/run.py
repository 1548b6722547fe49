"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cells and the
metrics, ``portbench/`` holds everything else, and the program under test
is ``src/repro_torch``. The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit); the last lines of standard error repeat the checks.
Exits non-zero without a result when there is no card, too few cards,
no program beside the benchmark, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        say("no program beside the benchmark: src/repro_torch is missing")
        return 2
    import torch
    from portbench import bench
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        say(f"no cell named {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        say(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    w0 = bench.written_bytes()
    out = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START, log=say)
    w1 = bench.written_bytes()
    if w0 is not None and w1 is not None:
        say(f"bytes this process wrote to block storage: {w1 - w0}")
    bad = bench.jax_modules()
    if bad:
        say(f"JAX or the JAX package was loaded: {bad}")
        return 3
    for k, v in out["checks"].items():
        say(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
