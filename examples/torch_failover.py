"""Fault tolerance on the PyTorch port: kill a training run mid-save
(SIGKILL), restart it — the trainer resumes from the newest committed step,
data position included, and never reads the torn one — then lose level 0
and recover from level 1.

Counterpart of ``examples/failover.py`` on ``repro_torch``: the child is
the port's ``Trainer`` with ``multilevel_remote`` on a reduced stablelm
(2 layers, width / 16, vocab 512; weights from seed 0), checkpointing every
10 steps to a local level 0 and flushing each step to a level-1 directory.
The reference kills its child after a fixed 30 s; here the child is killed
on an observed event: step k is committed at level 1 and step k + 10's
save has begun at level 0 (its ``.tmp-`` dir exists). Runs on the card by
default; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_failover.py [--device cpu] \\
        [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

CKPT_EVERY = 10
TIMEOUT = 600

CHILD = r"""
import sys
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

steps, local, remote, device = sys.argv[1:5]
cfg = get_config("stablelm-3b").scaled_down(layers=2, width_div=16, vocab=512)
tcfg = TrainerConfig(steps=int(steps), ckpt_every=int(sys.argv[5]),
                     ckpt_dir=local, multilevel_remote=remote, log_every=10,
                     seed=0)
data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                  seed=0)
t = Trainer(cfg, tcfg, data_cfg=data, device=device)
try:
    state, start = t.initial_state()
    print("RESUMED", start, "DATA", t.pipeline.state.step, flush=True)
    out = t.run((state, start))
finally:
    t.close()
print("FINAL", int(out["state"]["step"]), flush=True)
"""

_TMP = re.compile(r"step_(\d+)\.tmp-")


def _committed(level: str) -> list[int]:
    if not os.path.isdir(level):
        return []
    return sorted(int(n.split("_")[1]) for n in os.listdir(level)
                  if re.fullmatch(r"step_\d+", n)
                  and os.path.exists(os.path.join(level, n, "manifest.json")))


def _start(steps: int, local: str, remote: str, device: str):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(steps), local, remote, device,
         str(CKPT_EVERY)], env=os.environ.copy(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def kill_mid_save(local: str, remote: str, device: str) -> int:
    """Run the child until step k is at level 1 and step k + CKPT_EVERY's
    save has begun at level 0, then SIGKILL it; returns k + CKPT_EVERY."""
    child = _start(100 * CKPT_EVERY, local, remote, device)
    deadline = time.monotonic() + TIMEOUT
    try:
        while True:
            torn = [int(m.group(1)) for n in (os.listdir(local) if
                    os.path.isdir(local) else ())
                    if (m := _TMP.match(n))]
            flushed = set(_committed(remote))
            hit = [s for s in torn if s - CKPT_EVERY in flushed]
            if hit:
                child.kill()
                child.wait()
                return hit[0]
            if child.poll() is not None:
                raise SystemExit("the child ended before it was killed:\n"
                                 + child.communicate()[0][-2000:])
            if time.monotonic() > deadline:
                raise SystemExit(f"no save in flight after {TIMEOUT} s")
            time.sleep(0.001)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def run_child(steps: int, local: str, remote: str, device: str
              ) -> tuple[int, int, int]:
    """Run the child to ``steps``; returns (resumed step, its data
    position, final step)."""
    child = _start(steps, local, remote, device)
    out = child.communicate(timeout=TIMEOUT)[0]
    if child.returncode != 0:
        raise SystemExit(f"the child exited {child.returncode}:\n"
                         + out[-3000:])
    resumed = re.search(r"^RESUMED (\d+) DATA (\d+)$", out, re.M)
    final = re.search(r"^FINAL (\d+)$", out, re.M)
    return int(resumed.group(1)), int(resumed.group(2)), int(final.group(1))


def main(root: str | None = None, device="cuda") -> dict:
    root = root or os.path.join(tempfile.gettempdir(),
                                "repro_torch_failover")
    local, remote = os.path.join(root, "local"), os.path.join(root, "remote")
    for d in (local, remote):
        shutil.rmtree(d, ignore_errors=True)

    print("=== phase 1: train, SIGKILL while a save is in flight ===")
    torn = kill_mid_save(local, remote, device)
    left = sorted(os.listdir(local))
    last = max(_committed(local))
    # the kill may land just after the save it saw begin had committed
    fate = "committed before the kill" if last == torn else "torn"
    print(f"killed at step {torn}'s save ({fate}); level 0 holds {left}")

    print("\n=== phase 2: restart — resumes from the newest committed step "
          "===")
    target = last + 2 * CKPT_EVERY
    resumed, data_step, final = run_child(target, local, remote, device)
    assert (resumed, data_step, final) == (last, last, target), \
        (resumed, data_step, final, last, target)
    # a staging dir killed before its owner record was written is reaped
    # only once it is old; either way it is never read
    print(f"resumed from step {resumed} (data position {data_step}), "
          f"completed to {final} ✓; level 0 holds "
          f"{sorted(os.listdir(local))}")

    print("\n=== phase 3: node loss — wipe level 0, recover from level 1 "
          "===")
    shutil.rmtree(local)
    resumed, data_step, final = run_child(target + CKPT_EVERY, local,
                                          remote, device)
    assert (resumed, data_step, final) == (target, target,
                                           target + CKPT_EVERY)
    print(f"recovered from level 1 at step {resumed}, completed to "
          f"{final} ✓")
    return dict(torn=torn, last=last, target=target)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory of both levels (default: "
                         "repro_torch_failover under the temp dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            sys.exit("no CUDA device: run with --device cpu")
    main(args.root, args.device)
