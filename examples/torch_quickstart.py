"""Quickstart on the PyTorch port: train a reduced qwen2.5 with async
checkpointing, then restore the checkpoint and verify that the state comes
back bit for bit.

Counterpart of ``examples/quickstart.py`` on ``repro_torch``: the same
reduced model (2 layers, width / 16, vocab 512), 100 steps with a
checkpoint every 50 by default, batch 8 x 128 tokens, weights from seed 0.
Runs on the card by default; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \\
        [--steps 100] [--ckpt-every 50] [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import CheckpointManager
from repro_torch.core.serialization import tree_leaves_with_path
from repro_torch.data import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(root: str | None = None, device="cuda", steps: int = 100,
         ckpt_every: int = 50) -> dict:
    root = root or os.path.join(tempfile.gettempdir(),
                                "repro_torch_quickstart")
    ckpt = os.path.join(root, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("qwen2.5-3b").scaled_down(layers=2, width_div=16,
                                               vocab=512)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt,
                         ckpt_engine="aggregated", async_ckpt=True,
                         log_every=max(1, steps // 5), seed=0)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                      seed=0)
    trainer = Trainer(cfg, tcfg, data_cfg=data, device=device)
    try:
        out = trainer.run()
    finally:
        trainer.close()

    print("\nloss curve:")
    for m in out["metrics"]:
        print(f"  step {m['step']:>3}: loss={m['loss']:.4f}")
    print(f"checkpoint blocking time: {out['ckpt_blocking_seconds']*1e3:.1f} "
          f"ms over {steps // ckpt_every} checkpoints (async flush)")

    # restore onto the trained state's devices and verify
    with CheckpointManager(ckpt, device=device) as mgr:
        state = mgr.restore(state_template={"train": out["state"],
                                            "data": {"data_step": 0}})
    got = dict(tree_leaves_with_path(state["train"]))
    want = dict(tree_leaves_with_path(out["state"]))
    assert got.keys() == want.keys()
    bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
    if bad:
        raise SystemExit(f"{len(bad)} restored leaves differ, e.g. {bad[:3]}")
    assert int(state["data"]["data_step"]) == steps
    print("restored state is bit-exact ✓")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkpoint directory's parent (default: "
                         "repro_torch_quickstart under the temp dir)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        sys.exit("no CUDA device: run with --device cpu")
    main(args.root, args.device, args.steps, args.ckpt_every)
