"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``: a training loop with this
package's checkpoint engine in it — periodic async checkpoints, kill-resume
fault tolerance, engine/strategy selection, and a report of the checkpoint
overheads. Runs on the card by default (``--device cpu`` for a reduced run
on the CPU); the default architecture is xlstm-350m, as in the reference;
``--full`` trains the full-size config (xlstm-350m and recurrentgemma-2b
each fit one 80 GB H100). ``--remote-dir`` adds a level-1 directory
(two-level checkpointing, resumable after the loss of ``--ckpt-dir``).

``--mesh DxM`` trains on a (data x model) DeviceMesh, one process per rank,
the state and batch as DTensors (``Trainer(mesh=)``): launch it with
``torchrun --nproc-per-node D*M -m repro_torch.launch.train --mesh DxM``,
or run it directly for ``1x1``. The process group is NCCL on the card and
gloo with ``--device cpu``; a mesh whose D*M is not the world size fails.
On a mesh of more than one rank every rank saves its windows into one
group checkpoint under ``--ckpt-dir``; with ``--remote-dir`` rank 0 flushes
each committed step of it to level 1, and a restart on any mesh shape
resumes from level 1 when ``--ckpt-dir`` was lost, each rank reading its
own windows.
Rank 0 prints each logged step's loss as it goes (``step N loss X``), the
report at the end, and writes ``--json-out``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile

from ..configs import ARCH_IDS, get_config
from ..core import EngineConfig
from ..core.engines import ENGINES
from ..data import DataConfig
from ..optim import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def build_config(args):
    """The model config the arguments select (reduced unless ``--full``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.scaled_down(layers=args.layers, width_div=args.width_div,
                              vocab=args.vocab)
    return cfg


def build_trainer(args) -> Trainer:
    cfg = build_config(args)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        ckpt_engine=args.engine, async_ckpt=not args.sync_ckpt,
        multilevel_remote=args.remote_dir, log_every=args.log_every,
        seed=args.seed)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch, seed=args.seed,
                          frontend_len=cfg.frontend_len,
                          frontend_dim=cfg.frontend_dim)
    eng_cfg = EngineConfig(strategy=args.strategy, direct=not args.buffered,
                           queue_depth=args.queue_depth)
    mesh = None
    if args.mesh:
        from .mesh import make_host_mesh
        d, m = parse_mesh(args.mesh)
        mesh = make_host_mesh(d, m, device=args.device)
    return Trainer(cfg, tcfg, data_cfg=data_cfg,
                   opt_cfg=AdamWConfig(lr=args.lr),
                   engine_config=eng_cfg, device=args.device, mesh=mesh)


def parse_mesh(text: str) -> tuple[int, int]:
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    return d, m


def init_process_group(device: str) -> None:
    """The process group of a ``--mesh`` run: torchrun's (``env://``) when
    it launched this process, else one rank of its own on a free local
    port."""
    import torch.distributed as dist
    backend = "nccl" if device.startswith("cuda") else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="xlstm-350m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="scaled-down config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--width-div", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--mesh", default="",
                    help="DxM (data x model) DeviceMesh, one process per "
                    "rank, e.g. 2x2 under torchrun; 1x1 runs directly")
    # checkpointing
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--remote-dir", default="",
                    help="level-1 directory for two-level checkpointing; "
                    "on a mesh, rank 0 flushes the group checkpoint there")
    ap.add_argument("--engine", default="aggregated", choices=sorted(ENGINES))
    ap.add_argument("--strategy", default="single_file",
                    choices=["single_file", "file_per_process",
                             "file_per_tensor"])
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--buffered", action="store_true")
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--json-out", default="")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if not args.mesh:
        return run(args)
    import torch.distributed as dist
    init_process_group(args.device)
    try:
        run(args, rank=dist.get_rank())
    finally:
        dist.destroy_process_group()


def run(args, rank: int = 0) -> None:
    trainer = build_trainer(args)
    if not rank:
        trainer.on_log = lambda m: print(
            f"step {m['step']} loss {m['loss']!r} seconds "
            f"{m['seconds']:.3f}", flush=True)
    try:
        out = trainer.run()
    finally:
        trainer.close()
    if rank:
        return
    losses = [m["loss"] for m in out["metrics"]]
    print(f"\narch={args.arch} device={args.device} "
          f"mesh={args.mesh or 'none'} steps={args.steps} "
          f"wall={out['wall_seconds']:.1f}s "
          f"ckpt_blocking={out['ckpt_blocking_seconds']:.2f}s")
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"metrics": out["metrics"],
                       "wall_seconds": out["wall_seconds"],
                       "ckpt_blocking_seconds": out["ckpt_blocking_seconds"]},
                      f, indent=1)


if __name__ == "__main__":
    main()
