"""Elastic restart on the PyTorch port: save on one mesh, restore onto two
others.

Counterpart of ``examples/elastic_reshard.py`` on ``repro_torch``. A
reduced olmoe train state (2 layers, width / 16, vocab 512, as the
reference's) is laid out on a (data x model) DeviceMesh by the
``Partitioner``, each rank saves its windows into one checkpoint (committed
once), and the step is restored onto meshes of other shapes through
``restore(shardings=)``: every rank reads only its new windows, and every
restored block must equal its window of the saved state. The manifest's
global-index windows are what let a checkpoint written under one
(DP x TP) layout be read under another — restart after a topology change.

Ranks are processes, one per mesh device: this script starts them itself
(every mesh must have the same number of ranks). The device is the card;
a mesh with more ranks than there are cards is refused — run it on the
CPU with ``--device cpu`` (gloo):

    PYTHONPATH=src python examples/torch_elastic_reshard.py [--device cpu] \\
        [--save 2x4] [--restore 4x2 1x8] [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile

ARCH = "olmoe-1b-7b"


def parse_mesh(text: str) -> tuple[int, int]:
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def worker(args) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import process_group_manager
    from repro_torch.core.serialization import (path_str,
                                                tree_leaves_with_path)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import (Layout, Partitioner,
                                                shard_tree)
    from repro_torch.train.steps import init_train_state

    dist.init_process_group(
        "nccl" if args.device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=args.rank,
        world_size=args.world)
    try:
        cfg = get_config(ARCH).scaled_down(layers=2, width_div=16,
                                           vocab=512)
        mesh_a = make_host_mesh(*parse_mesh(args.save), device=args.device)
        device = torch.device(args.device) if args.device == "cpu" else \
            torch.device("cuda", torch.cuda.current_device())
        whole = init_train_state(cfg, seed=0, device=device)

        def layouts(mesh):
            return Partitioner(cfg, mesh).state_shardings(
                init_train_state(cfg, device="meta"))

        state = shard_tree(whole, layouts(mesh_a))
        with process_group_manager(args.ckpt, device=device) as mgr:
            mgr.save(1, state)
            mgr.wait()
            for text in args.restore:
                mesh_b = make_host_mesh(*parse_mesh(text),
                                        device=args.device)
                lay_b = layouts(mesh_b)
                flat = {path_str(p): lay for p, lay in tree_leaves_with_path(
                    lay_b, is_leaf=lambda x: isinstance(x, Layout))}
                restored = mgr.restore(
                    init_train_state(cfg, device="meta"), step=1,
                    shardings=flat)
                # value equality against the saved state, despite the new
                # layout: each rank's block is its window of it
                got = dict(tree_leaves_with_path(restored))
                for path, want in tree_leaves_with_path(whole):
                    lay = flat[path_str(path)]
                    block = got[path].to_local()
                    if tuple(got[path].placements) != lay.placements or \
                            not torch.equal(block,
                                            lay.distribute(want).to_local()):
                        raise SystemExit(f"rank {args.rank}: "
                                         f"{path_str(path)} differs after "
                                         f"the restore onto {text}")
                wq = restored["params"]["blocks"]["b0_attn"]["wq"]
                if args.rank == 0:
                    print(f"restored onto {text} mesh; wq placements="
                          f"{wq.placements}, local block "
                          f"{tuple(wq.to_local().shape)} of "
                          f"{tuple(wq.shape)}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--save", default="2x4")
    ap.add_argument("--restore", nargs="+", default=["4x2", "1x8"])
    ap.add_argument("--root", default="",
                    help="checkpoint directory (default: under the temp "
                    "dir, removed at the end); kept when given")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank >= 0:
        worker(args)
        return 0

    d, m = parse_mesh(args.save)
    world = d * m
    for text in args.restore:
        d, m = parse_mesh(text)
        if d * m != world:
            ap.error(f"--restore {text}: {d * m} ranks, --save {args.save} "
                     f"has {world}; every mesh needs the same rank count")
    if args.device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        if cards < world:
            raise SystemExit(
                f"a {args.save} mesh needs {world} cards, this machine has "
                f"{cards}: run it on the CPU with --device cpu")
    root = args.root or tempfile.mkdtemp(prefix="repro_torch_elastic_")
    ckpt = os.path.join(root, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, os.path.abspath(__file__), "--device",
           args.device, "--save", args.save, "--restore", *args.restore,
           "--world", str(world), "--port", str(port), "--ckpt", ckpt]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not args.root:
            shutil.rmtree(root, ignore_errors=True)
    if any(codes):
        print(f"ranks exited {codes}", file=sys.stderr)
        return 1
    print(f"saved on {args.save}; elastic resharding onto "
          f"{', '.join(args.restore)} ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
