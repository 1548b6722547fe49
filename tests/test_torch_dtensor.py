"""DTensor leaves saved and restored by the port across a 2-rank gloo group
(one launch of two processes on the CPU, a ``DeviceMesh("cpu", (2,))``).

Each process saves its local shards of ``Shard(0)``, ``Shard(1)`` and
``Replicate`` leaves — uneven and empty chunks included, and a quantized
leaf — into one checkpoint committed once through the two-phase protocol
(``process_group_manager``). The manifest must hold each global window
once; the step restores into plain templates (whole tensors, in the port
and in the JAX package) and into DTensor templates with other placements,
whose local windows must equal ``distribute_tensor``'s. Tolerance:
bit-exact (the quantized leaf: equal to its single-writer decode).

    python tests/test_torch_dtensor.py <rank> <world> <dir>   # one worker
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
QUANT_KEY = "opt/mu/x"


def _globals() -> dict:
    rng = np.random.default_rng(0)
    return {
        "a": rng.standard_normal((5, 6)).astype(np.float32),     # 3 + 2
        "b": rng.standard_normal((4, 7)).astype(np.float32),     # 4 + 3
        "c": rng.standard_normal((3, 4)).astype(np.float32),
        "d": rng.standard_normal((1, 8)).astype(np.float32),     # 1 + 0
        "x": rng.standard_normal((64, 32)).astype(np.float32),
    }


def _layouts():
    from torch.distributed.tensor import Replicate, Shard
    saved = {"a": [Shard(0)], "b": [Shard(1)], "c": [Replicate()],
             "d": [Shard(0)], "x": [Shard(0)]}
    # "d" again by Shard(0): rank 1's window is empty on restore too
    other = {"a": [Shard(1)], "b": [Replicate()], "c": [Shard(0)],
             "d": [Shard(0)], "x": [Shard(1)]}
    return saved, other


def _tree(leaves: dict) -> dict:
    return {"params": {k: leaves[k] for k in "abcd"},
            "opt": {"mu": {"x": leaves["x"]}}, "note": "dtensor"}


def worker(rank: int, world: int, directory: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial,
                                          distribute_tensor)
    from repro_torch.core import EngineConfig, process_group_manager

    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/pg", rank=rank,
        world_size=world)
    mesh = init_device_mesh("cpu", (world,))
    saved, other = _layouts()
    full = {k: torch.from_numpy(v) for k, v in _globals().items()}
    cfg = EngineConfig(backend="posix", strategy="single_file", direct=False)
    out: dict = {}
    with process_group_manager(
            os.path.join(directory, "ckpt"), config=cfg, device="cpu",
            quantize_prefixes=("opt/mu",), quantize_min_bytes=1024) as mgr:
        state = _tree({k: distribute_tensor(full[k], mesh, saved[k])
                       for k in full})
        mgr.save(1, state)
        plain = mgr.restore(step=1)
        out["plain"] = {k: bool(torch.equal(plain["params"][k], full[k]))
                        for k in "abcd"}
        templates = _tree({k: distribute_tensor(torch.zeros_like(full[k]),
                                                mesh, other[k])
                           for k in full})
        got = mgr.restore(templates, step=1)
        want = {k: distribute_tensor(full[k], mesh, other[k]) for k in full}
        for k in "abcd":
            g = got["params"][k]
            out[f"dtensor/{k}"] = bool(
                isinstance(g, DTensor) and g.placements == tuple(other[k])
                and tuple(g.shape) == tuple(full[k].shape)
                and torch.equal(g.to_local(), want[k].to_local())
                and torch.equal(g.full_tensor(), full[k]))
        # the quantized leaf: its window of the whole decoded tensor
        gx = got["opt"]["mu"]["x"]
        out["dtensor/x"] = bool(torch.equal(
            gx.full_tensor(), plain["opt"]["mu"]["x"]))
        try:
            mgr.save(2, {"p": DTensor.from_local(
                torch.ones(2, 2), mesh, [Partial()])})
            out["partial"] = "saved"
        except ValueError as e:
            out["partial"] = "refused" if "Partial" in str(e) else repr(e)
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def test_dtensor_save_and_restore_across_two_ranks(tmp_path):
    from repro.core import CheckpointManager as RefManager
    from repro.core import EngineConfig as RefConfig
    from repro_torch.core import CheckpointManager, Manifest
    from repro_torch.core.serialization import tensor_to_numpy

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2",
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res.pop("partial") == "refused", res
        assert all(res["plain"].values()), res
        res.pop("plain")
        assert all(res.values()), res

    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_00000001"]
    man = Manifest.load(str(ckpt / "step_00000001"))
    assert man.num_ranks == 2
    want = {"params/a": [((0, 3), (0, 6)), ((3, 5), (0, 6))],
            "params/b": [((0, 4), (0, 4)), ((0, 4), (4, 7))],
            "params/c": [((0, 3), (0, 4))],
            "params/d": [((0, 1), (0, 8))],
            QUANT_KEY: [((0, 32), (0, 32)), ((32, 64), (0, 32))]}
    for key, windows in want.items():
        got = sorted(tuple(map(tuple, s.index))
                     for s in man.tensors[key].shards)
        assert got == windows, key       # each window once
    assert man.extra["quantized"] == [QUANT_KEY]
    glob = _globals()
    with RefManager(str(ckpt), config=RefConfig(
            backend="posix", strategy="single_file", direct=False)) as m:
        ref = m.restore(step=1)
    with CheckpointManager(str(ckpt), device="cpu") as m:
        port = m.restore(step=1)
    for k in "abcd":
        np.testing.assert_array_equal(np.asarray(ref["params"][k]), glob[k])
        np.testing.assert_array_equal(tensor_to_numpy(port["params"][k]),
                                      glob[k])
    np.testing.assert_array_equal(np.asarray(ref["opt"]["mu"]["x"]),
                                  tensor_to_numpy(port["opt"]["mu"]["x"]))
    assert port["note"] == ref["note"] == "dtensor"


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
