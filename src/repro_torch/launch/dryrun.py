"""Dry run of every (arch x shape x mesh) cell: each cell's step runs on
``meta`` DTensors over a fake process group of the mesh's size.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's step with XLA and reads XLA's memory and cost analyses and the HLO's
collectives. Here the step itself runs — the train step (forward, backward,
AdamW), the prefill step, or ``decode_step`` on the serve layouts — on the
production mesh (16 x 16 or 2 x 16 x 16, or ``mesh_split``'s), as rank 0
of a fake process group (``FakeStore``, backend ``"fake"``: collectives
return without moving a byte) whose tensors live on ``meta``: nothing is
allocated and no device is needed. Per device it reports

    argument_bytes    — the step's arguments: state + batch (train), params +
                        batch (prefill), params + cache + token + pos (decode)
    local_shapes      — every argument leaf's per-device shape
    flops             — the rank's FLOPs, counted on its local blocks by
                        ``torch.utils.flop_counter.FlopCounterMode``'s
                        formulas (matmuls, attention, convolutions)
    collective_bytes  — the result bytes of every collective the rank
                        issues, by kind, under the reference's names
                        (all-gather, all-reduce, reduce-scatter,
                        all-to-all, collective-permute) and a ``count``,
                        seen by ``torch.distributed.tensor.debug.
                        CommDebugMode``; ``all_gather_shapes`` and
                        ``all_gather_counts`` the all-gathers' result
                        shapes (gathered along dim 0, as the collective
                        returns them) and how many of each
    output_bytes      — the step's returned local bytes (each storage once)
    alias_bytes       — those of them that are argument storage: the state
                        AdamW updates in place (train), the decode caches
                        (decode); the reference's donated buffers
    peak_hbm_bytes    — the most local bytes live at once during the step,
                        arguments included (``LiveBytes``: each op's new
                        storages allocated at its output, freed when the
                        storage dies, views sharing their base's)
    temp_bytes        — the rest of the peak, under the reference's
                        identity peak = argument + output + temp - alias

beside the model's ``params`` / ``active_params``. Pure full-attention
archs skip ``long_500k``, as in the reference. A torch counter counts every
trip of a loop (layers, microbatches, remat recomputes), where XLA counts a
while body once (``benchmarks/roofline.py``): hold these FLOPs to closed
forms, not to the reference's number. The bytes are storage sizes as the
ops ask for them: the CUDA caching allocator's rounding, cuBLAS's
workspaces and the temporaries inside a kernel (a plain version on
``meta`` may allocate other ones) are not seen. The reference's
``cpu_cast_artifact_bytes`` and ``tpu_adjusted_peak_bytes`` correct XLA's
CPU compile for float32 copies of bf16 operands that a TPU's MXU does not
make; this dry run compiles nothing and runs every op in its own dtype, so
they have no counterpart. A sweep runs ``PROCESSES`` cells at once, each in
a fresh process; ``--specs-only`` resolves the layouts alone (argument
bytes and local shapes, in seconds).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --all --both-meshes
    python -m repro_torch.launch.dryrun --all --both-meshes --specs-only
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import is_traceable_wrapper_subclass
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config
from ..core.serialization import tree_leaves_with_path, tree_map_with_path
from ..models.config import SHAPES_BY_NAME
from ..sharding.partition import Layout, Partitioner
from ..train.steps import make_prefill_step, make_serve_step, make_train_step
from .mesh import AbstractMesh, make_production_mesh
from .specs import ArgSpec, arg_leaves, cell_args, input_specs, local_bytes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (the ops DTensor's redistributions issue) by kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
_FUNCOL = ("_c10d_functional", "c10d_functional")
PROCESSES = min(4, os.cpu_count() or 1)   # a train cell's process: ~1 GB


# ops whose result is their input on a device, where their meta kernels
# return a fresh tensor
_ALIASING = ("_wrap_tensor_autograd", "wait_tensor")


class LiveBytes:
    """The bytes of the storages live at once, and their peak: a storage
    counts from the op output that first shows it until it dies (a weak
    reference's callback), so a view costs nothing and an in-place op's
    result is its input. On ``meta`` it allocates nothing and counts what
    the same ops on a device would ask its allocator for. Storages that
    are one allocation on a device (``_ALIASING``) share one count, freed
    with the last of them."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._refs: dict[int, tuple[weakref.ref, list]] = {}

    def track(self, t: torch.Tensor, alias_of: torch.Tensor | None = None
              ) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        base = None if alias_of is None else self._refs.get(
            alias_of.untyped_storage()._cdata)
        if base is not None:
            entry = base[1]            # [bytes, storages alive]
            entry[1] += 1
        else:
            entry = [st.nbytes(), 1]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)

        def gone(_ref, key=key, entry=entry):
            self._refs.pop(key, None)
            entry[1] -= 1
            if not entry[1]:
                self.live -= entry[0]
        self._refs[key] = (weakref.ref(st, gone), entry)

    def track_op(self, name: str, args, out) -> None:
        src = args[0] if name in _ALIASING and args and isinstance(
            args[0], torch.Tensor) else None
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                for inner in _inner(t):
                    self.track(inner, src)


def _inner(t: torch.Tensor) -> list[torch.Tensor]:
    """The plain tensors holding a tensor's bytes: a wrapper subclass (a
    DTensor's local block, a collective's result still in flight) is
    looked through."""
    if not is_traceable_wrapper_subclass(t):
        return [t]
    names, _ = t.__tensor_flatten__()
    return [x for n in names if isinstance(getattr(t, n), torch.Tensor)
            for x in _inner(getattr(t, n))]


def local_tensors(tree) -> list[torch.Tensor]:
    """The plain tensors of a tree's tensor leaves."""
    return [x for _p, t in tree_leaves_with_path(tree)
            if isinstance(t, torch.Tensor) for x in _inner(t)]


def storages(tree) -> dict[int, int]:
    """{storage key: bytes} of the local tensors of a tree's leaves."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in local_tensors(tree)}


class CostMode(CommDebugMode):
    """``CommDebugMode`` that tallies, on the rank's local tensors, the
    FLOPs of every op (``FlopCounterMode``'s formulas) and the result bytes
    of every collective by kind (``comm_counts`` counts them as
    ``CommDebugMode`` does); ``gathers`` lists each all-gather's (result
    shape, bytes) — ``all_gather_shapes`` in a cell's record. DTensor ops
    pass through to DTensor, whose local ops and collectives come back
    through this mode; the fake-tensor ops of DTensor's sharding
    propagation (global shapes, run once per op signature) are not
    counted. Its dispatch is its own, without ``CommDebugMode``'s per-op
    records of module and shapes, which would double a cell's time."""

    def __init__(self):
        super().__init__()
        self.counter = FlopCounterMode(display=False)
        self.memory = LiveBytes()
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.collective_bytes["count"] = 0
        self.gathers: list[tuple[tuple, int]] = []

    @property
    def flops(self) -> int:
        return self.counter.get_total_flops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented           # DTensor desugars it first
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.HigherOrderOperator) or _fake(args):
            return out
        packet = func._overloadpacket
        ns, _, name = packet._qualified_op_name.partition("::")
        self.memory.track_op(name, args, out)
        kind = _KINDS.get(name)
        if ns in _FUNCOL and kind:
            self.comm_counts[packet] += 1
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            self.collective_bytes[kind] += nbytes
            self.collective_bytes["count"] += 1
            if kind == "all-gather":
                self.gathers += [(tuple(t.shape), t.numel()
                                  * t.element_size()) for t in outs]
        else:
            self.counter._count_flops(packet, out, args, kwargs or {})
        return out


def _fake(args) -> bool:
    """Whether an op's arguments (one level of lists looked into) are
    fake tensors."""
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, FakeTensor):
                return True
    return False


@contextlib.contextmanager
def fake_mesh(sizes: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``sizes`` over a fake process group in which
    this process is rank 0; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a "
                           "torch.distributed process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(sizes)))
    try:
        yield init_device_mesh("cpu", sizes, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _local_dtensors(tree, device: str = "meta"):
    """An ``ArgSpec`` tree as DTensors of ``meta`` local blocks (zeros on
    another ``device``: valid token ids and positions)."""
    def one(_path, s):
        if not isinstance(s, ArgSpec):
            return s
        local = (torch.empty if device == "meta" else torch.zeros)(
            s.local_shape, dtype=s.dtype, device=device)
        return DTensor.from_local(
            local, s.layout.mesh, s.layout.placements_for(s.shape),
            run_check=False, shape=torch.Size(s.shape),
            stride=torch.empty(s.shape, device="meta").stride())
    return tree_map_with_path(one, tree, is_leaf=lambda x: isinstance(
        x, ArgSpec))


def default_microbatches(cfg, shape, mesh) -> int:
    """The reference's gradient-accumulation depth: one sample per DP
    shard per microbatch, capped at 16."""
    return max(1, min(16, shape.global_batch
                      // Partitioner(cfg, mesh).dp_size))


def act_layout(cfg, mesh, batch: int, seq_parallel: bool = False) -> Layout:
    """The residual stream's layout: the batch over the DP axes where it
    divides; with ``seq_parallel`` the sequence over ``model`` as well
    (Megatron-style SP, the reference's ``_act_sharding``)."""
    part = Partitioner(cfg, mesh)
    bdim, = part.batch_spec(batch)
    return part.layout((bdim, "model" if seq_parallel else None, None))


def run_step(cfg, shape, mesh, info: dict, microbatches: int | None = None,
             seq_parallel: bool = False, device: str = "meta"
             ) -> tuple[CostMode, int, dict]:
    """Run one cell's step on ``meta`` DTensors (or zeros on ``device``)
    under ``CostMode``; returns the mode, the microbatches the train step
    took and the memory fields of ``per_device``."""
    mode = info["mode"]
    mb = 1
    if mode == "train":
        state_specs, batch_specs, shardings = info["specs"]
        mb = microbatches or default_microbatches(cfg, shape, mesh)
        step = make_train_step(
            cfg, microbatches=mb, grad_shardings=shardings["opt"]["mu"],
            act_sharding=act_layout(cfg, mesh, shape.global_batch // mb,
                                    seq_parallel))
        args = (state_specs, batch_specs)
    elif mode == "prefill":
        param_specs, batch_specs, _ = info["specs"]
        step = make_prefill_step(cfg, act_sharding=act_layout(
            cfg, mesh, shape.global_batch, seq_parallel))
        args = (param_specs, batch_specs)
    else:
        step = make_serve_step(cfg, act_sharding=act_layout(
            cfg, mesh, shape.global_batch))
        args = cell_args(info)
    args = tuple(_local_dtensors(a, device) for a in args)
    argument = storages(args)
    cost = CostMode()
    for t in local_tensors(args):              # live from the start
        cost.memory.track(t)
    with cost:
        out = step(*args)
    outputs = storages(out)
    output = sum(outputs.values())
    alias = sum(n for k, n in outputs.items() if k in argument)
    peak = cost.memory.peak
    memory = {"output_bytes": output, "alias_bytes": alias,
              "temp_bytes": peak - sum(argument.values()) - output + alias,
              "peak_hbm_bytes": peak}
    return cost, mb, memory


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             mesh_split: tuple[int, int] | None = None,
             microbatches: int | None = None,
             seq_parallel: bool = False, step: bool = True) -> dict:
    """One cell on the 16x16 mesh, 2x16x16 with ``multi_pod``, or a
    ``mesh_split=(dp, tp)`` (data, model) mesh (hillclimb what-ifs);
    ``microbatches`` overrides the train step's accumulation depth and
    ``seq_parallel`` splits the residual stream's sequence over
    ``model``. ``step=False`` resolves the layouts alone (argument bytes
    and local shapes, no process group, no step run)."""
    if mesh_split is not None:
        sizes, names = tuple(mesh_split), ("data", "model")
    else:
        prod = make_production_mesh(multi_pod=multi_pod)
        sizes, names = prod.axis_sizes, prod.axis_names
    return measure_cell(get_config(arch), SHAPES_BY_NAME[shape_name], sizes,
                        names, microbatches, seq_parallel, step)


def measure_cell(cfg, shape, sizes: tuple[int, ...],
                 names: tuple[str, ...], microbatches: int | None = None,
                 seq_parallel: bool = False, step: bool = True) -> dict:
    """``run_cell`` for any config and ``ShapeConfig`` on a mesh of
    ``sizes`` named ``names``."""
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": "x".join(map(str, sizes)), "mode": shape.kind,
           "status": "ok", "microbatches": microbatches,
           "seq_parallel": seq_parallel}
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md §6)")
        return rec
    try:
        t0 = time.perf_counter()
        with (fake_mesh(sizes, names) if step else contextlib.nullcontext(
                AbstractMesh(sizes, names))) as mesh:
            info = input_specs(cfg, shape, mesh)
            args = cell_args(info)
            leaves = [(f"{i}/{k}", s) for i, t in enumerate(args)
                      for k, s in arg_leaves(t)]
            for _, s in leaves:        # every split even, as the rules say
                s.layout.placements_for(s.shape)
            rec.update(devices=int(np.prod(sizes)),
                       specs_s=round(time.perf_counter() - t0, 3))
            per_device = {
                "argument_bytes": local_bytes(*args),
                "local_shapes": {k: list(s.local_shape) for k, s in leaves}}
            if step:
                cost, mb, memory = run_step(cfg, shape, mesh, info,
                                            microbatches, seq_parallel)
                if shape.kind == "train":
                    rec["microbatches"] = mb
                rec["step_s"] = round(time.perf_counter() - t0
                                      - rec["specs_s"], 3)
                per_device.update(
                    memory,
                    flops=cost.flops, collective_bytes=cost.collective_bytes,
                    all_gather_shapes=sorted({s for s, _ in cost.gathers}),
                    all_gather_counts=dict(collections.Counter(
                        "x".join(map(str, s)) for s, _ in cost.gathers)))
        rec["per_device"] = per_device
        rec["model"] = {"params": cfg.param_count(),
                        "active_params": cfg.active_param_count()}
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _run_cell_args(cell) -> dict:
    arch, shape, multi_pod, step = cell
    return run_cell(arch, shape, multi_pod=multi_pod, step=step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--specs-only", action="store_true",
                    help="argument bytes and local shapes only: no step run")
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
    t0 = time.perf_counter()
    todo = [(arch, shape, mp, not args.specs_only) for arch, shape in cells
            for mp in meshes]
    with contextlib.ExitStack() as stack:
        if len(todo) > 1 and not args.specs_only:
            # steps run PROCESSES cells at once, each in a fresh process
            # (one fake process group per process)
            import multiprocessing
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(PROCESSES, initializer=torch.set_num_threads,
                              initargs=(1,), maxtasksperchild=1))
            recs = pool.imap(_run_cell_args, todo)
        else:
            recs = map(_run_cell_args, todo)
        for rec in recs:
            results.append(rec)
            pd = rec.get("per_device", {})
            coll = pd.get("collective_bytes", {})
            print(f"[{rec['status']:7s}] {rec['arch']:22s} "
                  f"{rec['shape']:12s} {rec['mesh']:8s} "
                  f"args={pd.get('argument_bytes', 0) / 1e9:8.3f}GB "
                  f"peak={pd.get('peak_hbm_bytes', 0) / 1e9:8.3f}GB "
                  f"flops={pd.get('flops', 0):.3e} "
                  f"coll={sum(v for k, v in coll.items() if k != 'count') / 1e6:10.1f}MB "
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
          f"{len(bad)} errors, {time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
