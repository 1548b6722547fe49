"""Fault-tolerant training loop with async checkpointing.

Counterpart of ``repro/train/trainer.py`` on this package's
``CheckpointManager``: the same ``TrainerConfig``, the same checkpointed tree
``{"train": train state, "data": pipeline state}`` (so a run checkpointed by
either package resumes in the other), auto-resume from the latest step,
checkpoint-every-N with versioned GC, and the same report (``metrics_log``,
the save stall attribution when tracing is on).

With the tracer on (``TrainerConfig.trace``, or ``trace.enable()`` by the
caller) the loop records host spans ``train.batch``, ``train.snapshot_wait``
(the first wait after a save), ``train.step`` (the batch's upload, the
step and its logged metrics' read), ``train.save`` (the blocking call) and
``train.restore``; on CUDA also a ``train.step`` span of tier ``device``
a step, from two events around the upload and the step, put on the
tracer's clock through an anchor event stamped after one synchronise at
the start of ``run()``.

The train step updates the state in place, so before every step the loop
waits until an in-flight async save holds its snapshot
(``wait_snapshotted()``) and counts that wait as checkpoint stall.

``multilevel_remote`` adds a level-1 directory: every save commits at level
0 and flushes to it in the background, and a resume whose step is only at
level 1 (node loss) is prefetched into level 0 first. ``ckpt_writers > 1``
saves through N concurrent writer ranks (``MultiWriterCheckpointer``): the
state is row-partitioned per save and rank 0 merge-commits the step; its
``wait_snapshotted()`` waits for every rank's staging.

``mesh`` (a named ``("data", "model")`` DeviceMesh, ``launch.mesh``) runs
the loop on DTensors, one process per mesh rank, in the layouts of
``sharding.partition.Partitioner``: the state is initialised whole from the
same seeded generator and each rank keeps its windows (the logical values
equal the unsharded init's), a resume reads only this rank's windows
through ``restore(shardings=)`` onto a ``meta`` template, and the batch
goes in at the tokens' layout. Every rank draws the global batch as host 0
of 1 and keeps its data-parallel rows, so model-parallel ranks see the same
rows and the run sees the batch of an unsharded run. With more than one
rank, every rank saves its own windows into one checkpoint, committed once
(``process_group_manager``, over a gloo group of its own). With
``multilevel_remote`` too, that group checkpoint is two-level
(``GroupMultiLevelCheckpointer``): rank 0 flushes each committed step to
level 1, every rank raises a failed flush, the ranks agree on the step to
resume, and after node loss each rank prefetches its own windows' extents
from level 1 into one staging dir that rank 0 promotes — on any mesh shape,
so a run saved on 2x2 resumes on 1x4. ``ckpt_writers > 1`` on any mesh
(1x1 included) nests N writer threads in each rank
(``MultiWriterCheckpointer(process_group=)`` over the same gloo group):
each rank splits the rows of its own windows over its threads, and the
M x N writers commit one step, which resumes through ``restore(shardings=)``
as any group checkpoint does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..core import (CheckpointManager, EngineConfig, MultiLevelCheckpointer,
                    MultiWriterCheckpointer)
from ..core import trace
from ..data import DataConfig, SyntheticPipeline, host_info
from ..core.checkpoint import mesh_device
from ..core.grouplevel import GroupMultiLevelCheckpointer
from ..core.multiwriter import process_group_manager
from ..core.serialization import path_str, tree_leaves_with_path
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from ..sharding.dtensor import is_dtensor
from ..sharding.partition import Layout, Partitioner, shard_tree
from .steps import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 0                  # 0 = no checkpointing
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_engine: str = "aggregated"
    async_ckpt: bool = True
    streaming_ckpt: bool = True          # SnapshotPipeline save path
    multilevel_remote: str = ""          # level-1 dir: two-level C/R
    ckpt_writers: int = 0                # > 1: N concurrent writer ranks
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    trace: bool = False                  # span tracer on for the whole run
    trace_dir: str = ""                  # Perfetto + .prom exports land here


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig | None = None,
                 engine_config: EngineConfig | None = None,
                 data_cfg: DataConfig | None = None, device="cuda",
                 mesh=None):
        if tcfg.multilevel_remote and tcfg.ckpt_writers > 1:
            raise ValueError(
                "multilevel_remote and ckpt_writers > 1 are mutually "
                "exclusive: the two-level flusher wraps a single manager")
        group_ckpt = mesh is not None and mesh.size() > 1
        nested = (mesh is not None and tcfg.ckpt_every
                  and tcfg.ckpt_writers > 1)
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        # under a mesh, this rank's device of it
        self.device = torch.device(device) if mesh is None \
            else mesh_device(mesh)
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
            seed=tcfg.seed, frontend_len=cfg.frontend_len,
            frontend_dim=cfg.frontend_dim)
        self.grad_shardings = self.act_sharding = None
        if mesh is None:
            self.pipeline = SyntheticPipeline(self.data_cfg, *host_info())
        else:
            # the global batch on every rank (host 0 of 1), which keeps
            # its rows of it: the tokens' layout splits the batch over data
            self.pipeline = SyntheticPipeline(self.data_cfg, 0, 1)
            self._mesh_layouts()
        self.ckpt = None
        if nested:
            # N writer threads in each rank, committing over a gloo group
            import torch.distributed as dist
            self.ckpt = MultiWriterCheckpointer(
                tcfg.ckpt_dir, tcfg.ckpt_writers,
                process_group=dist.new_group(backend="gloo"),
                engine=tcfg.ckpt_engine, config=engine_config,
                async_save=tcfg.async_ckpt, keep=tcfg.keep,
                streaming=tcfg.streaming_ckpt, device=self.device)
        elif group_ckpt and (tcfg.multilevel_remote or tcfg.ckpt_every):
            import torch.distributed as dist
            group = dist.new_group(backend="gloo")
            if tcfg.multilevel_remote:
                self.ckpt = GroupMultiLevelCheckpointer(
                    tcfg.ckpt_dir, tcfg.multilevel_remote, group,
                    engine=tcfg.ckpt_engine, config=engine_config,
                    async_save=False, keep=tcfg.keep,
                    streaming=tcfg.streaming_ckpt, device=self.device)
            else:
                self.ckpt = process_group_manager(
                    tcfg.ckpt_dir, group, engine=tcfg.ckpt_engine,
                    config=engine_config, async_save=tcfg.async_ckpt,
                    keep=tcfg.keep, streaming=tcfg.streaming_ckpt,
                    device=self.device)
        elif tcfg.multilevel_remote:
            self.ckpt = MultiLevelCheckpointer(
                tcfg.ckpt_dir, tcfg.multilevel_remote,
                engine=tcfg.ckpt_engine, config=engine_config,
                async_save=False, keep=tcfg.keep,
                streaming=tcfg.streaming_ckpt, device=self.device)
        elif tcfg.ckpt_every and tcfg.ckpt_writers > 1:
            # N concurrent writer ranks over one directory: the state is
            # row-partitioned per save, every rank flushes its windows, and
            # rank 0 merge-commits the step (restore is elastic: any later
            # run - multi-writer or not - reads the merged manifest)
            self.ckpt = MultiWriterCheckpointer(
                tcfg.ckpt_dir, tcfg.ckpt_writers,
                engine=tcfg.ckpt_engine, config=engine_config,
                async_save=tcfg.async_ckpt, keep=tcfg.keep,
                streaming=tcfg.streaming_ckpt, device=self.device)
        elif tcfg.ckpt_every:
            self.ckpt = CheckpointManager(
                tcfg.ckpt_dir, engine=tcfg.ckpt_engine, config=engine_config,
                async_save=tcfg.async_ckpt, keep=tcfg.keep,
                streaming=tcfg.streaming_ckpt, device=self.device)
        self.metrics_log: list[dict] = []
        self.on_log = None               # called with each logged dict
        self.save_log: list = []         # SaveMetrics of every save, in order
        self.restore_attr: dict = {}

    # ------------------------------------------------------------------ state
    def _mesh_layouts(self) -> None:
        """The Partitioner's layouts of the state, the batch and the
        residual stream."""
        part = Partitioner(self.cfg, self.mesh)
        self.shardings = part.state_shardings(
            init_train_state(self.cfg, device="meta"))
        B = self.data_cfg.global_batch
        self.batch_layouts = {"tokens": part.tokens_sharding(B),
                              "labels": part.tokens_sharding(B),
                              "frontend_embeds": part.frontend_sharding(B)}
        self.act_sharding = part.layout(part.activation_spec(B))
        self.grad_shardings = self.shardings["opt"]["mu"]   # ZeRO-2

    def init_state(self):
        state = init_train_state(self.cfg, seed=self.tcfg.seed,
                                 device=self.device)
        if self.mesh is None:
            return state
        return shard_tree(state, self.shardings)

    def restore_shardings(self) -> dict | None:
        """{checkpoint key: Layout} of the train state under the mesh
        (None without one)."""
        if self.mesh is None:
            return None
        return {path_str(("train",) + tuple(p)): lay
                for p, lay in tree_leaves_with_path(
                    self.shardings, is_leaf=lambda x: isinstance(x, Layout))}

    def _full_state(self, train_state):
        return {"train": train_state, "data": self.pipeline.state_dict()}

    def initial_state(self):
        """(train state, first step): the latest checkpoint restored onto
        the trainer's device when there is one (its layout from a ``meta``
        template, so no second state is allocated), else a fresh init."""
        latest = self._latest()
        if latest is None:
            return self.init_state(), 0
        template = init_train_state(self.cfg, seed=self.tcfg.seed,
                                    device="meta")
        t0 = trace.clock()
        with trace.span("train.restore", attrs={"step": latest}):
            restored = self.ckpt.restore(
                state_template=self._full_state(template), step=latest,
                shardings=self.restore_shardings())
            self._sync()
        restore_wall = trace.clock() - t0
        state = restored["train"]
        self.pipeline.load_state_dict(restored["data"])
        # stall attribution: where the resume time went (streaming restores
        # overlap stages, so they no longer sum to wall)
        rm = self.ckpt.last_restore_metrics
        self.restore_attr = {"restore_seconds": restore_wall}
        if rm is not None:
            self.restore_attr.update(
                restore_mode=rm.mode,
                restore_read_stall_s=rm.read_stall_seconds,
                restore_decode_s=rm.decode_seconds,
                restore_assemble_s=rm.assemble_seconds,
                restore_h2d_s=rm.h2d_seconds,
                restore_overlap_s=rm.overlap_seconds,
                restore_peak_staged_bytes=rm.peak_staged_bytes)
        step = state["step"]
        return state, int(step.to_local() if is_dtensor(step) else step)

    # ------------------------------------------------------------------ run
    def run(self, initial=None) -> dict:
        """Train to ``tcfg.steps``. ``initial``: the ``initial_state()``
        result to start from (it is called when None)."""
        if self.tcfg.trace:
            trace.enable()
        try:
            return self._run_traced(initial)
        finally:
            if self.tcfg.trace:
                self._export_trace()
                trace.disable()

    def _export_trace(self) -> None:
        d = self.tcfg.trace_dir or self.tcfg.ckpt_dir
        os.makedirs(d, exist_ok=True)
        trace.export_perfetto(os.path.join(d, "trace.json"))
        trace.export_prometheus(os.path.join(d, "metrics.prom"))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_traced(self, initial) -> dict:
        state, start_step = initial if initial is not None \
            else self.initial_state()
        step_fn = make_train_step(self.cfg, self.opt_cfg,
                                  grad_shardings=self.grad_shardings,
                                  act_sharding=self.act_sharding)
        traced = trace.is_enabled()
        device_steps = _DeviceSteps(self.device) \
            if traced and self.device.type == "cuda" else None
        ckpt_block_s = 0.0
        snapshot_wait_s = 0.0            # the wait_snapshotted() part of it
        ckpt_reported_block_s = 0.0      # sum of SaveMetrics.blocking_seconds
        saved = False                    # a save since the last step
        t_start = trace.clock()
        for step in range(start_step, self.tcfg.steps):
            attrs = {"step": step} if traced else None
            with trace.span("train.batch", attrs=attrs):
                host_batch = self.pipeline.batch_at(step)
            if self.ckpt is not None:
                # the step updates the state in place, which an in-flight
                # pipelined save may still be reading — barrier on the
                # staged snapshot (NOT the flush), and count it as stall
                t0 = trace.clock()
                self.ckpt.wait_snapshotted()
                t1 = trace.clock()
                ckpt_block_s += t1 - t0
                snapshot_wait_s += t1 - t0
                if saved:
                    trace.complete("train.snapshot_wait", t0, t1,
                                   attrs=attrs)
                    saved = False
            m = None
            with trace.span("train.step", attrs=attrs):
                if device_steps is not None:
                    device_steps.begin()
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in host_batch.items()}
                if self.mesh is not None:
                    batch = {k: self.batch_layouts[k].distribute(v)
                             for k, v in batch.items()}
                t_step = trace.clock()
                state, metrics = step_fn(state, batch)
                if device_steps is not None:
                    device_steps.end(step)
                self.pipeline.state.step = step + 1
                if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    # reading the metrics waited for the step: host wall
                    m["seconds"] = trace.clock() - t_step
                    self.metrics_log.append(m)
            if m is not None and self.on_log is not None:
                self.on_log(m)
            if (self.ckpt is not None and self.tcfg.ckpt_every
                    and (step + 1) % self.tcfg.ckpt_every == 0):
                t0 = trace.clock()
                with trace.span("train.save", attrs=attrs):
                    sm = self.ckpt.save(step + 1, self._full_state(state))
                ckpt_block_s += trace.clock() - t0
                self.save_log.append(sm)
                ckpt_reported_block_s += sm.blocking_seconds
                saved = True
        self._sync()
        wall = trace.clock() - t_start
        if device_steps is not None:
            device_steps.record()
        if self.ckpt is not None:
            self.ckpt.wait()
        out = {"state": state, "wall_seconds": wall,
               "ckpt_blocking_seconds": ckpt_block_s,
               "ckpt_blocking_reported_s": ckpt_reported_block_s,
               "ckpt_snapshot_wait_seconds": snapshot_wait_s,
               "start_step": start_step,
               "metrics": self.metrics_log, **self.restore_attr}
        if trace.is_enabled():
            rep = trace.stall_report(root="save")
            if rep is not None:
                out["stall_report"] = rep.attribution
                out["stall_wall_seconds"] = rep.wall
        return out

    def _latest(self):
        """Newest step at any level (level 1 included: after node loss a
        step may be there only); on a group checkpoint, the step every
        rank agreed on."""
        if self.ckpt is None:
            return None
        if isinstance(self.ckpt, GroupMultiLevelCheckpointer):
            return self.ckpt.latest_step()
        if isinstance(self.ckpt, MultiLevelCheckpointer):
            steps = sorted(set(self.ckpt.local.all_steps())
                           | set(self.ckpt._remote_steps()))
            return steps[-1] if steps else None
        return self.ckpt.latest_step()

    def close(self):
        if self.ckpt is not None:
            self.ckpt.close()


class _DeviceSteps:
    """Each step's device interval as a ``train.step`` span (tier
    ``device``) on the tracer's clock.

    One synchronise, then an anchor event on the current stream stamped
    with ``trace.clock()``: the stream is idle, so the card passes the
    anchor at that instant. Two events a step bracket its work in stream
    order; once the run has synchronised, each pair's times since the
    anchor place the step on the clock. No other synchronise is added."""

    def __init__(self, device):
        self.stream = torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        self.anchor = self._event()
        self.c0 = trace.clock()
        self.steps: list = []            # (step, start event, end event)
        self._start = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def begin(self) -> None:
        self._start = self._event()

    def end(self, step: int) -> None:
        self.steps.append((step, self._start, self._event()))

    def record(self) -> None:
        """The spans, once the run has synchronised."""
        for step, a, b in self.steps:
            trace.complete(
                "train.step", self.c0 + self.anchor.elapsed_time(a) / 1e3,
                self.c0 + self.anchor.elapsed_time(b) / 1e3, tier="device",
                attrs={"step": step})
