"""Fault-tolerant training loop with async checkpointing.

Counterpart of ``repro/train/trainer.py`` on this package's
``CheckpointManager``: the same ``TrainerConfig``, the same checkpointed tree
``{"train": train state, "data": pipeline state}`` (so a run checkpointed by
either package resumes in the other), auto-resume from the latest step,
checkpoint-every-N with versioned GC, and the same report (``metrics_log``,
the metrics registry, the save stall attribution when tracing is on).

The train step updates the state in place, so before every step the loop
waits until an in-flight async save holds its snapshot
(``wait_snapshotted()``) and counts that wait as checkpoint stall.

Not here yet: the two-level (``multilevel_remote``, ROADMAP A3) and
multi-writer (``ckpt_writers > 1``, ROADMAP A2) checkpointers, and meshes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch

from ..core import CheckpointManager, EngineConfig
from ..core import trace
from ..data import DataConfig, SyntheticPipeline, host_info
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from .steps import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 0                  # 0 = no checkpointing
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_engine: str = "aggregated"
    async_ckpt: bool = True
    streaming_ckpt: bool = True          # SnapshotPipeline save path
    multilevel_remote: str = ""          # two-level C/R: not ported yet
    ckpt_writers: int = 0                # > 1: not ported yet
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    trace: bool = False                  # span tracer on for the whole run
    trace_dir: str = ""                  # Perfetto + .prom exports land here


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig | None = None,
                 engine_config: EngineConfig | None = None,
                 data_cfg: DataConfig | None = None, device="cuda"):
        if tcfg.multilevel_remote:
            raise NotImplementedError(
                "multilevel_remote: the two-level checkpointer is not ported "
                "yet (ROADMAP A3)")
        if tcfg.ckpt_writers > 1:
            raise NotImplementedError(
                "ckpt_writers > 1: the multi-writer checkpointer is not "
                "ported yet (ROADMAP A2)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
            seed=tcfg.seed, frontend_len=cfg.frontend_len,
            frontend_dim=cfg.frontend_dim)
        self.pipeline = SyntheticPipeline(self.data_cfg, *host_info())
        self.ckpt = None
        if tcfg.ckpt_every:
            self.ckpt = CheckpointManager(
                tcfg.ckpt_dir, engine=tcfg.ckpt_engine, config=engine_config,
                async_save=tcfg.async_ckpt, keep=tcfg.keep,
                streaming=tcfg.streaming_ckpt, device=self.device)
        self.metrics_log: list[dict] = []
        self.save_log: list = []         # SaveMetrics of every save, in order
        self.restore_attr: dict = {}
        # one queryable tree over every Stats producer in the stack
        self.registry = trace.MetricsRegistry()
        if self.ckpt is not None:
            self.registry.register(
                "save", lambda: getattr(self.ckpt, "last_save_metrics", None))
            self.registry.register(
                "restore",
                lambda: getattr(self.ckpt, "last_restore_metrics", None))

    # ------------------------------------------------------------------ state
    def init_state(self):
        return init_train_state(self.cfg, seed=self.tcfg.seed,
                                device=self.device)

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
        t0 = time.perf_counter()
        restored = self.ckpt.restore(
            state_template=self._full_state(template), step=latest)
        self._sync()
        restore_wall = time.perf_counter() - t0
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
        return state, int(state["step"])

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
        step_fn = make_train_step(self.cfg, self.opt_cfg)
        ckpt_block_s = 0.0
        snapshot_wait_s = 0.0            # the wait_snapshotted() part of it
        ckpt_reported_block_s = 0.0      # sum of SaveMetrics.blocking_seconds
        t_start = time.perf_counter()
        for step in range(start_step, self.tcfg.steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            if self.ckpt is not None:
                # the step updates the state in place, which an in-flight
                # pipelined save may still be reading — barrier on the
                # staged snapshot (NOT the flush), and count it as stall
                t0 = time.perf_counter()
                self.ckpt.wait_snapshotted()
                waited = time.perf_counter() - t0
                ckpt_block_s += waited
                snapshot_wait_s += waited
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch)
            self.pipeline.state.step = step + 1
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                # reading the metrics waited for the step: host wall of it
                m["seconds"] = time.perf_counter() - t_step
                self.metrics_log.append(m)
            if (self.ckpt is not None and self.tcfg.ckpt_every
                    and (step + 1) % self.tcfg.ckpt_every == 0):
                t0 = time.perf_counter()
                sm = self.ckpt.save(step + 1, self._full_state(state))
                ckpt_block_s += time.perf_counter() - t0
                self.save_log.append(sm)
                ckpt_reported_block_s += sm.blocking_seconds
        self._sync()
        wall = time.perf_counter() - t_start
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
        return None if self.ckpt is None else self.ckpt.latest_step()

    def close(self):
        if self.ckpt is not None:
            self.ckpt.close()
