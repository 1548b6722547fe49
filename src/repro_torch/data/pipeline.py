"""Deterministic, shardable, checkpointable synthetic data pipeline.

Carried from ``repro/data/pipeline.py`` (numpy only): the same seed gives the
same batches in both packages, so a run resumes across them. The host index
and count come from ``torch.distributed`` when a process group is
initialised (``host_info``), else 0 and 1.

Each (step, host) pair maps to an independent counter-based PRNG stream, so:
  · any host can regenerate any step (restart determinism — the pipeline
    state that must be checkpointed is just the step counter),
  · elastic restarts onto a different host count re-partition the global
    batch without replaying data,
  · no host ever materializes another host's shard.

Batches model a language-modeling token stream with structure (Zipf-ish
unigram + short-range repetition) so losses actually decrease during the
end-to-end example runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_len: int = 0
    frontend_dim: int = 0


@dataclass
class PipelineState:
    """The only thing the checkpoint needs to capture."""
    step: int = 0


def host_info() -> tuple[int, int]:
    """(host index, host count) of this process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, state: PipelineState | None = None):
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide host_count")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.state = state or PipelineState()

    # -- deterministic per-(step,host) generation ---------------------------
    def _rng(self, step: int) -> np.random.Generator:
        seq = np.random.SeedSequence(
            [self.cfg.seed, step, self.host_index, 0xC0FFEE])
        return np.random.default_rng(seq)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self.local_batch, cfg.seq_len
        # Zipf-ish unigram distribution with banded repetition
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tokens = (base % (cfg.vocab_size - 2)) + 1
        # inject copy structure: second half repeats first half shifted
        half = S // 2
        if half > 4:
            tokens[:, half:half * 2] = tokens[:, :half]
        tokens = tokens.astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.frontend_len:
            out["frontend_embeds"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpoint integration ---------------------------------------------
    def state_dict(self) -> dict:
        return {"data_step": self.state.step}

    def load_state_dict(self, d: dict) -> None:
        self.state.step = int(d["data_step"])
