"""Checkpoint/restore engines (paper §3.5).

- ``aggregated``  — the paper's "ideal approach", productionized.

The baseline engines of ``repro.core.engines`` (``datastates``,
``snapshot``, ``torchsave``) and the remote read engine are not carried into
the PyTorch package yet.
"""

from .base import (ChecksumError, CREngine, EngineConfig, IOStats, ReadReq,
                   ReadStream, SaveItem, SaveSpec, SaveStream, spec_of)
from .aggregated import AggregatedEngine

ENGINES: dict[str, type[CREngine]] = {
    "aggregated": AggregatedEngine,
}


def make_cr_engine(name: str, config: EngineConfig | None = None,
                   pool=None) -> CREngine:
    return ENGINES[name](config, pool)

__all__ = ["ChecksumError", "CREngine", "EngineConfig", "IOStats", "ReadReq",
           "ReadStream", "SaveItem", "SaveSpec", "SaveStream", "spec_of",
           "AggregatedEngine", "ENGINES", "make_cr_engine"]
