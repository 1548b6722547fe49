"""Checkpoint/restore engines (paper §3.5): one interface, four designs.

- ``aggregated``  — the paper's "ideal approach", productionized (ours).
- ``datastates``  — DataStates-LLM-faithful: uring, per-object submission,
                    dynamic allocation, buffered.
- ``snapshot``    — TorchSnapshot-faithful: chunk-per-file nested dirs,
                    thread-pool buffered writes, serial restore.
- ``torchsave``   — torch.save-faithful: monolithic pickle, sequential write.
"""

from .base import (ChecksumError, CREngine, EngineConfig, IOStats, ReadReq,
                   ReadStream, SaveItem, SaveSpec, SaveStream, spec_of)
from .aggregated import AggregatedEngine
from .datastates import DataStatesEngine
from .remote import RemoteReadEngine
from .snapshot import SnapshotEngine
from .torchsave import TorchSaveEngine

ENGINES: dict[str, type[CREngine]] = {
    "aggregated": AggregatedEngine,
    "datastates": DataStatesEngine,
    "snapshot": SnapshotEngine,
    "torchsave": TorchSaveEngine,
}


def make_cr_engine(name: str, config: EngineConfig | None = None,
                   pool=None) -> CREngine:
    return ENGINES[name](config, pool)

__all__ = ["ChecksumError", "CREngine", "EngineConfig", "IOStats", "ReadReq",
           "ReadStream", "SaveItem", "SaveSpec", "SaveStream", "spec_of",
           "AggregatedEngine", "DataStatesEngine", "RemoteReadEngine",
           "SnapshotEngine", "TorchSaveEngine", "ENGINES", "make_cr_engine"]
