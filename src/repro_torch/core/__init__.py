"""repro_torch.core — checkpoint/restore of PyTorch tensor states.

Layers (bottom-up), each the counterpart of the ``repro.core`` module of the
same name:
  uring        raw io_uring syscall binding
  io_engine    Uring / ThreadPool / Posix backends behind one request API
  buffers      aligned, pooled, reusable host buffers
  aggregation  file-per-tensor / file-per-process / single-file planners
  manifest     tensor→extent metadata with global shard indices
  engines      the aggregated engine
  serialization  tensor extraction + lean object (JAX flatten order)
  quant_codec  int8 PQ8P codec, quantized and decoded on the card
  pipeline     streaming save (D2H into pinned staging) and restore
  delta        content-addressed chunk store with on-card fp128 digests
  checkpoint   CheckpointManager: async save, atomic commit, restore
"""

from .aggregation import (ObjectSpec, Strategy, coalesce, partition_spans,
                          plan_layout)
from .buffers import AlignedBuffer, BufferPool, PAGE
from .checkpoint import CheckpointManager, RestoreMetrics, SaveMetrics
from .delta import DeltaIndex, DeltaPlan, StoreGCStats, gc_store
from .engines import (AggregatedEngine, ChecksumError, CREngine,
                      EngineConfig, make_cr_engine)
from .manifest import ChunkRef, Manifest, ManifestError
from .serialization import (LocalShard, state_from_numpy, state_to_numpy)
