"""repro_torch.core — checkpoint/restore of PyTorch tensor states.

Layers (bottom-up), each the counterpart of the ``repro.core`` module of the
same name:
  uring        raw io_uring syscall binding
  io_engine    Uring / ThreadPool / Posix backends behind one request API
  buffers      aligned, pooled, reusable host buffers
  aggregation  file-per-tensor / file-per-process / single-file planners
  manifest     tensor→extent metadata with global shard indices
  engines      aggregated + datastates/snapshot/torchsave baselines, and the
               remote read engine
  serialization  tensor extraction + lean object (JAX flatten order)
  quant_codec  int8 PQ8P codec, quantized and decoded on the card
  pipeline     streaming save (D2H into pinned staging) and restore
  delta        content-addressed chunk store with on-card fp128 digests
  checkpoint   CheckpointManager: async save, atomic commit, restore
               (DTensor leaves and templates: each rank's local window)
  multiwriter  N concurrent writer ranks, two-phase rank-0 merge commit,
               elastic N→M restore; the same commit over torch.distributed,
               and N writer threads in each of its processes
  tiered       tier-to-tier transfer engine: extent-hedged flush + prefetch
  multilevel   local→shared-directory two-level flush, hedged stragglers
  grouplevel   the same two levels for the ranks of a torch.distributed
               group: one group checkpoint, flushed once by rank 0
  remote       object-store level-2 tier: hedged range reads, dedup upload,
               direct-to-pipeline remote restore
  faults/chaos fault injection, scrubbing, and the seeded chaos campaign
               (``python -m repro_torch.core.faults --campaign``)
"""

from .aggregation import (ObjectSpec, Strategy, coalesce, partition_spans,
                          plan_layout)
from .buffers import AlignedBuffer, BufferPool, PAGE
from .checkpoint import CheckpointManager, RestoreMetrics, SaveMetrics
from .delta import DeltaIndex, DeltaPlan, StoreGCStats, gc_store
from .engines import (AggregatedEngine, ChecksumError, CREngine,
                      DataStatesEngine, EngineConfig, ReadReq, ReadStream,
                      RemoteReadEngine, SaveItem, SaveSpec, SaveStream,
                      SnapshotEngine, TorchSaveEngine, make_cr_engine)
from .grouplevel import GroupMultiLevelCheckpointer
from .manifest import ChunkRef, Manifest, ManifestError
from .multilevel import FlushStats, MultiLevelCheckpointer
from .multiwriter import (CommitCoordinator, DistGroup, InProcessGroup,
                          MultiSaveMetrics, MultiWriterAborted,
                          MultiWriterCheckpointer, NestedDistGroup,
                          process_group_manager, shard_state)
from .remote import (ObjectStore, RangeStats, RemoteCheckpointer,
                     RemoteConfig, RemoteError, RemotePrefetcher, RemoteTier,
                     RemoteTransferEngine, RemoteTransientError,
                     SimObjectStore, SimProfile, UploadStats)
from .serialization import (LocalShard, state_from_numpy, state_to_numpy)
from .tiered import RestorePrefetcher, TieredTransferEngine, TransferStats
