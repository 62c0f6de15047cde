"""Lifecycle runtime (paper §4 end-to-end), as ``repro/lifecycle``:
versioned index publication with atomic hot-swap into serving.

  * ``snapshot``  immutable, versioned ``IndexSnapshot`` artifacts and a
                  checkpointer-compatible on-disk store;
  * ``publish``   materialise a snapshot from a ``TrainState``
                  (full-corpus RQ encode, inverted lists, I2I KNN) and
                  gate it on retrieval recall vs exact KNN;
  * ``swap``      double-buffered ``SnapshotHandle`` + ``SwapServer``:
                  atomic version flips under live traffic, queue
                  re-keying via a retained event ring;
  * ``runtime``   the hour-level orchestrator chaining incremental
                  graph refresh -> training burst -> publish -> swap.
"""
from repro_torch.lifecycle.snapshot import (IndexSnapshot,
                                            SnapshotCorruptError,
                                            SnapshotStore)
from repro_torch.lifecycle.publish import build_snapshot, evaluate_snapshot
from repro_torch.lifecycle.swap import SnapshotHandle, SwapServer
from repro_torch.lifecycle.runtime import (LifecycleConfig,
                                           LifecycleRuntime, StageFailed)

__all__ = [
    "IndexSnapshot", "SnapshotCorruptError", "SnapshotStore",
    "build_snapshot", "evaluate_snapshot", "SnapshotHandle", "SwapServer",
    "LifecycleConfig", "LifecycleRuntime", "StageFailed",
]
