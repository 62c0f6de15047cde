"""Immutable, versioned serving-index snapshots, as
``repro/lifecycle/snapshot.py`` (``IndexSnapshot``, ``derive_members``,
``SnapshotStore``).

A snapshot is the publication artifact that crosses the offline/online
boundary: per-user RQ codes and flat cluster ids, the cluster->member
inverted lists, the coarse codebook and the offline I2I KNN table,
frozen at one version, as host numpy arrays.  Serving never mutates a
snapshot; the swap server flips between whole versions
(``lifecycle.swap``).

On disk a snapshot uses the checkpointer's layout
(``step_<version>/{manifest.json, 000000.npy, ...}`` plus the atomic
``latest`` pointer), written through ``checkpoint.Checkpointer``: its
seven arrays in ``_DATA_FIELDS`` order, its scalar fields in the
manifest.  The order and the manifest keys are the JAX package's, so
either package loads a snapshot the other wrote.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import (CheckpointCorruptError,
                                                 Checkpointer)
from repro_torch.faults import get_faults
from repro_torch.obs import get_telemetry


class SnapshotCorruptError(RuntimeError):
    """A snapshot failed verification and no retained version is good."""


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    """One published version of the co-learned cluster index.

    Flat cluster id = ``sum_l code_l * prod(sizes[l+1:])``: with the
    production (5000, 50) codebooks the layer-0 code owns the
    contiguous flat range ``[k0*50, (k0+1)*50)``.
    """
    user_codes: np.ndarray       # (n_users, L) int32 per-layer codes
    item_codes: np.ndarray       # (n_items, L) int32
    user_clusters: np.ndarray    # (n_users,) int64 flat cluster ids
    member_ptr: np.ndarray       # (n_clusters + 1,) int64 CSR offsets
    member_ids: np.ndarray       # (n_users,) int64 users by cluster
    coarse_codebook: np.ndarray  # (sizes[0], d) f32 layer-0 centroids
    i2i: np.ndarray              # (n_items, k) int64 offline I2I KNN
    version: int
    n_users: int
    n_items: int
    codebook_sizes: Tuple[int, ...]
    gate_metrics: Tuple[Tuple[str, float], ...] = ()

    @property
    def metrics(self) -> Dict[str, float]:
        """Publication-time gate numbers as a dict."""
        return dict(self.gate_metrics)

    @property
    def n_clusters(self) -> int:
        return int(np.prod(self.codebook_sizes))

    def members_of(self, cluster: int) -> np.ndarray:
        lo, hi = self.member_ptr[cluster], self.member_ptr[cluster + 1]
        return self.member_ids[lo:hi]

    def coarse_members(self, k0: int) -> np.ndarray:
        """All users whose layer-0 code is ``k0`` (the contiguous flat
        range: the multi-probe candidate unit)."""
        stride = self.n_clusters // self.codebook_sizes[0]
        lo = self.member_ptr[k0 * stride]
        hi = self.member_ptr[(k0 + 1) * stride]
        return self.member_ids[lo:hi]


# leaf order on disk (the JAX package's pytree order); keep it stable
_DATA_FIELDS = ("user_codes", "item_codes", "user_clusters",
                "member_ptr", "member_ids", "coarse_codebook", "i2i")


def derive_members(user_clusters: np.ndarray, n_clusters: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster -> member-user inverted lists as CSR ``(ptr, ids)``;
    members ascend within each cluster."""
    user_clusters = np.asarray(user_clusters, np.int64)
    order = np.argsort(user_clusters, kind="stable")
    counts = np.bincount(user_clusters, minlength=n_clusters)
    ptr = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, order.astype(np.int64)


class SnapshotStore:
    """Versioned snapshot directory on the checkpointer's manifest
    format: save goes through ``Checkpointer.save`` (atomic tmp+rename,
    retention, ``latest`` pointer), load reads the manifest + leaf files
    directly, shapes from the ``.npy`` headers."""

    def __init__(self, directory: str, *, keep: int = 3, faults=None,
                 telemetry=None):
        self.dir = directory
        self.faults = faults if faults is not None else get_faults()
        self.tel = telemetry if telemetry is not None else get_telemetry()
        # Checkpointer.__init__ sweeps step_*.tmp partials from crashes
        self._ck = Checkpointer(directory, keep=keep, faults=self.faults)

    # -- publish ------------------------------------------------------------

    def publish(self, snap: IndexSnapshot, *, blocking: bool = True
                ) -> None:
        meta = dict(kind="index_snapshot",
                    version=int(snap.version),
                    n_users=int(snap.n_users),
                    n_items=int(snap.n_items),
                    codebook_sizes=list(snap.codebook_sizes),
                    metrics={k: float(v)
                             for k, v in snap.metrics.items()})
        self._ck.save(snap.version,
                      tuple(getattr(snap, f) for f in _DATA_FIELDS),
                      metadata=meta, blocking=blocking)

    def wait(self) -> None:
        self._ck.wait()

    # -- load ---------------------------------------------------------------

    def versions(self) -> List[int]:
        return self._ck.all_steps()

    def latest_version(self) -> Optional[int]:
        return self._ck.latest_step()

    def load(self, version: Optional[int] = None, *,
             verify: bool = True) -> IndexSnapshot:
        """Load one version, verifying every leaf against the checksums
        recorded at publish time (``verify=False`` skips the re-hash).
        Raises :class:`CheckpointCorruptError` on a torn or bit-rotted
        snapshot; :meth:`load_latest_good` falls back through retained
        versions."""
        version = (version if version is not None
                   else self.latest_version())
        if version is None:
            raise FileNotFoundError(f"no snapshots under {self.dir}")
        d = os.path.join(self.dir, f"step_{version}")
        # corrupt-at-load models on-disk rot discovered at read time
        self.faults.fire("snapshot.load", version=version,
                         path=os.path.join(d, "000000.npy"))
        if verify:
            self._ck.verify_step(version)
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        if meta.get("kind") != "index_snapshot":
            raise ValueError(f"{d} is not an index snapshot "
                             f"(kind={meta.get('kind')!r})")
        if meta["n_leaves"] != len(_DATA_FIELDS):
            raise ValueError(
                f"snapshot has {meta['n_leaves']} leaves, expected "
                f"{len(_DATA_FIELDS)} — incompatible format version")
        leaves: Dict[str, Any] = {}
        for i, name in enumerate(_DATA_FIELDS):
            leaves[name] = np.load(os.path.join(d, f"{i:06d}.npy"),
                                   allow_pickle=False)
        return IndexSnapshot(
            version=int(meta["version"]),
            n_users=int(meta["n_users"]),
            n_items=int(meta["n_items"]),
            codebook_sizes=tuple(int(s)
                                 for s in meta["codebook_sizes"]),
            gate_metrics=tuple(sorted(
                (str(k), float(v))
                for k, v in meta.get("metrics", {}).items())),
            **leaves)

    # -- corruption fallback ------------------------------------------------

    def quarantine(self, version: int) -> str:
        """Move a corrupt version out of the loadable set by renaming
        ``step_N`` -> ``step_N.corrupt`` (``all_steps`` skips it), keeping
        the evidence.  Returns the quarantine dir name."""
        src = os.path.join(self.dir, f"step_{version}")
        dst = src + ".corrupt"
        k = 0
        while os.path.exists(dst):
            k += 1
            dst = f"{src}.corrupt{k}"
        os.rename(src, dst)
        self.tel.counter("snapshot.quarantined")
        return os.path.basename(dst)

    def load_latest_good(self) -> IndexSnapshot:
        """Walk retained versions newest-first, verifying each; corrupt
        ones are quarantined (and counted) and the walk continues.
        Raises :class:`SnapshotCorruptError` only when no retained
        version verifies."""
        last_err: Optional[Exception] = None
        for v in sorted(self.versions(), reverse=True):
            try:
                snap = self.load(v)
            except CheckpointCorruptError as e:
                last_err = e
                self.tel.counter("snapshot.corrupt_detected")
                with self.tel.span("snapshot.fallback", version=v,
                                   reason=str(e)):
                    self.quarantine(v)
                continue
            return snap
        raise SnapshotCorruptError(
            f"no loadable snapshot under {self.dir} "
            f"(last error: {last_err})")
