"""Immutable serving-index snapshots, as ``repro/lifecycle/snapshot.py``
(``IndexSnapshot``, ``derive_members``).  The versioned on-disk store
is not ported yet.

A snapshot is the publication artifact that crosses the offline/online
boundary: per-user RQ codes and flat cluster ids, the cluster->member
inverted lists, the coarse codebook and the offline I2I KNN table,
frozen at one version, as host numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
    def n_clusters(self) -> int:
        return int(np.prod(self.codebook_sizes))


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
