"""Neighbour tables and the inference-side gather of
``repro/data/edge_dataset.py`` (``NeighborTables``, ``_gather_side``,
``node_inference_batch``).

Feature and neighbour tables live on the dataset's device and every
gather runs there: at production size a host gather would move tens of
GB of neighbour features per corpus pass.  Only the neighbour-column
draw stays on the host, in numpy, so it is bit-identical to the JAX
package's: ``np.random.default_rng(seed)`` re-made per call, one
``(len(gids), k_train)`` draw for user neighbours, then one for item
neighbours.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class NeighborTables:
    """Pre-computed K_IMP neighbours per node, unified global id space
    (users [0, n_users), items [n_users, n_users+n_items)), -1 pad."""
    user_nbrs: np.ndarray    # (n_nodes, k_imp) global ids
    item_nbrs: np.ndarray    # (n_nodes, k_imp)
    n_users: int
    n_items: int


class EdgeDataset:
    """Inference half of the JAX ``EdgeDataset``: features and tables on
    ``device``, gathered for global node ids."""

    def __init__(self, tables: NeighborTables, user_feat, item_feat, *,
                 k_train: int = 10, device=None):
        dev = resolve_device(device)
        self.device = dev
        self.tables = tables
        self.k_train = int(k_train)
        self.k_imp = int(tables.user_nbrs.shape[1])
        self.user_feat = torch.as_tensor(user_feat, dtype=torch.float32).to(dev)
        self.item_feat = torch.as_tensor(item_feat, dtype=torch.float32).to(dev)
        # ids < 2^31: int32 halves the tables' device memory
        self.user_nbrs = torch.as_tensor(
            np.asarray(tables.user_nbrs, np.int32)).to(dev)
        self.item_nbrs = torch.as_tensor(
            np.asarray(tables.item_nbrs, np.int32)).to(dev)

    def _gather_side(self, gids: np.ndarray, rng: np.random.Generator
                     ) -> Dict[str, torch.Tensor]:
        """Features + sampled neighbour features for global node ids
        (all of one node type)."""
        nu, ni = self.tables.n_users, self.tables.n_items
        dev = self.device
        g = torch.as_tensor(np.asarray(gids, np.int64)).to(dev)
        if (gids < nu).all():
            feat = self.user_feat[g]
        else:
            feat = self.item_feat[g - nu]
        k = self.k_train
        cols = torch.as_tensor(rng.integers(0, self.k_imp, (len(gids), k))
                               ).to(dev)
        unbr = self.user_nbrs[g[:, None], cols].long()
        cols = torch.as_tensor(rng.integers(0, self.k_imp, (len(gids), k))
                               ).to(dev)
        inbr = self.item_nbrs[g[:, None], cols].long()
        umask = unbr >= 0
        imask = inbr >= nu
        unbr_feat = self.user_feat[unbr.clamp(0, nu - 1)] * umask[..., None]
        inbr_feat = (self.item_feat[(inbr - nu).clamp(0, ni - 1)]
                     * imask[..., None])
        return dict(feat=feat, unbr_feat=unbr_feat,
                    unbr_mask=umask.to(torch.float32),
                    inbr_feat=inbr_feat,
                    inbr_mask=imask.to(torch.float32))

    def node_inference_batch(self, gids: np.ndarray, seed: int = 0
                             ) -> Dict[str, torch.Tensor]:
        """Inference-side gather for embedding generation."""
        return self._gather_side(np.asarray(gids),
                                 np.random.default_rng(seed))
