"""Embedding generation of ``repro/core/trainer.py`` (``embed_all``);
the training half is not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core import model as M


@torch.inference_mode()
def embed_all(params, cfg: RankGraph2Config, dataset, *, node_type: int,
              ids: np.ndarray, batch: int = 4096) -> torch.Tensor:
    """Primary embeddings (len(ids), d_embed) in ``cfg.dtype`` on the
    dataset's device, for global node ids.

    Every chunk is padded to the fixed ``batch`` by repeating its last
    id, as the JAX package does: the neighbour draw of a chunk depends
    on its padded shape, so the same rule gives the same draws."""
    ids = np.asarray(ids)
    out = []
    for lo in range(0, len(ids), batch):
        chunk = ids[lo:lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.r_[chunk, np.repeat(chunk[-1:], pad)]
        side = dataset.node_inference_batch(chunk)
        _, prim = M.embed_side(params, cfg, side, node_type)
        out.append(prim[: len(prim) - pad] if pad else prim)
    if not out:
        return torch.empty((0, cfg.d_embed), dtype=M.DTYPES[cfg.dtype],
                           device=dataset.device)
    return torch.cat(out, dim=0)
