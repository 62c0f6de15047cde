"""Publisher: materialise an ``IndexSnapshot`` from fresh embeddings, as
``repro/lifecycle/publish.py`` (``encode_corpus``, ``build_snapshot``,
``snapshot_health``).  The recall gate is not ported yet.

Every user and item embedding is pushed through the RQ codebooks
(``rq_assign_corpus``: the ``rq_assign`` kernel on a card), the flat
cluster ids are inverted into member lists, and the I2I KNN table is
rebuilt from the item embeddings.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core.rq_index import codes_utilization, layer_books
from repro_torch.core.serving import build_i2i_knn
from repro_torch.kernels.rq_assign.ops import flat_codes, rq_assign_corpus
from repro_torch.lifecycle.snapshot import IndexSnapshot, derive_members


@torch.inference_mode()
def encode_corpus(rq_params, emb: torch.Tensor,
                  codebook_sizes: Sequence[int], *, chunk: int = 65536
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode a full corpus through the codebooks, on ``emb``'s device.

    Returns ``(codes (N, L) int32, flat (N,) int64, recon (N, d) f32)``.
    """
    books = layer_books(rq_params, len(codebook_sizes))
    codes, recon = rq_assign_corpus(emb, books, chunk=chunk)
    return codes, flat_codes(codes, codebook_sizes), recon


def build_snapshot(version: int, user_emb: torch.Tensor,
                   item_emb: torch.Tensor, rq_params,
                   cfg: RankGraph2Config, *, i2i_k: int = 20,
                   chunk: int = 65536,
                   metrics: Optional[Dict[str, float]] = None,
                   want_user_recon: bool = False):
    """One immutable snapshot from the current embeddings + codebooks.

    ``want_user_recon=True`` also returns the user-corpus RQ
    reconstruction (a tensor on the embeddings' device) from the same
    encode pass as ``(snap, recon)``."""
    sizes = cfg.rq.codebook_sizes
    u_codes, u_flat, u_recon = encode_corpus(rq_params, user_emb, sizes,
                                             chunk=chunk)
    i_codes, _, _ = encode_corpus(rq_params, item_emb, sizes, chunk=chunk)
    u_flat = u_flat.cpu().numpy()
    ptr, ids = derive_members(u_flat, int(np.prod(sizes)))
    i2i = build_i2i_knn(item_emb, k=i2i_k)
    coarse = rq_params["codebooks"]["layer0"].detach().to(torch.float32)
    snap = IndexSnapshot(
        user_codes=u_codes.cpu().numpy(), item_codes=i_codes.cpu().numpy(),
        user_clusters=u_flat, member_ptr=ptr, member_ids=ids,
        coarse_codebook=coarse.cpu().numpy(), i2i=i2i.cpu().numpy(),
        version=int(version), n_users=len(user_emb),
        n_items=len(item_emb), codebook_sizes=tuple(sizes),
        gate_metrics=tuple(sorted((str(k), float(v))
                                  for k, v in (metrics or {}).items())))
    return (snap, u_recon) if want_user_recon else snap


def snapshot_health(snap: IndexSnapshot) -> Dict[str, float]:
    """Index-health metrics needing no eval world: per-layer utilisation
    of the published user+item assignments, the normalised entropy of
    the layer-0 member-list sizes (``coarse_list_balance``: 1 = flat,
    -> 0 at collapse) and the heaviest list's share of the users."""
    all_codes = np.concatenate([snap.user_codes, snap.item_codes], axis=0)
    util = codes_utilization(all_codes, snap.codebook_sizes)
    out = {f"util_layer{l}": float(u) for l, u in enumerate(util)}
    out["codebook_util_min"] = float(min(util)) if util else 0.0
    k0 = snap.codebook_sizes[0]
    stride = max(snap.n_clusters // k0, 1)
    ptr = snap.member_ptr
    sizes0 = (ptr[stride * np.arange(1, k0 + 1)]
              - ptr[stride * np.arange(k0)]).astype(np.float64)
    tot = float(sizes0.sum())
    if tot <= 0 or k0 <= 1:
        out["coarse_list_balance"] = 0.0 if k0 > 1 else 1.0
        out["coarse_list_max_share"] = 0.0 if tot <= 0 else 1.0
        return out
    p = sizes0 / tot
    nz = p[p > 0]
    out["coarse_list_balance"] = float(-np.sum(nz * np.log(nz))
                                       / np.log(k0))
    out["coarse_list_max_share"] = float(p.max())
    return out
