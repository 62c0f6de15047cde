"""Co-learned residual-quantization cluster index (paper §4.4), the
inference half of ``repro/core/rq_index.py``: codebook initialisation,
hard assignment (Eq. 9) and utilisation of published assignments.

Codebooks are a ``ModuleDict({"codebooks": ParameterDict({"layer{l}":
(n_l, d)})})`` so ``rq["codebooks"]["layer0"]`` reads as in the JAX
params tree.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import RQConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.rq_assign.ops import flat_codes, rq_assign


def codebooks_module(books: Sequence[torch.Tensor]) -> torch.nn.ModuleDict:
    """Wrap per-layer codebooks as the ``rq`` params subtree."""
    return torch.nn.ModuleDict({"codebooks": torch.nn.ParameterDict({
        f"layer{l}": torch.nn.Parameter(c, requires_grad=False)
        for l, c in enumerate(books)})})


def init_rq(cfg: RQConfig, d: int, *, generator: torch.Generator,
            dtype: torch.dtype = torch.float32,
            device=None) -> torch.nn.ModuleDict:
    """Normal codebooks, small and shrinking per layer (residuals shrink
    per layer): layer l has scale 0.1 / (l + 1)."""
    books = []
    for l, n in enumerate(cfg.codebook_sizes):
        c = torch.empty((n, d), dtype=dtype).normal_(generator=generator)
        books.append(c * (0.1 / (l + 1)))
    return codebooks_module(books).to(resolve_device(device))


def layer_books(rq_params, n_layers: int) -> List[torch.Tensor]:
    return [rq_params["codebooks"][f"layer{l}"] for l in range(n_layers)]


def assign_codes(rq_params, h: torch.Tensor, cfg: RQConfig) -> torch.Tensor:
    """Inference-time hard assignment (Eq. 9): (B,) int64 flat cluster
    ids, through ``rq_assign`` (the kernel on a CUDA tensor)."""
    codes, _ = rq_assign(h, layer_books(rq_params, len(cfg.codebook_sizes)))
    return flat_codes(codes, cfg.codebook_sizes)


def codes_utilization(codes, codebook_sizes) -> List[float]:
    """Fraction of each layer's codebook hit at least once by ``codes``
    ``(N, L)`` (numpy or tensor).  An empty corpus gives 0.0 per layer,
    a 1-D ``codes`` is single-layer ``(N, 1)``, sizes below 1 give 0.0;
    values lie in ``[0, 1]``."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[:, None]
    out = []
    for l, size in enumerate(codebook_sizes):
        if size < 1 or len(codes) == 0:
            out.append(0.0)
            continue
        used = np.unique(codes[:, l])
        out.append(min(float(len(used)) / float(size), 1.0))
    return out
