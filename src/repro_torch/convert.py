"""Parameters of the JAX package, as a tree of numpy arrays, to the
port's modules.

Covered: the encoders ``f_user`` / ``f_item``, the aggregators
``agg_user`` / ``agg_item`` and the RQ codebooks
``rq.codebooks.layer{l}``.  The JAX ``linear`` keeps ``w`` as
``(d_in, d_out)`` and computes ``x @ w``; ``nn.Linear`` keeps
``(d_out, d_in)``, so ``w`` is transposed here.  ``uncertainty`` is
training state and is not read.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.model import DTYPES, Aggregator, Encoder
from repro_torch.core.rq_index import codebooks_module
from repro_torch.kernels.common import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = DTYPES.get(a.dtype.name, torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _linear(p: Dict[str, Any]) -> torch.nn.Linear:
    w = _tensor(p["w"])                                     # (d_in, d_out)
    lin = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[0], w.shape[1],
                                   dtype=w.dtype)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        lin.bias.copy_(_tensor(p["b"]))
    return lin


def params_from_jax(tree: Dict[str, Any], *, device=None
                    ) -> torch.nn.ModuleDict:
    """JAX params tree (numpy leaves) -> ``ModuleDict`` with the same
    keys, on ``device``."""
    n_heads, _, d_embed = np.shape(tree["agg_user"]["w"])
    out = torch.nn.ModuleDict()
    for name in ("f_user", "f_item"):
        p = tree[name]
        out[name] = Encoder(_linear(p["l1"]), _linear(p["l2"]),
                            n_heads, d_embed)
    for name in ("agg_user", "agg_item"):
        out[name] = Aggregator(_tensor(tree[name]["w"]),
                               _tensor(tree[name]["b"]))
    if "rq" in tree:
        books = tree["rq"]["codebooks"]
        out["rq"] = codebooks_module(
            [_tensor(books[f"layer{l}"]) for l in range(len(books))])
    return out.to(resolve_device(device)).requires_grad_(False)
