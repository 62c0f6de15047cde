"""Layer helpers: initialisers drawn from an explicit ``torch.Generator``,
the linear layer and ``l2_normalize``, as in ``repro/nn/core.py``.

Weights use PyTorch's ``nn.Linear`` layout ``(d_out, d_in)``; the JAX
package keeps ``(d_in, d_out)`` and computes ``x @ w``, so
``repro_torch.convert`` transposes.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def variance_scaling(scale: float, mode: str, distribution: str):
    """Initialiser ``init(generator, shape, dtype, in_axes, out_axes)``;
    fans are products over the named axes, as in the JAX package."""
    def init(generator: torch.Generator, shape: Sequence[int],
             dtype: torch.dtype, in_axes=(0,), out_axes=(1,)):
        fan_in = math.prod(shape[a] for a in in_axes) or 1
        fan_out = math.prod(shape[a] for a in out_axes) or 1
        denom = {"fan_in": fan_in, "fan_out": fan_out}.get(
            mode, (fan_in + fan_out) / 2)
        var = scale / denom
        out = torch.empty(tuple(shape), dtype=dtype)
        if distribution == "normal":
            return out.normal_(0.0, math.sqrt(var), generator=generator)
        lim = math.sqrt(3 * var)
        return out.uniform_(-lim, lim, generator=generator)
    return init


lecun_normal = variance_scaling(1.0, "fan_in", "normal")
xavier_uniform = variance_scaling(1.0, "fan_avg", "uniform")


def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                dtype: torch.dtype = torch.float32,
                init: Callable = xavier_uniform) -> torch.nn.Linear:
    """``nn.Linear(d_in, d_out)`` with weights from ``init`` and a zero
    bias."""
    lin = torch.nn.utils.skip_init(torch.nn.Linear, d_in, d_out,
                                   dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(init(generator, (d_out, d_in), dtype,
                              in_axes=(1,), out_axes=(0,)))
        lin.bias.zero_()
    return lin


def linear(lin: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` in ``x``'s type (parameters are cast, as the JAX
    ``linear_apply`` casts to ``x.dtype``)."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    """``x / (||x|| + eps)`` — not ``F.normalize``, which divides by
    ``max(||x||, eps)``."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)
