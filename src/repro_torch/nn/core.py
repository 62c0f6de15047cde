"""Layer helpers: initialisers drawn from an explicit ``torch.Generator``,
the linear layer, the MLP, RMSNorm and ``l2_normalize``, as in
``repro/nn/core.py``.

Weights use PyTorch's ``nn.Linear`` layout ``(d_out, d_in)``; the JAX
package keeps ``(d_in, d_out)`` and computes ``x @ w``, so
``repro_torch.convert`` transposes.  An MLP is a list of
``{"w": (d_out, d_in), "b": (d_out,)}`` dicts, the JAX tree's shape.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

RMS_EPS = 1e-6


def variance_scaling(scale: float, mode: str, distribution: str):
    """Initialiser ``init(generator, shape, dtype, in_axes, out_axes)``;
    fans are products over the named axes, as in the JAX package."""
    def init(generator: torch.Generator, shape: Sequence[int],
             dtype: torch.dtype, in_axes=(0,), out_axes=(1,), device=None):
        fan_in = math.prod(shape[a] for a in in_axes) or 1
        fan_out = math.prod(shape[a] for a in out_axes) or 1
        denom = {"fan_in": fan_in, "fan_out": fan_out}.get(
            mode, (fan_in + fan_out) / 2)
        var = scale / denom
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        if distribution == "normal":
            return out.normal_(0.0, math.sqrt(var), generator=generator)
        lim = math.sqrt(3 * var)
        return out.uniform_(-lim, lim, generator=generator)
    return init


lecun_normal = variance_scaling(1.0, "fan_in", "normal")
he_normal = variance_scaling(2.0, "fan_in", "normal")
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


def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             dtype: torch.dtype = torch.float32, device=None,
             init: Callable = he_normal) -> List[Dict[str, torch.Tensor]]:
    """Plain MLP, ``dims = [d_in, h1, ..., d_out]``: one ``{"w", "b"}``
    per layer, ``w`` drawn by ``init`` on ``device`` (``generator`` must
    live there), ``b`` zero."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = init(generator, (b, a), dtype, in_axes=(1,), out_axes=(0,),
                 device=device)
        layers.append({"w": w, "b": torch.zeros(b, dtype=dtype,
                                                device=device)})
    return layers


def linear_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ w^T``, then ``+ b``, in ``x``'s type: two roundings, as the
    JAX ``linear_apply`` (a fused ``F.linear`` rounds once)."""
    return torch.matmul(x, p["w"].to(x.dtype).t()) + p["b"].to(x.dtype)


def mlp_apply(params: List[Dict[str, torch.Tensor]], x: torch.Tensor, *,
              act: Callable = F.relu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    n = len(params)
    for i, p in enumerate(params):
        x = linear_apply(p, x)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in f32, back to ``x``'s type."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + RMS_EPS)
    return (y * scale.to(torch.float32)).to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    """``x / (||x|| + eps)`` — not ``F.normalize``, which divides by
    ``max(||x||, eps)``."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)
