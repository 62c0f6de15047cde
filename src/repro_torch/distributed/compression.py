"""Gradient compression for the cross-pod data-parallel axis, as
``repro/distributed/compression.py``.

At two pods or more the data-parallel all-reduce crosses the slow
inter-pod links; compressing gradients before it shrinks the collective
term.  Two schemes, both with error feedback (the compression error is
added to the next step's gradient, so convergence is kept):

  * int8: per-tensor scale quantization (4x over f32);
  * powersgd: one power iteration of a rank-r factorization of each
    matrix (Vogels et al. 2019), ratio about (n*m) / (r*(n+m)).

``compressed`` wraps an ``optim.optimizers.Optimizer`` over a flat dict
of gradients: compress, decompress, feed the error back.  As in the
reference, the wrapper does not change what crosses the wire: the
round trip runs where the gradient is, and the reduction (if any) is
the caller's.

Departure: PowerSGD's random ``q`` comes from a ``torch.Generator``
seeded ``seed`` (drawn on the CPU, one (m, r) normal block a matrix in
the gradients' order, each step), not from ``jax.random``, whose
threefry draws the port cannot reproduce.  ``powersgd_roundtrip`` takes
a given ``q``; ``p @ (m.T @ p).T`` is ``p p^T m``, which does not depend
on the signs QR gives the columns of ``p``, so two sides fed the same
``q`` agree to f32 rounding.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer

Tree = Dict[str, torch.Tensor]


class CompressionState(NamedTuple):
    error: Tree                  # error-feedback residual, as the grads
    inner: object                # wrapped optimizer's state
    generator: torch.Generator   # PowerSGD's q draws


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s = _quant_int8(x)
    return _dequant_int8(q, s)


def powersgd_roundtrip(x: torch.Tensor, rank: int, *,
                       q: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """One power-iteration low-rank approximation (rank ``rank``) of
    ``x`` viewed as (rows, last dim); below 2-D, or where a side is not
    above ``rank``, the int8 round trip.  ``q`` (last dim, rank) f32,
    else drawn N(0, 1) from ``generator`` on the CPU."""
    if x.dim() < 2 or min(x.shape[-2:]) <= rank:
        return int8_roundtrip(x)
    shape = x.shape
    m = x.reshape(-1, shape[-1])
    if q is None:
        q = torch.randn((shape[-1], rank), generator=generator,
                        dtype=torch.float32)
    q = q.to(device=m.device, dtype=torch.float32)
    p = m @ q                       # (n, r)   <- all-reduced in PowerSGD
    p, _ = torch.linalg.qr(p)
    q2 = m.T @ p                    # (m, r)   <- all-reduced
    return (p @ q2.T).reshape(shape)


def compressed(inner: Optimizer, *, scheme: str = "int8", rank: int = 4,
               seed: int = 0) -> Optimizer:
    """Wrap an optimizer with compress -> decompress + error feedback."""
    if scheme not in ("int8", "powersgd"):
        raise ValueError(f"unknown scheme {scheme!r}")

    def init(params: Tree) -> CompressionState:
        err = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()}
        return CompressionState(err, inner.init(params),
                                torch.Generator().manual_seed(seed))

    def update(grads: Tree, state: CompressionState, params: Tree):
        g_in = {k: g.to(torch.float32) + state.error[k]
                for k, g in grads.items()}
        if scheme == "int8":
            g_hat = {k: int8_roundtrip(g) for k, g in g_in.items()}
        else:
            g_hat = {k: powersgd_roundtrip(g, rank,
                                           generator=state.generator)
                     for k, g in g_in.items()}
        new_err = {k: g_in[k] - g_hat[k] for k in g_in}
        upd, inner_state = inner.update(g_hat, state.inner, params)
        return upd, CompressionState(new_err, inner_state, state.generator)

    return Optimizer(init, update)


def compression_ratio(params: Tree, scheme: str = "int8",
                      rank: int = 4) -> float:
    """Bytes on the wire with / without compression (for the roofline)."""
    full = comp = 0.0
    for p in params.values():
        n = float(p.numel())
        full += n * 4
        if scheme == "int8":
            comp += n * 1 + 4
        else:
            if p.dim() >= 2:
                rows = n / p.shape[-1]
                comp += 4 * rank * (rows + p.shape[-1])
            else:
                comp += n * 1 + 4
    return comp / max(full, 1.0)
