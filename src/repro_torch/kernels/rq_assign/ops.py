"""Public op: RQ assignment, plus the chunked full-corpus encode used at
index publication.

The path follows the tensor's device: a CUDA tensor launches the CUDA
kernel (or raises), a CPU tensor takes the plain version.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.rq_assign.ref import rq_assign_ref
from repro_torch.kernels.rq_assign.rq_assign import rq_assign as rq_assign_kernel


def rq_assign(x: torch.Tensor, codebooks: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, d) -> (codes (B, L) int32, recon (B, d) float32)."""
    x = x.to(torch.float32).contiguous()
    books = [c.to(x.device, torch.float32).contiguous() for c in codebooks]
    if x.device.type == "cuda":
        return rq_assign_kernel(x, books)
    if x.device.type == "cpu":
        return rq_assign_ref(x, books)
    raise ValueError(f"rq_assign runs on cuda or cpu, not {x.device}")


def rq_assign_corpus(x: torch.Tensor, codebooks: Sequence[torch.Tensor], *,
                     chunk: int = 65536
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-corpus RQ encode for index publication, ``chunk`` rows at a
    time (bounds the plain version's (chunk, n) distance matrix; the
    kernel needs no chunking but gets whole waves of blocks from it).

    Row results do not depend on the split: each row's distances depend
    only on that row and the codebooks.  Returns ``(codes (N, L) int32,
    recon (N, d) float32)`` on ``x``'s device.
    """
    n, d = x.shape
    books = [c.to(x.device, torch.float32).contiguous() for c in codebooks]
    codes = torch.empty((n, len(books)), dtype=torch.int32, device=x.device)
    recon = torch.empty((n, d), dtype=torch.float32, device=x.device)
    chunk = max(int(chunk), 1)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        codes[lo:hi], recon[lo:hi] = rq_assign(x[lo:hi], books)
    return codes, recon


def flat_codes(codes: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """(B, L) layer codes -> (B,) int64 flat cluster id."""
    flat = torch.zeros(codes.shape[0], dtype=torch.int64,
                       device=codes.device)
    for l, n in enumerate(sizes):
        flat = flat * n + codes[:, l].to(torch.int64)
    return flat
