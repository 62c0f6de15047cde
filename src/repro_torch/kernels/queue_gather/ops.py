"""Public op: fused queue-gather + I2I-union.

The path follows the tensors' device: CUDA tensors launch the CUDA
kernel (or raise), CPU tensors take the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.queue_gather.queue_gather import (
    queue_gather as queue_gather_kernel)
from repro_torch.kernels.queue_gather.ref import queue_gather_ref


def queue_gather(items: torch.Tensor, times: torch.Tensor,
                 cursor: torch.Tensor, clusters: torch.Tensor,
                 i2i: torch.Tensor, *, cutoff: float, n_recent: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched serving gather: U2U2I seeds + U2I2I round-robin union.

    items/times (C, Q) ring buffers, cursor (C,) total writes, clusters
    (B,) per-request cluster ids, i2i (N, K) offline KNN table, all on
    one device.  Returns (seeds (B, n_recent), union (B, k)) int32,
    both ``-1``-padded.  ``cutoff`` is compared in float32.
    """
    dev = items.device
    args = (items.to(torch.int32).contiguous(),
            times.to(torch.float32).contiguous(),
            cursor.to(dev, torch.int32).contiguous(),
            clusters.to(dev, torch.int32).contiguous(),
            i2i.to(dev, torch.int32).contiguous())
    kw = dict(cutoff=cutoff, n_recent=int(n_recent), k=int(k))
    if dev.type == "cuda":
        return queue_gather_kernel(*args, **kw)
    if dev.type == "cpu":
        return queue_gather_ref(*args, **kw)
    raise ValueError(f"queue_gather runs on cuda or cpu, not {dev}")
