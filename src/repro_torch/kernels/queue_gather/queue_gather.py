"""ctypes wrapper of the CUDA ``queue_gather`` kernel
(``csrc/queue_gather.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/queue_gather/queue_gather.py``; the source note in the
``.cu`` file says what bounds it on Hopper and how its design answers
that.  Item ids are gathered with integer loads, so the TPU kernel's
2^24 id cap does not apply.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

MAX_R = 32     # csrc MAX_R
MAX_K = 256    # csrc MAX_K

KERNEL = CudaKernel(
    "queue_gather", "queue_gather_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int])


def queue_gather(items: torch.Tensor, times: torch.Tensor,
                 cursor: torch.Tensor, clusters: torch.Tensor,
                 i2i: torch.Tensor, *, cutoff: float, n_recent: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused serving gather on the card.  items (C, Q) int32, times
    (C, Q) f32, cursor (C,) int32, clusters (B,) int32, i2i (N, K) int32,
    all CUDA.  Returns (seeds (B, n_recent), union (B, k)) int32,
    ``-1``-padded.  Raises on what the kernel does not take."""
    check_cuda("items", items, torch.int32, 2)
    check_cuda("times", times, torch.float32, 2)
    check_cuda("cursor", cursor, torch.int32, 1)
    check_cuda("clusters", clusters, torch.int32, 1)
    check_cuda("i2i", i2i, torch.int32, 2)
    C, Q = items.shape
    if times.shape != items.shape or cursor.shape != (C,) or C < 1 or Q < 1:
        raise ValueError("queue_gather needs items/times (C, Q) and "
                         "cursor (C,) with C, Q >= 1")
    if not (1 <= n_recent <= MAX_R and 1 <= k <= MAX_K):
        raise ValueError(f"queue_gather takes 1 <= n_recent <= {MAX_R} "
                         f"and 1 <= k <= {MAX_K}, got {n_recent}, {k}")
    dev = items.device
    if any(t.device != dev for t in (times, cursor, clusters, i2i)):
        raise ValueError("queue_gather inputs must share one device")
    B = clusters.shape[0]
    N, K = i2i.shape
    seeds = torch.empty((B, n_recent), dtype=torch.int32, device=dev)
    union = torch.empty((B, k), dtype=torch.int32, device=dev)
    KERNEL.launch(items.data_ptr(), times.data_ptr(), cursor.data_ptr(),
                  C, Q, clusters.data_ptr(), B, i2i.data_ptr(), N, K,
                  float(cutoff), int(n_recent), int(k), seeds.data_ptr(),
                  union.data_ptr(), stream_ptr(items), dev.index)
    return seeds, union
