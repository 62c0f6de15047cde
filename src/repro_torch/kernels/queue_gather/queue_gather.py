"""ctypes wrapper of the CUDA ``queue_gather`` kernel
(``csrc/queue_gather.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/queue_gather/queue_gather.py``; the source note in the
``.cu`` file says what bounds it on Hopper and how its design answers
that.  Item ids are gathered with integer loads, so the TPU kernel's
2^24 id cap does not apply.

The wrapper computes the multiplier that takes the ring head's modulo
in the kernel (``mod_magic``) and the launch plan (``launch_plan``:
requests a warp from the batch and the SM count), plain functions tested
without a card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

MAX_R = 32      # csrc: a request stages at most 32 seeds, one a lane
MAX_K = 256     # csrc: bounds the hash (hash_bits)
WARPS = 4       # csrc kWarps: warps (requests) a block
COLS = 2        # csrc kCols: union columns of 32 candidates a load trip
LANES = 32
SM_WARPS = 64   # warps an SM holds: 16 blocks at 32 registers a thread

KERNEL = CudaKernel(
    "queue_gather", "queue_gather_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])


def hash_bits(R: int, k: int) -> int:
    """log2 of a request's hash slots: the smallest power of two at least
    ``2 (R + k + 64)``.  The seed steps place at most R - 1 keys before
    their last step and 32 in it (a seed past the R-th leaves a
    tombstone), the union columns at most k - 1 before their last column
    and 32 in it, so the table stays at most half full and every probe
    ends."""
    b = 1
    while (1 << b) < 2 * (R + k + 2 * LANES):
        b += 1
    return b


def smem_bytes(R: int, k: int) -> int:
    """Shared memory of one block (4 warps): per warp its hash keys, the
    lowest lane of each slot, and R staged seeds padded to 16 bytes
    (csrc ``smem_bytes``)."""
    return WARPS * (2 * (1 << hash_bits(R, k)) + -(-R // 4) * 4) * 4


def launch_plan(B: int, sms: int) -> Tuple[int, int]:
    """(requests a warp, blocks) for a batch of B on a card of ``sms``
    SMs.  A warp serves one request while the batch fills fewer than 4
    waves of the card's warps, 2 up to 16 waves, then 4, so that large
    batches launch fewer blocks; the blocks cover B."""
    waves = B / (sms * SM_WARPS)
    rpw = 4 if waves >= 16 else 2 if waves >= 4 else 1
    return rpw, -(-B // (WARPS * rpw))


def mod_magic(Q: int) -> Tuple[int, int]:
    """(multiplier, shift) with ``x // Q == (x * multiplier >> 32) >>
    shift`` for every ``0 <= x < 2**31`` (Granlund and Montgomery's
    round-up method at 31 bits: multiplier = ceil(2^(31 + l) / Q), l =
    ceil(log2 Q)); (0, 0) for Q 1, which the kernel takes apart."""
    if Q == 1:
        return 0, 0
    lg = (Q - 1).bit_length()
    return -(-(1 << (31 + lg)) // Q), lg - 1


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
    N, K = i2i.shape
    if n_recent * K >= 1 << 31:
        raise ValueError(f"queue_gather needs n_recent * K < 2^31, got "
                         f"{n_recent} * {K}")
    dev = items.device
    if any(t.device != dev for t in (times, cursor, clusters, i2i)):
        raise ValueError("queue_gather inputs must share one device")
    B = clusters.shape[0]
    seeds = torch.empty((B, n_recent), dtype=torch.int32, device=dev)
    union = torch.empty((B, k), dtype=torch.int32, device=dev)
    rpw, _ = launch_plan(
        B, torch.cuda.get_device_properties(dev).multi_processor_count)
    KERNEL.launch(items.data_ptr(), times.data_ptr(), cursor.data_ptr(),
                  C, Q, *mod_magic(Q), clusters.data_ptr(), B,
                  i2i.data_ptr(), N, K, float(cutoff), int(n_recent), int(k),
                  rpw, seeds.data_ptr(), union.data_ptr(), stream_ptr(items),
                  dev.index)
    return seeds, union
