"""ctypes wrapper of the CUDA ``rq_assign`` kernel (``csrc/rq_assign.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rq_assign/rq_assign.py``;
the source note in the ``.cu`` file says what bounds it on Hopper and
how its design answers that.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

MAX_L = 8                  # csrc MAX_L
_BM, _BN, _BK, _STAGES = 128, 128, 64, 2   # csrc tile sizes and ring depth
SMEM_LIMIT = 232448        # dynamic shared memory a block may use

KERNEL = CudaKernel(
    "rq_assign", "rq_assign_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (csrc ``smem_bytes``): the
    block's residuals, the ring of code tiles, row norms and chosen
    codes."""
    return 4 * (d * _BM + _STAGES * _BK * _BN + _BM) + 4 * _BM * MAX_L


# the largest d (a multiple of 4) whose block fits in shared memory
D_MAX = max(d for d in range(4, 4096, 4) if smem_bytes(d) <= SMEM_LIMIT)


def scratch_floats(d: int, sizes: Sequence[int]) -> int:
    """f32 scratch of one call: each layer's codebook transposed and
    padded to whole code tiles (d x npad), then its code norms."""
    return sum((d + 1) * (-(-n // _BN) * _BN) for n in sizes)


def check_shape(d: int, L: int) -> None:
    """Raise on a width or a layer count the kernel does not take."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"rq_assign takes 1..{MAX_L} codebooks, got {L}")
    if d % 4 or not 4 <= d <= D_MAX:
        raise ValueError(f"rq_assign needs d % 4 == 0 and 4 <= d <= "
                         f"{D_MAX}, got d={d}")


def rq_assign(x: torch.Tensor, codebooks: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RQ assignment on the card.  x (B, d) f32 CUDA ->
    (codes (B, L) int32, recon (B, d) f32).  Raises on what the kernel
    does not take."""
    check_cuda("x", x, torch.float32, 2)
    B, d = x.shape
    L = len(codebooks)
    check_shape(d, L)
    for l, c in enumerate(codebooks):
        check_cuda(f"codebooks[{l}]", c, torch.float32, 2)
        if c.device != x.device or c.shape[1] != d or c.shape[0] < 1:
            raise ValueError(f"codebooks[{l}] must be (n >= 1, {d}) on "
                             f"{x.device}, got {tuple(c.shape)} on "
                             f"{c.device}")
    for t in (x, *codebooks):
        if t.data_ptr() % 16:
            raise ValueError("rq_assign needs 16-byte aligned inputs")
    sizes = [int(c.shape[0]) for c in codebooks]
    codes = torch.empty((B, L), dtype=torch.int32, device=x.device)
    recon = torch.empty((B, d), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_floats(d, sizes), dtype=torch.float32,
                          device=x.device)
    books = (ctypes.c_void_p * L)(*[c.data_ptr() for c in codebooks])
    n_arr = (ctypes.c_int * L)(*sizes)
    KERNEL.launch(x.data_ptr(), ctypes.addressof(books),
                  ctypes.addressof(n_arr), L, scratch.data_ptr(), B, d,
                  codes.data_ptr(), recon.data_ptr(), stream_ptr(x),
                  x.device.index)
    return codes, recon
