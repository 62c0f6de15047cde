"""ctypes wrapper of the CUDA ``ppr_walk`` kernel (``csrc/ppr_walk.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ppr_walk/ppr_walk.py``;
the source note in the ``.cu`` file says what bounds it on Hopper and
how its design answers that.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

MAX_WALKS = 1024             # one thread per walker
SMEM_DEFAULT = 48 * 1024     # the trace lives in static-limit shared memory

KERNEL = CudaKernel(
    "ppr_walk", "ppr_walk_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int])


def ppr_walk(nbrs: torch.Tensor, cum: torch.Tensor, last: torch.Tensor,
             starts: torch.Tensor, uniforms: torch.Tensor, *,
             restart: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused walk on the card.  nbrs (N, D2) int32, cum (N, D2) f32,
    last (N,) int32 (``ref.last_valid_cols``), starts (n,) int32 in
    [0, N), uniforms (n, n_walks, 2*walk_len) f32, all contiguous CUDA
    tensors on one device.  Returns (visited, counts), each (n, S) int32.
    Raises on what the kernel does not take."""
    check_cuda("nbrs", nbrs, torch.int32, 2)
    check_cuda("cum", cum, torch.float32, 2)
    check_cuda("last", last, torch.int32, 1)
    check_cuda("starts", starts, torch.int32, 1)
    check_cuda("uniforms", uniforms, torch.float32, 3)
    N, D2 = nbrs.shape
    n, n_walks, two_l = uniforms.shape
    walk_len = two_l // 2
    if tuple(cum.shape) != (N, D2) or tuple(last.shape) != (N,):
        raise ValueError(f"cum must be {(N, D2)} and last {(N,)}, got "
                         f"{tuple(cum.shape)} and {tuple(last.shape)}")
    if starts.shape[0] != n or two_l % 2 or walk_len < 1 or D2 < 1:
        raise ValueError(f"starts {tuple(starts.shape)} / uniforms "
                         f"{tuple(uniforms.shape)} do not fit")
    if not 1 <= n_walks <= MAX_WALKS or 4 * n_walks * walk_len > SMEM_DEFAULT:
        raise ValueError(f"ppr_walk takes 1..{MAX_WALKS} walkers and a "
                         f"trace of at most {SMEM_DEFAULT // 4} ids")
    devs = {t.device for t in (nbrs, cum, last, starts, uniforms)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    S = n_walks * walk_len
    visited = torch.empty((n, S), dtype=torch.int32, device=nbrs.device)
    counts = torch.empty((n, S), dtype=torch.int32, device=nbrs.device)
    KERNEL.launch(nbrs.data_ptr(), cum.data_ptr(), last.data_ptr(),
                  starts.data_ptr(), uniforms.data_ptr(), n, D2, n_walks,
                  walk_len, float(np.float32(restart)), visited.data_ptr(),
                  counts.data_ptr(), stream_ptr(nbrs), nbrs.device.index)
    return visited, counts
