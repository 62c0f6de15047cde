"""ctypes wrappers of the CUDA ``fused_contrastive`` forward and backward
kernels (``csrc/fused_contrastive.cu``) and ``FusedContrastive``, the
``torch.autograd.Function`` that joins them.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` of
``repro/kernels/fused_contrastive/fused_contrastive.py`` and its custom
VJP (``fused_contrastive_diff``); the source note in the ``.cu`` file
says what bounds them on Hopper and how the design answers that.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

SMEM_LIMIT = 232448        # dynamic shared memory a block may use
WARPS = 8                  # most warps a backward block gives one row
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# widest row of the backward: the wide kernel keeps src and the d_src
# sums (f32) and 2 x WARPS dot partials in shared memory
D_MAX = (SMEM_LIMIT - 4 * 2 * WARPS) // 8

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FWD = CudaKernel("fused_contrastive_fwd", "fused_contrastive_fwd_launch",
                 [_I, _P, _P, _P, _LL, _I, _I, _F, _F, _P, _P, _P, _P, _P,
                  _I], source="fused_contrastive")
BWD = CudaKernel("fused_contrastive_bwd", "fused_contrastive_bwd_launch",
                 [_I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _F, _P,
                  _P, _P, _P, _I], source="fused_contrastive")


class BwdPlan(NamedTuple):
    """How the backward kernel takes a row: ``path`` "vector" (16-byte
    loads and stores), "scalar" (one element a lane a move) or "wide"
    (rows wider than a warp's registers hold); ``vpl`` units a lane;
    ``warps`` a row's block; ``smem`` its dynamic shared memory bytes."""
    path: str
    vpl: int
    warps: int
    smem: int


def bwd_plan(N: int, d: int, dtype: torch.dtype, aligned: bool = True
             ) -> BwdPlan:
    """The launch plan ``csrc/fused_contrastive.cu::bwd_plan`` makes for
    rows of N negatives of width d (``aligned``: every row starts on 16
    bytes).  A lane moves 16-byte units of ``e`` elements where d allows,
    else single elements; the fewest units a lane (1, 2, 4; scalar also
    8) that cover d; negatives in groups of G (64 bytes a lane on the
    vector path) dealt to the fewest warps, at most ``WARPS``, that keep
    each warp's group count at its least."""
    e = 16 // (torch.finfo(dtype).bits // 8)
    vec = aligned and d % e == 0
    units = d // e if vec else d
    for vpl in ((1, 2, 4) if vec else (1, 2, 4, 8)):
        if 32 * vpl >= units:
            groups = -(-N // (4 // vpl if vec else 4))
            per = -(-groups // WARPS)
            warps = -(-groups // per)
            return BwdPlan("vector" if vec else "scalar", vpl, warps,
                           4 * ((warps - 1) * d + warps))
    return BwdPlan("wide", 0, WARPS, 4 * (2 * d + 2 * WARPS))


def bwd_smem_bytes(N: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one backward block on 16-byte aligned
    rows: the other warps' d_src sums and the active counts (f32), or
    on the wide kernel src, the d_src sums and the dot partials."""
    return bwd_plan(N, d, dtype).smem


def check_bwd_shape(N: int, d: int, dtype: torch.dtype) -> None:
    """Raise for a row the backward kernel cannot take: N negatives
    stream through registers, so only d is bounded, by the wide
    kernel's shared memory."""
    if d > D_MAX:
        raise ValueError(
            f"fused_contrastive backward: d={d} ({dtype}) is above "
            f"{D_MAX}: a row this wide keeps src and its d_src sums in "
            f"shared memory, 8*d + {4 * 2 * WARPS} bytes of {SMEM_LIMIT}")


def _check(src: torch.Tensor, dst: torch.Tensor, negs: torch.Tensor
           ) -> Tuple[int, int, int]:
    if src.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_contrastive takes float32 or bfloat16, "
                         f"got {src.dtype}")
    check_cuda("src", src, src.dtype, 2)
    check_cuda("dst", dst, src.dtype, 2)
    check_cuda("negs", negs, src.dtype, 3)
    B, d = src.shape
    N = negs.shape[1]
    if tuple(dst.shape) != (B, d) or negs.shape[0] != B \
            or negs.shape[2] != d or N < 1 or d < 1:
        raise ValueError(f"shapes do not fit: src {tuple(src.shape)}, dst "
                         f"{tuple(dst.shape)}, negs {tuple(negs.shape)}")
    if len({src.device, dst.device, negs.device}) != 1:
        raise ValueError("src, dst and negs must be on one device")
    return B, N, d


def fused_contrastive_fwd(src: torch.Tensor, dst: torch.Tensor,
                          negs: torch.Tensor, *, margin: float, tau: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Forward kernel.  src/dst (B, d), negs (B, N, d), contiguous CUDA
    float32 or bfloat16 of one type.  Returns (marg, info, s_pos, lse),
    each (B,) float32; no launch at B 0."""
    B, N, d = _check(src, dst, negs)
    outs = [torch.empty(B, dtype=torch.float32, device=src.device)
            for _ in range(4)]
    if B == 0:     # no rows (a data rank's empty block): nothing to launch
        return tuple(outs)
    FWD.launch(_DTYPE_CODE[src.dtype], src.data_ptr(), dst.data_ptr(),
               negs.data_ptr(), B, N, d, float(np.float32(margin)),
               float(np.float32(tau)), *[o.data_ptr() for o in outs],
               stream_ptr(src), src.device.index)
    return tuple(outs)


def fused_contrastive_bwd(src: torch.Tensor, dst: torch.Tensor,
                          negs: torch.Tensor, gm: torch.Tensor,
                          gi: torch.Tensor, s_pos: torch.Tensor,
                          lse: torch.Tensor, *, margin: float, tau: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Backward kernel: the cotangents ``gm``, ``gi`` of the two losses
    and the forward's ``s_pos``, ``lse`` ((B,) float32 each) ->
    (d_src, d_dst, d_negs) in the inputs' type.  The kernel picks its
    plan (``bwd_plan``) from N, d and the rows' alignment; no launch at
    B 0."""
    B, N, d = _check(src, dst, negs)
    dev = src.device
    for name, t in (("gm", gm), ("gi", gi), ("s_pos", s_pos),
                    ("lse", lse)):
        check_cuda(name, t, torch.float32, 1)
        if t.shape[0] != B or t.device != dev:
            raise ValueError(f"{name} must be ({B},) on {dev}")
    check_bwd_shape(N, d, src.dtype)
    d_src = torch.empty_like(src)
    d_dst = torch.empty_like(dst)
    d_negs = torch.empty_like(negs)
    if B == 0:
        return d_src, d_dst, d_negs
    BWD.launch(_DTYPE_CODE[src.dtype], src.data_ptr(), dst.data_ptr(),
               negs.data_ptr(), gm.data_ptr(), gi.data_ptr(),
               s_pos.data_ptr(), lse.data_ptr(), B, N, d,
               float(np.float32(margin)), float(np.float32(tau)),
               d_src.data_ptr(), d_dst.data_ptr(), d_negs.data_ptr(),
               stream_ptr(src), dev.index)
    return d_src, d_dst, d_negs


class FusedContrastive(torch.autograd.Function):
    """Differentiable fused (margin, infonce) losses on the card.

    ``forward`` launches the forward kernel and saves src, dst, negs and
    the per-row s_pos and lse; ``backward`` launches the backward kernel
    with the two losses' cotangents.  Gradients come back in the
    inputs' type, as the JAX ``_diff_bwd`` casts them."""

    @staticmethod
    def forward(ctx, src, dst, negs, margin: float, tau: float):
        marg, info, s_pos, lse = fused_contrastive_fwd(
            src, dst, negs, margin=margin, tau=tau)
        ctx.save_for_backward(src, dst, negs, s_pos, lse)
        ctx.margin, ctx.tau = margin, tau
        return marg, info

    @staticmethod
    def backward(ctx, gm, gi):
        src, dst, negs, s_pos, lse = ctx.saved_tensors
        zeros = torch.zeros_like(s_pos)
        gm = zeros if gm is None else gm.to(torch.float32).contiguous()
        gi = zeros if gi is None else gi.to(torch.float32).contiguous()
        d_src, d_dst, d_negs = fused_contrastive_bwd(
            src, dst, negs, gm, gi, s_pos, lse, margin=ctx.margin,
            tau=ctx.tau)
        return d_src, d_dst, d_negs, None, None
