"""ctypes wrapper of the CUDA ``ppr_walk`` kernel (``csrc/ppr_walk.cu``),
and the layout it walks (``walk_layout``, plain torch).

Replaces the Pallas TPU kernel ``repro/kernels/ppr_walk/ppr_walk.py``;
the source note in the ``.cu`` file says what bounds it on Hopper and
how its design answers that.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr
from repro_torch.kernels.ppr_walk.ref import last_valid_cols

MAX_WALKS = 1024             # one thread per walker
MAX_TRACE = 12288            # ids per start (the hash's first index < 2^16)
BLOCK = 8                    # columns per packed block
INF_BITS = 0x7F800000        # float32 +inf as int32

KERNEL = CudaKernel(
    "ppr_walk", "ppr_walk_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int])


class WalkLayout(NamedTuple):
    """What the kernel reads of a padded adjacency (N, D2), built once by
    ``walk_layout``.  ``summ`` (N, Gp) f32: the largest cum value of each
    of the G = ceil(D2 / 8) column blocks, +inf up to Gp (a multiple of
    8).  ``pack`` (N, G + 1, 16) int32: per block its 8 cum values (f32
    bits, +inf pad) then its 8 ids (-1 pad, all -1 on a dangling row);
    block G holds cum +inf and, as id 0, the id at the row's last
    positive column (-1 on a dangling row)."""
    summ: torch.Tensor
    pack: torch.Tensor


def walk_layout(nbrs: torch.Tensor, cum: torch.Tensor,
                last: Optional[torch.Tensor] = None, *,
                rows: int = 1 << 20) -> WalkLayout:
    """The kernel's layout of ``nbrs`` / ``cum`` (N, D2) on their device,
    ``rows`` rows at a time; ``last`` is ``last_valid_cols(cum)``.  For a
    non-decreasing cum row, the count of entries below a draw u is
    ``8 * nb + k``: nb the summary entries below u, k the entries of
    block nb below u; nb = G stands for the count D2, which the plain
    walk clamps to ``last``."""
    N, D2 = cum.shape
    G = -(-D2 // BLOCK)
    Gp = BLOCK * -(-G // BLOCK)
    if last is None:
        last = last_valid_cols(cum)
    dev = cum.device
    summ = torch.full((N, Gp), float("inf"), dtype=torch.float32,
                      device=dev)
    pack = torch.empty((N, G + 1, 2 * BLOCK), dtype=torch.int32, device=dev)
    tops = (torch.arange(G, device=dev) * BLOCK + BLOCK - 1).clamp_max(
        D2 - 1)
    pad = G * BLOCK - D2
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        c = cum[r0:r1].to(torch.float32)
        ids = torch.where(c[:, -1:] <= 0, -1, nbrs[r0:r1].to(torch.int32))
        summ[r0:r1, :G] = c[:, tops]
        p = pack[r0:r1]
        p[:, :G, :BLOCK] = F.pad(c, (0, pad), value=float("inf")).reshape(
            -1, G, BLOCK).view(torch.int32)
        p[:, :G, BLOCK:] = F.pad(ids, (0, pad), value=-1).reshape(
            -1, G, BLOCK)
        p[:, G, :BLOCK] = INF_BITS
        p[:, G, BLOCK:] = -1
        at = last[r0:r1, None].to(dev, torch.int64)
        p[:, G, BLOCK] = ids.gather(1, at).squeeze(1)
    return WalkLayout(summ, pack)


def smem_bytes(S: int) -> int:
    """Dynamic shared memory of one block for a trace of S ids: a hash of
    H slots (the smallest power of two above S) of a key and a
    first/count word, then one 16-bit slot index a position."""
    H = 1 << max(1, S.bit_length())
    return 8 * H + ((2 * S + 3) & ~3)


def ppr_walk(layout: WalkLayout, starts: torch.Tensor,
             uniforms: torch.Tensor, *,
             restart: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused walk on the card.  ``layout`` from ``walk_layout`` on the
    card, starts (n,) int32 in [0, N), uniforms (n, n_walks, 2*walk_len)
    f32, all contiguous CUDA tensors on one device.  Returns (visited,
    counts), each (n, S) int32.  Raises on what the kernel does not
    take."""
    summ, pack = layout
    check_cuda("summ", summ, torch.float32, 2)
    check_cuda("pack", pack, torch.int32, 3)
    check_cuda("starts", starts, torch.int32, 1)
    check_cuda("uniforms", uniforms, torch.float32, 3)
    N, Gp = summ.shape
    G1 = pack.shape[1]
    n, n_walks, two_l = uniforms.shape
    walk_len = two_l // 2
    if (pack.shape[0] != N or pack.shape[2] != 2 * BLOCK or G1 < 2
            or Gp != BLOCK * -(-(G1 - 1) // BLOCK)):
        raise ValueError(f"summ {tuple(summ.shape)} and pack "
                         f"{tuple(pack.shape)} are not one walk_layout")
    if starts.shape[0] != n or two_l % 2 or walk_len < 1:
        raise ValueError(f"starts {tuple(starts.shape)} / uniforms "
                         f"{tuple(uniforms.shape)} do not fit")
    if not 1 <= n_walks <= MAX_WALKS or n_walks * walk_len > MAX_TRACE:
        raise ValueError(f"ppr_walk takes 1..{MAX_WALKS} walkers and a "
                         f"trace of at most {MAX_TRACE} ids")
    devs = {t.device for t in (summ, pack, starts, uniforms)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    S = n_walks * walk_len
    visited = torch.empty((n, S), dtype=torch.int32, device=summ.device)
    counts = torch.empty((n, S), dtype=torch.int32, device=summ.device)
    KERNEL.launch(summ.data_ptr(), pack.data_ptr(), starts.data_ptr(),
                  uniforms.data_ptr(), n, Gp, G1, n_walks, walk_len,
                  float(np.float32(restart)), visited.data_ptr(),
                  counts.data_ptr(), stream_ptr(summ), summ.device.index)
    return visited, counts
