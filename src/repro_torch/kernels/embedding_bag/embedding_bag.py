"""ctypes wrappers of the CUDA EmbeddingBag forward and backward kernels
(``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``repro/kernels/embedding_bag/embedding_bag.py`` and the backward of its
custom VJP (``repro/kernels/embedding_bag/ops.py::_bwd``); the source
note in the ``.cu`` file says what bounds them on Hopper and how the
design answers that.  ``ops.EmbeddingBag`` joins the two.  The backward
is a sorted segment-sum: ``segment_plan`` (plain torch, either device)
sorts the ids by row, and the kernel writes each row of ``d_table`` once.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

MAX_DIM = 256                  # one warp holds a row: 8 columns a lane
PIECE = 512                    # sorted ids per partial sum of a hot row
TILE_FLOATS = 1024             # f32 sums a warp of the row kernel holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"sum": 0, "mean": 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FWD = CudaKernel("embedding_bag_fwd", "embedding_bag_fwd_launch",
                 [_I, _I, _I, _P, _LL, _I, _P, _P, _LL, _I, _I, _P, _P, _I],
                 source="embedding_bag")
BWD = CudaKernel("embedding_bag_bwd", "embedding_bag_bwd_launch",
                 [_I, _I, _P, _P, _LL, _I, _P, _P, _LL, _I, _P, _P, _P, _I,
                  _I, _P, _P, _P, _P, _P, _I], source="embedding_bag")


def _check(table: torch.Tensor, ids: torch.Tensor,
           weights: Optional[torch.Tensor], mode: str,
           compute_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    if table.dtype not in _DTYPE_CODE or compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"embedding_bag takes float32 or bfloat16 tables "
                         f"and compute types, got {table.dtype} / "
                         f"{compute_dtype}")
    if mode not in _MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    check_cuda("table", table, table.dtype, 2)
    check_cuda("ids", ids, torch.int32, 2)
    V, D = table.shape
    N, L = ids.shape
    if not 1 <= D <= MAX_DIM or V >= 2 ** 31:
        raise ValueError(f"embedding_bag takes 1 <= D <= {MAX_DIM} and "
                         f"V < 2^31, got {tuple(table.shape)}")
    if weights is not None:
        check_cuda("weights", weights, torch.float32, 2)
        if tuple(weights.shape) != (N, L):
            raise ValueError(f"weights must be {(N, L)}, got "
                             f"{tuple(weights.shape)}")
    devs = {t.device for t in (table, ids, weights) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return V, D, N, L


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def embedding_bag_fwd(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum",
                      compute_dtype: Optional[torch.dtype] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Forward kernel.  table (V, D) f32 or bf16, ids (N, L) int32 (-1
    pad), weights (N, L) f32 or None, contiguous CUDA tensors on one
    device.  Returns (N, D): f32 sums of rows rounded to ``compute_dtype``
    (default: the table's type), rounded once to ``out_dtype`` (default:
    the compute type; f32 keeps the sums unrounded, for partial bags that
    are summed before their one rounding)."""
    compute_dtype = compute_dtype or table.dtype
    out_dtype = out_dtype or compute_dtype
    V, D, N, L = _check(table, ids, weights, mode, compute_dtype)
    if out_dtype not in (compute_dtype, torch.float32):
        raise ValueError(f"embedding_bag_fwd writes the compute type or "
                         f"float32, got {out_dtype}")
    out = torch.empty((N, D), dtype=out_dtype, device=table.device)
    FWD.launch(_DTYPE_CODE[table.dtype], _DTYPE_CODE[compute_dtype],
               _DTYPE_CODE[out_dtype], table.data_ptr(), V, D,
               ids.data_ptr(), _ptr(weights), N, L, _MODES[mode],
               out.data_ptr(), stream_ptr(table), table.device.index)
    return out


def rows_per_tile(D: int) -> int:
    """Rows of d_table per warp of the row kernel: a multiple of 4 whose
    f32 sums fit ``TILE_FLOATS`` (16 at D 64, 4 at D 256)."""
    return TILE_FLOATS // D // 4 * 4


def segment_plan(ids: torch.Tensor, V: int, tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's segments, in plain torch on ``ids``' device and
    stream, with no host sync.  ids (N, L) int -> (keys, slots, bounds):
    the flat ids keyed by row (padding and ids >= V keyed V, so they sort
    last), sorted stably, int32 (N*L,); their flat positions b*L + l,
    int64 (N*L,), increasing within a row; bounds (ceil(V / tile) + 1,)
    int32, where bounds[t] is the first sorted position whose key is >=
    min(t * tile, V).  With ``tile`` 1 these are the rows' offsets: row
    v's ids are at sorted positions bounds[v] .. bounds[v+1] - 1."""
    # clamped to -1 .. V, then -1 -> V: two passes over the ids
    keys = torch.remainder(ids.clamp(-1, V), V + 1).to(torch.int32).flatten()
    keys, slots = torch.sort(keys, stable=True)
    rows = torch.arange(0, V + tile, tile, device=ids.device).clamp_max_(V)
    return keys, slots, torch.searchsorted(keys, rows.to(torch.int32),
                                           out_int32=True)


def embedding_bag_bwd(g: torch.Tensor, table: torch.Tensor,
                      ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum",
                      compute_dtype: Optional[torch.dtype] = None, *,
                      table_grad: bool = True, weight_grad: bool = True
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Backward kernel.  ``g`` (N, D) in the compute type is the output's
    cotangent; the table is read only for d_weights.  Returns (d_table
    (V, D) in the table's type, or None without ``table_grad``;
    d_weights (N, L) f32, or None without weights or ``weight_grad``).
    d_table is dense and each row is written once: the f32 sum of its
    ids' terms in ``segment_plan``'s order, rounded once to the compute
    type (a row that holds ``PIECE`` ids or more adds partial sums of
    whole pieces of the sorted order, in order), so it repeats bitwise."""
    compute_dtype = compute_dtype or table.dtype
    V, D, N, L = _check(table, ids, weights, mode, compute_dtype)
    check_cuda("g", g, compute_dtype, 2)
    if tuple(g.shape) != (N, D) or g.device != table.device:
        raise ValueError(f"g must be {(N, D)} on {table.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if N * L + PIECE >= 2 ** 31:
        raise ValueError(f"embedding_bag_bwd takes fewer than "
                         f"{2 ** 31 - PIECE} ids, got {N * L}")
    dev, tile = table.device, rows_per_tile(D)
    d_table = d_weights = keys = slots = bounds = partials = cnt = None
    if table_grad:
        d_table = torch.empty_like(table)
        keys, slots, bounds = segment_plan(ids, V, tile)
        if N * L >= PIECE:
            partials = torch.empty((N * L // PIECE, D), dtype=torch.float32,
                                   device=dev)
    if weights is not None and weight_grad:
        d_weights = torch.empty((N, L), dtype=torch.float32, device=dev)
    if d_table is None and d_weights is None:
        return None, None
    if mode == "mean":
        cnt = torch.empty(N, dtype=torch.float32, device=dev)
    BWD.launch(_DTYPE_CODE[table.dtype], _DTYPE_CODE[compute_dtype],
               g.data_ptr(), table.data_ptr(), V, D, ids.data_ptr(),
               _ptr(weights), N, L, _ptr(keys), _ptr(slots), _ptr(bounds),
               tile, PIECE, _ptr(partials), _ptr(cnt), _ptr(d_table),
               _ptr(d_weights), stream_ptr(table), dev.index)
    return d_table, d_weights
