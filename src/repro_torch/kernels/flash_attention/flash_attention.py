"""ctypes wrappers of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``), each counted under its own name:

  * ``flash_attention``: bf16 on the tensor cores, a block of 128 query
    rows (prefill, and any call with more than 16 rows per KV head):
    ``wgmma`` at head dims 64 to 256, ``mma.sync`` at 32;
  * ``flash_attention_decode``: bf16, at most 16 rows per KV head (a
    decode step), streaming K and V once (``mma.sync``);
  * ``flash_attention_f32``: f32 inputs, the FP32-pipe kernel (the f32
    card-vs-CPU checks).

Under autograd (grad mode on and q, k or v requiring grad) ``flash_attention``
goes through ``FlashAttention``: the forward takes the training route
(``train_plan``: the tile kernel of the input type at one split, which
also writes each row's logsumexp), and the backward is
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), two passes each
counted under its own name: ``flash_attention_bwd_dq`` (writes dQ and
each row's ``Di``) then ``flash_attention_bwd_dkdv`` (dK and dV; twice at
head dim 256, dV then dK), or ``flash_attention_bwd_f32_dq`` and
``flash_attention_bwd_f32_dkdv`` for f32 inputs.  The bf16 dkdv pass
follows ``bwd_plan``: each 64-key tile's row tiles cut into ranges, more
of them for the key tiles that more rows see, the split ones folded in
split order by the same launch.  It takes what
``lm_loss`` calls (causal, ``q_offset`` 0, no ``kv_len``, S equal to T,
head dims ``HEAD_DIMS``); ``check_train_case`` refuses the rest, and
``flash_attention_split`` refuses grad.  With grad off nothing changes.

When ``plan`` splits the kv range over blocks, the same launch folds the
splits' partials into the output (the last block of each group merges
them), so every call is one launch; the fold's arrival counters are an
int32 buffer cached per (device, stream), which the kernels leave zero
after every launch, so no memset is launched (one ``torch.zeros`` when
a launch needs more counters than the buffer holds).  The input type
picks the kernel: a bf16 call never runs the f32 kernel, and a shape no
kernel takes raises.  Replaces the Pallas TPU kernel ``_kernel`` of
``repro/kernels/flash_attention/flash_attention.py``; the source note in
the ``.cu`` file says what bounds it on Hopper and how the design
answers that.  ``flash_attention`` takes the LM model's ``(B, S, H, D)``
layout and its contract (``causal``, ``q_offset``, ``kv_len``);
``ops.py`` also offers the Pallas wrapper's ``(B, H, S, D)`` one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels.common import CudaKernel, check_cuda, stream_ptr

HEAD_DIMS = (32, 64, 128, 256)
BK = 64                        # keys per tile
MMA_ROWS = 128                 # query rows of a tensor-core block
DECODE_ROWS = 16               # rows per KV head the decode kernel takes
MIN_ROW_TILE = 16              # fewest query rows of any kernel's block
SPLIT_TARGET = 4               # f32: blocks per SM a split-KV launch aims at
MIN_SPLIT_TILES = 4            # kv tiles per split, at least
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# D, q, k, v, o, B, S, Hq, Hkv, strides, causal, q_offset, kv_len, kv_max,
# scale, [rpt,] splits, ws_m, ws_l, ws_acc, counters, n_counters, lse, stream
_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.POINTER(_LL), _I, _I,
         _P, _I, _F]
_SPLIT = [_I, _P, _P, _P, _P, _I, _P, _P]
MMA = CudaKernel("flash_attention", "flash_attention_mma_launch",
                 _ARGS + _SPLIT)
DECODE = CudaKernel("flash_attention_decode", "flash_attention_decode_launch",
                    _ARGS + _SPLIT, source="flash_attention")
F32 = CudaKernel("flash_attention_f32", "flash_attention_f32_launch",
                 _ARGS + [_I] + _SPLIT, source="flash_attention")
_FWD = {k.name: k for k in (MMA, DECODE, F32)}
# the backward passes: D, q, k, v, [o,] dout, dq | dk, dv, lse, di, B, S, Hq,
# Hkv, scale, [mode, [plan, n_blocks, n_kt, splits, ws_k, ws_v, counters,
# n_counters,]] stream
_BWD_DQ = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_BWD_DKDV = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
_BWD_DKDV_PLAN = _BWD_DKDV[:-1] + [_P, _I, _I, _I, _P, _P, _P, _I, _P]
BWD_DQ = CudaKernel("flash_attention_bwd_dq", "flash_attention_bwd_dq_launch",
                    _BWD_DQ, source="flash_attention_bwd")
BWD_DKDV = CudaKernel("flash_attention_bwd_dkdv",
                      "flash_attention_bwd_dkdv_launch", _BWD_DKDV_PLAN,
                      source="flash_attention_bwd")
BWD_F32_DQ = CudaKernel("flash_attention_bwd_f32_dq",
                        "flash_attention_bwd_f32_dq_launch", _BWD_DQ,
                        source="flash_attention_bwd")
BWD_F32_DKDV = CudaKernel("flash_attention_bwd_f32_dkdv",
                          "flash_attention_bwd_f32_dkdv_launch", _BWD_DKDV,
                          source="flash_attention_bwd")

# the split fold's arrival counters, by (device, stream): int32 zeros,
# and zero again after every launch (the kernel's last block of each
# group resets its counter)
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, S: int, Hq: int, Hkv: int, kv_max: int, n_sm: int, *,
         D: int = 128, dtype: torch.dtype = torch.bfloat16
         ) -> Tuple[str, int]:
    """(kernel, kv splits) of a launch.  bf16: ``flash_attention_decode``
    when one (b, KV head) has at most ``DECODE_ROWS`` (position,
    head-in-group) rows, else ``flash_attention`` (128 rows a block).
    Their kv tiles are split over blocks only when the blocks alone
    leave slots idle, into as many splits as fill one wave (two decode
    blocks per SM at D <= 128, one otherwise) with at least
    ``MIN_SPLIT_TILES`` tiles each.  f32: ``flash_attention_f32``
    (16 rows a block up to 16 rows, else 64), split when the blocks
    leave SMs idle, aiming at ``SPLIT_TARGET`` blocks per SM."""
    rows = S * (Hq // Hkv)
    n_tiles = _cdiv(kv_max, BK)
    if dtype == torch.float32:
        blocks = B * Hkv * _cdiv(rows, 16 if rows <= 16 else 64)
        splits = 1
        if blocks < n_sm:
            splits = max(1, min(_cdiv(SPLIT_TARGET * n_sm, blocks),
                                n_tiles // MIN_SPLIT_TILES))
        return F32.name, splits
    if rows <= DECODE_ROWS:
        kernel, blocks = DECODE.name, B * Hkv
        slots = n_sm * (2 if D <= 128 else 1)
    else:
        kernel, blocks = MMA.name, B * Hkv * _cdiv(rows, MMA_ROWS)
        slots = n_sm
    splits = 1
    if blocks < slots:
        splits = max(1, min(slots // blocks, n_tiles // MIN_SPLIT_TILES))
    return kernel, splits


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share one type, float32 or "
                             f"bfloat16; got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must have 4 dims, got "
                             f"{tuple(t.shape)}")
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                t.stride(i) % vec for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"{name}: the last axis must be contiguous and "
                             f"rows 16-byte aligned, got strides "
                             f"{t.stride()}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if tuple(k.shape) != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be {(B, T, Hkv, D)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads")


def check_kv_len(kv_len: Union[None, int, torch.Tensor]) -> None:
    """Refuses a batch row with no key.  The kernel would write 0 there,
    where a softmax over scores all masked to -1e30 (the plain version,
    as JAX's ``_chunked_attention``) gives the mean of v."""
    if kv_len is not None and int(torch.as_tensor(kv_len).min()) < 1:
        raise ValueError(f"every batch row needs a key, got kv_len {kv_len}")


def _kv(kv_len, q: torch.Tensor, B: int, T: int) -> Tuple[Optional[int], int]:
    """(device pointer of a (B,) kv_len tensor or None, kv_max)."""
    check_kv_len(kv_len)
    kv_ptr, kv_max = None, T
    if isinstance(kv_len, torch.Tensor):
        if (kv_len.device != q.device or kv_len.dtype != torch.int32
                or tuple(kv_len.shape) != (B,) or not kv_len.is_contiguous()):
            raise ValueError(f"kv_len must be a contiguous int32 ({B},) "
                             f"tensor on {q.device}")
        kv_ptr = kv_len.data_ptr()
    elif kv_len is not None:
        kv_max = min(T, int(kv_len))
    if kv_max < 1:
        raise ValueError(f"no keys to attend to (kv_len {kv_len})")
    return kv_ptr, kv_max


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the split fold on ``stream``: the
    cached buffer, or a fresh zeroed one where it is too small (the only
    time a split call costs a memset)."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _fwd(q, k, v, kv, *, causal, scale, q_offset, kernel, splits,
         rpt=None, lse=None):
    """One launch of ``kernel`` (``kv``: ``_kv``'s pointer and kv_max):
    the output (B, S, Hq, D) in q's type, and with ``splits`` > 1 the
    partials it folded, else None.  ``lse``: None, or a (B, Hkv, rows) f32
    tensor the tile kernels fill with each row's logsumexp (splits 1)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rows = S * (Hq // Hkv)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    want = torch.float32 if kernel == F32.name else torch.bfloat16
    if kernel not in _FWD or q.dtype != want:
        raise ValueError(f"{kernel} does not take {q.dtype}")
    if kernel == DECODE.name and rows > DECODE_ROWS:
        raise ValueError(f"{kernel} takes at most {DECODE_ROWS} rows per KV "
                         f"head, got {rows}")
    if rpt is not None and kernel != F32.name:
        raise ValueError("rows per thread (rpt) is a flash_attention_f32 "
                         "option")
    rpt = rpt or (1 if rows <= 16 else 4)
    kv_ptr, kv_max = kv
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        t.stride(i) for t in (q, k, v, out) for i in range(3)))
    stream = stream_ptr(q)
    ws, split_args = None, [None, None, None, None, 0]
    if splits > 1:
        # one allocation: acc first (16-byte aligned for the fold's
        # loads), then m and l
        shape = (splits, B, Hkv, rows)
        n_ml = splits * B * Hkv * rows
        buf = torch.empty(n_ml * (D + 2), dtype=torch.float32,
                          device=q.device)
        acc, m, l = buf.split([n_ml * D, n_ml, n_ml])
        ws = (m.view(shape), l.view(shape), acc.view(shape + (D,)))
        # one counter per (row tile, b, KV head); sized for the smallest
        # row tile, so it covers every kernel's grid
        n = B * Hkv * _cdiv(rows, MIN_ROW_TILE)
        cnt = _counters(q.device, stream, n)
        split_args = [*(w.data_ptr() for w in ws), cnt.data_ptr(), n]
    extra = [rpt, splits] if kernel == F32.name else [splits]
    _FWD[kernel].launch(D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, Hq, Hkv, strides, int(causal),
                        q_offset, kv_ptr, kv_max, scale, *extra,
                        *split_args, None if lse is None else lse.data_ptr(),
                        stream)
    return out, ws


def _plan(q: torch.Tensor, k: torch.Tensor, kv_max: int) -> Tuple[str, int]:
    B, S, Hq, D = q.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return plan(B, S, Hq, k.shape[2], kv_max, n_sm, D=D, dtype=q.dtype)


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, scale: float, q_offset: int = 0,
                          kv_len: Union[None, int, torch.Tensor] = None,
                          splits: int, kernel: Optional[str] = None,
                          rpt: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``flash_attention`` with the kv tiles of every (b, KV head) split
    into ``splits`` ranges, whatever ``plan`` would choose: one launch.
    Returns the output and the partials it folded, each range's softmax
    state in f32: (m, l) (splits, B, Hkv, rows) and acc (splits, B, Hkv,
    rows, D), rows being the S * Hq / Hkv (position, head-in-group)
    pairs, position-major (``ref.merge_ref`` of them is the output).
    ``kernel`` defaults to ``plan``'s choice; ``rpt`` (1 or 4 rows per
    thread) is ``flash_attention_f32``'s.  ``splits`` must be at least
    2: with one the kernels write no partials."""
    if splits < 2:
        raise ValueError(f"a split launch needs at least 2 splits, got "
                         f"{splits}")
    if _wants_grad(q, k, v):
        raise RuntimeError("flash_attention_split has no backward: call it "
                           "with grad off (torch.no_grad) or on tensors "
                           "that do not require grad")
    _check(q, k, v)
    kv = _kv(kv_len, q, q.shape[0], k.shape[1])
    return _fwd(q, k, v, kv, causal=causal, scale=scale, q_offset=q_offset,
                kernel=kernel or _plan(q, k, kv[1])[0], splits=splits,
                rpt=rpt)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float, q_offset: int = 0,
                    kv_len: Union[None, int, torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D), one type (f32 or bf16), on one
    card, any strides with a contiguous last axis.  Row i of q sits at
    position ``q_offset + i``; ``causal`` masks keys past it; ``kv_len``
    (an int, a CUDA int32 (B,) tensor, or None for T; at least 1 for every
    row) masks keys at or past it, which are never read.  Returns (B, S,
    Hq, D) in q's type: one launch of ``plan``'s kernel, which folds its
    splits itself when it splits the kv range."""
    if _wants_grad(q, k, v):
        check_train_case(S=q.shape[1], T=k.shape[1], D=q.shape[3],
                         causal=causal, q_offset=q_offset, kv_len=kv_len)
        return FlashAttention.apply(q, k, v, scale)
    _check(q, k, v)
    kv = _kv(kv_len, q, q.shape[0], k.shape[1])
    kernel, splits = _plan(q, k, kv[1])
    return _fwd(q, k, v, kv, causal=causal, scale=scale, q_offset=q_offset,
                kernel=kernel, splits=splits)[0]


# ---------------------------------------------------------------------------
# training: the forward with lse, the backward, the autograd.Function
# ---------------------------------------------------------------------------

def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def check_train_case(*, S: int, T: int, D: int, causal: bool, q_offset: int,
                     kv_len) -> None:
    """Raises, naming the case, for a call under autograd that the
    backward kernels do not take: they take what ``lm_loss`` calls
    (causal, ``q_offset`` 0, no ``kv_len``, S equal to T, a head dim of
    ``HEAD_DIMS``)."""
    why = []
    if not causal:
        why.append("causal=False")
    if q_offset != 0:
        why.append(f"q_offset {q_offset}")
    if kv_len is not None:
        why.append("a kv_len")
    if S != T:
        why.append(f"{S} queries over {T} keys")
    if D not in HEAD_DIMS:
        why.append(f"head dim {D}")
    if why:
        raise NotImplementedError(
            "the flash-attention backward takes causal self-attention with "
            "q_offset 0, no kv_len and S equal to T (what lm_loss calls), "
            f"head dims {HEAD_DIMS}; under grad it got " + ", ".join(why)
            + ": call it with grad off (torch.no_grad) for serving")


def train_plan(dtype: torch.dtype) -> Tuple[str, int]:
    """(kernel, kv splits) of the training route's forward: the tile
    kernel of the input type at one split, whatever ``plan`` would choose
    (the decode kernel and the split fold write no lse)."""
    return (F32.name if dtype == torch.float32 else MMA.name), 1


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training route's forward, causal self-attention (S equal to
    T): (output (B, S, Hq, D) in q's type, lse (B, Hkv, S * Hq / Hkv) f32),
    lse in natural units (log of the sum of e^(q.k * scale) over the kept
    keys, ``lse_by_head`` gives it as (B, Hq, S)).  One launch of
    ``train_plan``'s kernel."""
    _check(q, k, v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    check_train_case(S=S, T=k.shape[1], D=D, causal=True, q_offset=0,
                     kv_len=None)
    kernel, splits = train_plan(q.dtype)
    lse = torch.empty((B, Hkv, S * (Hq // Hkv)), dtype=torch.float32,
                      device=q.device)
    out = _fwd(q, k, v, _kv(None, q, B, S), causal=True, scale=scale,
               q_offset=0, kernel=kernel, splits=splits, lse=lse)[0]
    return out, lse


def lse_by_head(lse: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The kernels' (B, Hkv, S * rep) lse, rows position-major, as (B,
    n_heads, S)."""
    B, Hkv, rows = lse.shape
    rep = n_heads // Hkv
    return lse.view(B, Hkv, rows // rep, rep).permute(0, 1, 3, 2).reshape(
        B, n_heads, rows // rep)


BWD_ROWS = 64                  # flattened rows of a dkdv row tile
BWD_KEYS = 64                  # keys of a bf16 dkdv block
MIN_SPLIT_ROW_TILES = 4        # row tiles of a dkdv split, at least


class BwdPlan(NamedTuple):
    """The bf16 dkdv pass's launch plan (``bwd_plan``): ``key_tile`` keys
    a block, row tiles of ``row_tile`` flattened rows, and for each key
    tile its splits' row-tile ranges [first, end), in order, covering the
    key tile's row tiles (from the first that sees it to the last) once."""
    key_tile: int
    row_tile: int
    ranges: Tuple[Tuple[Tuple[int, int], ...], ...]

    @property
    def splits(self) -> int:
        """The most splits of any key tile (1: no fold)."""
        return max(len(r) for r in self.ranges)

    @property
    def blocks(self) -> int:
        """Blocks of one (b, KV head)."""
        return sum(len(r) for r in self.ranges)


def bwd_plan(B: int, S: int, Hq: int, Hkv: int, D: int, n_sm: int, *,
             splits: Optional[int] = None) -> BwdPlan:
    """The dkdv pass's plan for causal self-attention at (B, S, Hq, Hkv,
    D) on ``n_sm`` SMs.  Key tile t (64 keys) is seen by the flattened
    rows from position 64 t on: row tiles ``64 t rep // 64`` to the last,
    each costing the block the same products whatever its mask keeps (a
    kept pair's work is its row tile's).  One block a key tile, the
    longest first, leaves the card to the longest when one key tile's
    row tiles exceed an SM's share of all of them (MQA: gemma-2b at S
    4,096 has 64 key tiles of one KV head, 512 row tiles in the first);
    then every key tile's row tiles are cut into near-equal ranges of at
    most half that share (at least ``MIN_SPLIT_ROW_TILES``), so each split
    holds about the same causal work and the key tiles that more rows
    see get more splits.  ``splits`` forces that many ranges a key tile
    (fewer where it has fewer row tiles)."""
    if D not in HEAD_DIMS or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"no backward plan at head dim {D}, {Hq} heads "
                         f"over {Hkv}")
    rep = Hq // Hkv
    n_rt = _cdiv(S * rep, BWD_ROWS)
    first = [t * BWD_KEYS * rep // BWD_ROWS
             for t in range(_cdiv(S, BWD_KEYS))]
    work = [n_rt - f for f in first]
    if splits is not None:
        if splits < 1:
            raise ValueError(f"splits must be at least 1, got {splits}")
        counts = [min(splits, w) for w in work]
    else:
        share = B * Hkv * sum(work) / n_sm
        chunk = (max(work) if max(work) <= share
                 else max(MIN_SPLIT_ROW_TILES, int(share // 2)))
        counts = [_cdiv(w, chunk) for w in work]
    return BwdPlan(BWD_KEYS, BWD_ROWS, tuple(
        tuple((f + i * w // n, f + (i + 1) * w // n) for i in range(n))
        for f, w, n in zip(first, work, counts)))


# the plans' tables on the card, by (plan, device): (table, blocks, slots)
_BWD_TABLES: Dict[Tuple[BwdPlan, torch.device],
                  Tuple[torch.Tensor, int, int]] = {}


def bwd_table(plan: BwdPlan) -> Tuple[list, int]:
    """The kernel's view of a plan: 4 ints a block (key tile, first row
    tile, end row tile, split), the longest ranges first, then 2 a key
    tile (its first workspace slot, -1 where it does not split, and its
    splits); and the workspace slots (one a split of a split key tile)."""
    blocks = sorted(((t, lo, hi, i) for t, r in enumerate(plan.ranges)
                     for i, (lo, hi) in enumerate(r)),
                    key=lambda e: (e[1] - e[2], e[0], e[3]))
    groups, slots = [], 0
    for r in plan.ranges:
        groups += [slots if len(r) > 1 else -1, len(r)]
        slots += len(r) if len(r) > 1 else 0
    return [x for e in blocks for x in e] + groups, slots


def _bwd_table(plan: BwdPlan, device: torch.device
               ) -> Tuple[torch.Tensor, int, int]:
    key = (plan, device)
    if key not in _BWD_TABLES:
        table, slots = bwd_table(plan)
        _BWD_TABLES[key] = (torch.tensor(table, dtype=torch.int32,
                                         device=device), plan.blocks, slots)
    return _BWD_TABLES[key]


def _bwd_check(q, k, v, do, lse, o=None, di=None) -> None:
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rows = (B, Hkv, S * (Hq // Hkv))
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("q", q, (B, S, Hq, D), q.dtype), ("o", o, (B, S, Hq, D), q.dtype),
            ("k", k, (B, S, Hkv, D), q.dtype),
            ("v", v, (B, S, Hkv, D), q.dtype),
            ("dout", do, (B, S, Hq, D), q.dtype),
            ("lse", lse, rows, f32), ("di", di, rows, f32)):
        if t is None:
            continue
        check_cuda(name, t, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    if q.dtype not in _DTYPES or D not in HEAD_DIMS or Hq % Hkv:
        raise ValueError(f"no backward kernel for {q.dtype} at head dim {D}, "
                         f"{Hq} heads over {Hkv}")


def bwd_dq(q, k, v, o, do, lse, *, scale: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the backward: (dQ in q's type, Di (B, Hkv, rows) f32)."""
    _bwd_check(q, k, v, do, lse, o=o)
    B, S, Hq, D = q.shape
    dq = torch.empty_like(q)
    di = torch.empty_like(lse)
    kern = BWD_F32_DQ if q.dtype == torch.float32 else BWD_DQ
    kern.launch(D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), lse.data_ptr(), di.data_ptr(),
                B, S, Hq, k.shape[2], scale, stream_ptr(q))
    return dq, di


def bwd_dkdv(q, k, v, do, lse, di, *, scale: float,
             splits: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the backward, after ``bwd_dq`` (it reads Di): (dK, dV) in
    q's type, summed over each KV group's query heads.  bf16 follows
    ``bwd_plan`` (``splits`` forces its ranges a key tile), with the
    split key tiles' f32 partials in a workspace allocated here, and at
    head dim 256 launches twice (dV, then dK: the two 64 x 256
    accumulators would take every register)."""
    _bwd_check(q, k, v, do, lse, di=di)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = stream_ptr(q)
    args = [D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), di.data_ptr(), B, S,
            Hq, Hkv, scale]
    if q.dtype == torch.float32:
        if splits is not None:
            raise ValueError("splits is an option of the bf16 dkdv pass")
        BWD_F32_DKDV.launch(*args, 0, stream)
        return dk, dv
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = bwd_plan(B, S, Hq, Hkv, D, n_sm, splits=splits)
    table, n_blocks, slots = _bwd_table(plan, q.device)
    n_kt = len(plan.ranges)
    modes = (0,) if D <= 128 else (1, 2)
    ws, cnt, n = [None, None], None, 0
    if plan.splits > 1:
        # the kernels' head dim (D 32 runs padded to 64); the two modes at
        # D 256 run one after the other and share one buffer
        per = slots * B * Hkv * plan.key_tile * max(D, 64)
        buf = torch.empty(per * len(ws) // len(modes), dtype=torch.float32,
                          device=q.device)
        ws = [buf[:per], buf[-per:]]
        n = n_kt * B * Hkv
        cnt = _counters(q.device, stream, n)
    for mode in modes:
        BWD_DKDV.launch(*args, mode, table.data_ptr(), n_blocks, n_kt,
                        plan.splits, *(w if w is None else w.data_ptr()
                                       for w in ws),
                        None if cnt is None else cnt.data_ptr(), n, stream)
    return dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, scale: float,
                        splits: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of causal self-attention in q's type, from the forward's
    output ``o`` and ``lse`` (``flash_attention_lse``) and the output's
    gradient ``do``; all of q, k, v, o, do contiguous.  Two passes:
    ``bwd_dq`` then ``bwd_dkdv`` (``splits``: see there); no atomics on
    values, so a run repeats bitwise."""
    dq, di = bwd_dq(q, k, v, o, do, lse, scale=scale)
    dk, dv = bwd_dkdv(q, k, v, do, lse, di, scale=scale, splits=splits)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal self-attention on the card with its gradient: the training
    route's forward (``flash_attention_lse``) saves q, k, v, the output
    and lse; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_attention_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         scale=ctx.scale)
        return dq, dk, dv, None
