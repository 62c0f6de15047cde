"""Co-learned residual-quantization cluster index (paper §4.4), as
``repro/core/rq_index.py``: codebook initialisation, the training
forward ``rq_forward`` (Eq. 9-13: biased code selection, reconstruction
with commitment, the balance regularizer, the utilization gap, the
ring-buffer histograms and EMA usage), hard assignment (Eq. 9) and
utilisation of published assignments.

Codebooks are a ``ModuleDict({"codebooks": ParameterDict({"layer{l}":
(n_l, d)})})`` so ``rq["codebooks"]["layer0"]`` reads as in the JAX
params tree.

The dead-code reset (``dead_code_reset``, fed the EMA usage or the
corpus occupancy ``per_code_counts``) is host numpy, as in the
reference: its argmin is the norm expansion in numpy, not the
``rq_assign`` kernel, whose exact direct distance rounds differently
and would move near-tie donor members.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RQConfig
from repro_torch.distributed.collectives import sum_across, sum_across_
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.rq_assign.ops import flat_codes, rq_assign


def codebooks_module(books: Sequence[torch.Tensor]) -> torch.nn.ModuleDict:
    """Wrap per-layer codebooks as the ``rq`` params subtree."""
    return torch.nn.ModuleDict({"codebooks": torch.nn.ParameterDict({
        f"layer{l}": torch.nn.Parameter(c, requires_grad=False)
        for l, c in enumerate(books)})})


def init_rq(cfg: RQConfig, d: int, *, generator: torch.Generator,
            dtype: torch.dtype = torch.float32,
            device=None) -> torch.nn.ModuleDict:
    """Normal codebooks, small and shrinking per layer (residuals shrink
    per layer): layer l has scale 0.1 / (l + 1)."""
    books = []
    for l, n in enumerate(cfg.codebook_sizes):
        c = torch.empty((n, d), dtype=dtype).normal_(generator=generator)
        books.append(c * (0.1 / (l + 1)))
    return codebooks_module(books).to(resolve_device(device))


@dataclasses.dataclass
class RQState:
    """Ring buffers of per-batch code counts plus EMA usage, per layer.
    ``ptr`` and ``filled`` count steps, known on the host."""
    hists: Tuple[torch.Tensor, ...]     # (hist_len, n_codes_l) float32
    usage: Tuple[torch.Tensor, ...]     # (n_codes_l,) f32 EMA batch freq
    ptr: int = 0
    filled: int = 0


def init_rq_state(cfg: RQConfig, device=None) -> RQState:
    """Empty histograms and a uniform usage prior (no code is born
    dead)."""
    dev = resolve_device(device)
    hists = tuple(torch.zeros((cfg.hist_len, n), device=dev)
                  for n in cfg.codebook_sizes)
    usage = tuple(torch.full((n,), 1.0 / n, device=dev)
                  for n in cfg.codebook_sizes)
    return RQState(hists, usage)


def _phat(hist: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    tot = hist.sum(dim=0)
    return (tot + eps) / (tot.sum() + eps * hist.shape[1])


def _soft_assign(dist: torch.Tensor, zeta1: float, zeta2: float
                 ) -> torch.Tensor:
    """Eq. 11: p[j] = softmax_j( zeta1 / (zeta2 + d_j) )."""
    return torch.softmax(zeta1 / (zeta2 + dist), dim=-1)


def _row_mean(x: torch.Tensor, group, n_total: int) -> torch.Tensor:
    """Mean over dim 0 of the whole batch: this rank's rows' sum reduced
    over ``group`` (gradient to this rank's rows only), or ``x.mean(0)``
    on one process."""
    if group is None:
        return x.mean(dim=0)
    return sum_across(x.sum(dim=0), group) / n_total


def rq_forward(rq_params, state: RQState, h: torch.Tensor, cfg: RQConfig,
               *, train: bool = True,
               codes: Optional[torch.Tensor] = None,
               group=None, n_rows: Optional[int] = None
               ) -> Dict[str, object]:
    """Quantize h (B, d).  Returns codes, recon, losses and the new state.

    Code *selection* is discrete; the reconstruction h' = sum_l C_l[k_l]
    is differentiable with respect to the codebooks, and the
    straight-through ``recon_st`` with respect to h.  The distances are
    a plain f32 ``torch.matmul`` (TF32 stays off: they pick argmins).
    ``codes`` (B, L), if given, are taken as the selections (Eq. 9 or
    13) in place of the ones chosen here, so that two precisions can be
    held to the same discrete choices; everything else is computed as
    usual.

    ``group``: a data-parallel process group whose ranks each pass a
    block of the batch, ``n_rows`` rows in all.
    The batch statistics (the soft and hard code frequencies, the routed
    counts, the mean reconstruction and commitment losses, the EMA
    usage) are then the whole batch's, reduced over the group, and every
    rank gets the same losses and new state; the selections and
    ``recon_st`` stay this rank's rows."""
    h32 = h.to(torch.float32)
    resid = h32
    recon = torch.zeros_like(h32)
    given, codes, reg_terms, util_terms = codes, [], [], []
    new_counts, hard_counts = [], []
    biased = cfg.biased_selection and train
    B = h32.shape[0] if group is None else n_rows

    for l, n_l in enumerate(cfg.codebook_sizes):
        C = rq_params["codebooks"][f"layer{l}"].to(torch.float32)  # (n, d)
        r = resid.detach()
        d2 = ((r * r).sum(dim=1, keepdim=True) - 2.0 * (r @ C.T)
              + (C * C).sum(dim=1)[None, :])
        dist = torch.sqrt(torch.clamp_min(d2, 0.0) + 1e-12)     # (B, n)
        p_soft = _soft_assign(dist, cfg.zeta1, cfg.zeta2)
        phat = _phat(state.hists[l])
        k_hard = torch.argmin(dist, dim=1)                      # Eq. 9
        if given is not None:
            k = given[:, l].to(device=h.device, dtype=torch.long)
        elif biased:
            k = torch.argmax(p_soft / phat[None, :], dim=1)     # Eq. 13
        else:
            k = k_hard
        codes.append(k)
        sel = C[k]                                    # diff w.r.t. C
        recon = recon + sel
        resid = resid - sel
        # regularizer (Eq. 12): batch soft frequency . rolling histogram
        p_batch = p_soft.sum(dim=0)
        if group is not None:
            p_batch = sum_across(p_batch, group)
        p_batch = p_batch / torch.clamp_min(p_batch.sum(), 1e-12)
        reg_terms.append(torch.dot(phat, p_batch) * n_l)
        # utilization balance: the hard (Eq. 9) batch fractions carry no
        # gradient, the mean soft assignment does
        f_hard = torch.bincount(k_hard, minlength=n_l).to(torch.float32)
        if group is not None:
            sum_across_(f_hard, group)
        f_hard = f_hard / max(float(B), 1.0)
        if n_l > 1:
            p_mean = _row_mean(p_soft, group, B)
            p_mean = p_mean / torch.clamp_min(p_mean.sum(), 1e-12)
            gap = (n_l * torch.dot(f_hard, p_mean) - 1.0) / (n_l - 1.0)
            util_terms.append(torch.clamp_min(gap, 0.0))
        hard_counts.append(f_hard * B)
        # routed counts for the rolling histogram (Eq. 12/13 operate on
        # the selection actually taken, biased or not)
        counts = torch.bincount(k, minlength=n_l).to(torch.float32)
        new_counts.append(counts if group is None
                          else sum_across_(counts, group))

    if group is None:
        recon_loss = ((h32.detach() - recon) ** 2).sum(dim=1).mean()
        commit = ((h32 - recon.detach()) ** 2).sum(dim=1).mean()
    else:
        recon_loss = _row_mean(((h32.detach() - recon) ** 2).sum(dim=1),
                               group, B)
        commit = _row_mean(((h32 - recon.detach()) ** 2).sum(dim=1),
                           group, B)
    l_recon = recon_loss + cfg.commit_coef * commit
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    l_reg = torch.stack(reg_terms).mean() if cfg.regularize else zero
    l_util = (cfg.util_coef * torch.stack(util_terms).mean()
              if cfg.util_coef > 0 and util_terms else zero)
    recon_st = h32 + (recon - h32).detach()                 # encoder path

    if train:
        with torch.no_grad():
            p = state.ptr % cfg.hist_len
            hists = []
            for hh, c in zip(state.hists, new_counts):
                hh = hh.clone()
                hh[p] = c
                hists.append(hh)
            # deadness tracks the *argmin* assignment
            Bm = max(B, 1)
            usage = tuple(cfg.usage_ema * u + (1.0 - cfg.usage_ema) * (c / Bm)
                          for u, c in zip(state.usage, hard_counts))
        new_state = RQState(tuple(hists), usage, state.ptr + 1,
                            min(state.filled + 1, cfg.hist_len))
    else:
        new_state = state

    return dict(codes=torch.stack(codes, dim=1), recon=recon,
                recon_st=recon_st.to(h.dtype), l_recon=l_recon, l_reg=l_reg,
                l_util=l_util, state=new_state)


def codebook_utilization(state: RQState) -> List[float]:
    """Fraction of codes used at least once in the rolling window."""
    return [float((hist.sum(dim=0) > 0).to(torch.float32).mean())
            for hist in state.hists]


def layer_books(rq_params, n_layers: int) -> List[torch.Tensor]:
    return [rq_params["codebooks"][f"layer{l}"] for l in range(n_layers)]


def assign_codes(rq_params, h: torch.Tensor, cfg: RQConfig) -> torch.Tensor:
    """Inference-time hard assignment (Eq. 9): (B,) int64 flat cluster
    ids, through ``rq_assign`` (the kernel on a CUDA tensor)."""
    codes, _ = rq_assign(h, layer_books(rq_params, len(cfg.codebook_sizes)))
    return flat_codes(codes, cfg.codebook_sizes)


def codes_utilization(codes, codebook_sizes) -> List[float]:
    """Fraction of each layer's codebook hit at least once by ``codes``
    ``(N, L)`` (numpy or tensor).  An empty corpus gives 0.0 per layer,
    a 1-D ``codes`` is single-layer ``(N, 1)``, sizes below 1 give 0.0;
    values lie in ``[0, 1]``."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[:, None]
    out = []
    for l, size in enumerate(codebook_sizes):
        if size < 1 or len(codes) == 0:
            out.append(0.0)
            continue
        used = np.unique(codes[:, l])
        out.append(min(float(len(used)) / float(size), 1.0))
    return out


def per_code_counts(codes, codebook_sizes) -> List[np.ndarray]:
    """Per-layer code occupancy of ``codes`` ``(N, L)`` (numpy or
    tensor): how many rows land on each code, f32.  The corpus-side
    usage signal the repair path feeds to ``dead_code_reset`` (EMA usage
    can look healthy long after the published assignments collapsed)."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[:, None]
    out = []
    for l, size in enumerate(codebook_sizes):
        if size < 1:
            out.append(np.zeros(0, np.float32))
        elif len(codes) == 0:
            out.append(np.zeros(size, np.float32))
        else:
            out.append(np.bincount(codes[:, l].astype(np.int64),
                                   minlength=size).astype(np.float32))
    return out


def _host_f32(x) -> np.ndarray:
    """A float32 numpy copy of an array or tensor (on any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, np.float32)


def dead_code_reset(rq_params, state: RQState, h, cfg: RQConfig, *,
                    seed: int, step: int = 0, usage=None
                    ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], RQState,
                               Dict[str, int]]:
    """Re-seed dead codes from high-load clusters' residuals.

    A code of layer ``l`` is *dead* when its usage share falls below
    ``cfg.dead_floor / n_codes_l``.  Usage defaults to the EMA counters
    carried in ``state``; the repair path overrides it with the
    published corpus occupancy (``per_code_counts``), which is what
    actually collapsed.  Each dead code is re-seeded at the layer-``l``
    residual of a member of a high-load (donor) cluster — donors are
    cycled in usage-descending order, the member pick and a tiny
    de-duplicating jitter are drawn from ``default_rng((seed, step, l,
    code))``, so the pass is bit-deterministic and independent of probe
    chunking.  ``h`` (P, d) is a probe of current embeddings.

    Guarantees: live rows are bit-unchanged, so with the pre-reset
    residuals any assignment that moves can only move *to* a revived
    code.  Revived codes' EMA usage restarts at the live mean.

    Host numpy throughout, bitwise equal to the JAX package.  Returns
    ``(new_params, new_state, report)``: ``new_params["codebooks"]``
    holds new f32 codebooks on the codebooks' devices, ``new_state``
    the same histograms, ``ptr`` and ``filled`` with the new usage on
    the usage's devices, and ``report['reset_layer{l}']`` the number of
    codes re-seeded.
    """
    h = _host_f32(h)
    L = len(cfg.codebook_sizes)
    params = [rq_params["codebooks"][f"layer{l}"] for l in range(L)]
    books = [_host_f32(c) for c in params]

    def _argmin(resid: np.ndarray, C: np.ndarray) -> np.ndarray:
        if not len(resid):
            return np.zeros(0, np.int64)
        d2 = (np.sum(resid * resid, axis=1, keepdims=True)
              - 2.0 * resid @ C.T + np.sum(C * C, axis=1)[None, :])
        return d2.argmin(axis=1)

    usage_in = usage if usage is not None else state.usage
    report: Dict[str, int] = {}
    new_usage: List[np.ndarray] = []
    # the eval-mode (Eq. 9) residual cascade is recomputed layer by
    # layer *after* each layer's reseed: a revived coarse code changes
    # the residuals the next layer quantizes
    resid = h.copy()
    for l in range(L):
        K = cfg.codebook_sizes[l]
        u = _host_f32(usage_in[l])
        u = u / max(float(u.sum()), 1e-12)
        dead = np.flatnonzero(u < cfg.dead_floor / K)
        live = np.flatnonzero(u >= cfg.dead_floor / K)
        if len(dead) == 0 or len(live) == 0 or len(h) == 0:
            report[f"reset_layer{l}"] = 0
            new_usage.append(u)
            resid = resid - books[l][_argmin(resid, books[l])]
            continue
        # donors: live codes, heaviest first (stable ties by index)
        donors = live[np.argsort(-u[live], kind="stable")]
        a = _argmin(resid, books[l])       # pre-reset donor membership
        rms = float(np.sqrt(np.mean(resid * resid))) or 1.0
        for j_i, j in enumerate(np.sort(dead)):
            donor = int(donors[j_i % len(donors)])
            members = np.flatnonzero(a == donor)
            pool = members if len(members) else np.arange(len(resid))
            rng = np.random.default_rng((seed, step, l, int(j)))
            pick = int(pool[min(int(rng.random() * len(pool)),
                                len(pool) - 1)])
            jitter = rng.normal(size=resid.shape[1]).astype(np.float32)
            books[l][j] = resid[pick] + jitter * (1e-3 * rms)
        u[dead] = float(u[live].mean())
        new_usage.append(u / max(float(u.sum()), 1e-12))
        report[f"reset_layer{l}"] = int(len(dead))
        resid = resid - books[l][_argmin(resid, books[l])]

    new_params = {"codebooks": {
        f"layer{l}": torch.from_numpy(books[l]).to(params[l].device)
        for l in range(L)}}
    new_state = RQState(state.hists, tuple(
        torch.from_numpy(u).to(old.device)
        for u, old in zip(new_usage, state.usage)), state.ptr, state.filled)
    return new_params, new_state, report


def reconstruct(rq_params, codes: torch.Tensor, cfg: RQConfig
                ) -> torch.Tensor:
    """codes (B, L) -> reconstructed embeddings (Eq. 10)."""
    out = None
    for l in range(len(cfg.codebook_sizes)):
        C = rq_params["codebooks"][f"layer{l}"]
        sel = C.index_select(0, codes[:, l].to(C.device, torch.long))
        out = sel if out is None else out + sel
    return out
