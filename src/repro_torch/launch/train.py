"""Architecture launcher (``--arch <id>``) of the port, as
``repro/launch/train.py``: a reduced-size training loop for a registered
LM or recsys architecture, on CUDA unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch grok-1-314b --device cpu

Batches and tokens come from ``numpy.random.default_rng(0)`` in the JAX
launcher's order, so both launchers feed the same ids; the initial
parameters come from a ``torch.Generator`` seeded 0 on the device
(``jax.random`` draws cannot be reproduced; ``run_lm(params=)`` takes a
tree carried over from JAX).  Like the JAX loops, these do not clip the
gradients (``launch.steps.recsys_train_step`` and ``lm_train_step`` do).
The reduced kimi-k2 keeps its top-8 over the 4 experts the cut leaves,
which the reference's ``jax.lax.top_k`` refuses; so does the port's
router.  The GNN family (equiformer-v2) is not ported (ROADMAP item 4).
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (LMConfig, RecsysConfig, get_arch,
                                      list_archs)
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.lm import model as LM
from repro_torch.models.recsys import models as R
from repro_torch.optim import optimizers as opt_lib


def _reduced(cfg):
    if isinstance(cfg, LMConfig):
        return dc.replace(cfg, n_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=32,
                          d_ff=256, moe_d_ff=256 if cfg.n_experts else None,
                          n_experts=min(cfg.n_experts, 4), vocab_size=512,
                          dtype="float32", param_dtype="float32")
    return dc.replace(cfg, default_vocab=5000, dtype="float32",
                      param_dtype="float32")


def run_lm(cfg: LMConfig, steps: int, batch: int = 4, seq: int = 64,
           device=None, params: Optional[LM.Params] = None) -> List[float]:
    """``steps`` unclipped AdamW steps (lr 1e-3) of ``lm_loss`` at
    ``block_q`` 32 on tokens (batch, seq); returns every step's loss.
    ``params``: a tree on the device to start from (updated in place), by
    default one drawn from a ``torch.Generator`` seeded 0."""
    dev = resolve_device(device)
    if params is None:
        params = LM.init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    flat = LM.named_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    opt = opt_lib.make_optimizer("adamw", 1e-3)
    st = opt.init(flat)
    rng = np.random.default_rng(0)
    losses = []
    for t in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, seq))).to(dev)
        loss = LM.lm_loss(params, cfg, toks, block_q=32)
        grads = dict(zip(flat, torch.autograd.grad(loss,
                                                   list(flat.values()))))
        st = opt_lib.apply_leafwise(opt, grads, st, flat)
        losses.append(float(loss.detach()))
        if t % max(steps // 5, 1) == 0:
            print(f"[{t}] lm loss {losses[-1]:.3f}")
    return losses


def _batches(cfg: RecsysConfig, rng: np.random.Generator, batch: int):
    """One batch of numpy arrays, drawn in the JAX launcher's order."""
    V = cfg.default_vocab
    labels = lambda: (rng.random(batch) > .5).astype(np.float32)  # noqa: E731
    if cfg.kind == "dlrm":
        return {"dense": rng.normal(size=(batch, cfg.n_dense)
                                    ).astype(np.float32),
                "sparse": rng.integers(0, V, (batch, cfg.n_sparse)),
                "labels": labels()}
    if cfg.kind == "wide_deep":
        return {"sparse": rng.integers(0, V, (batch, cfg.n_sparse)),
                "labels": labels()}
    if cfg.kind == "bst":      # the JAX launcher's "tgt" is "target" here
        return {"seq": rng.integers(-1, V, (batch, cfg.seq_len)),
                "target": rng.integers(0, V, batch),
                "other": rng.integers(0, V, (batch, cfg.n_sparse)),
                "labels": labels()}
    return {"seq": rng.integers(-1, V, (batch, cfg.seq_len)),
            "pos": rng.integers(0, V, batch),
            "neg": rng.integers(0, V, (batch, 20))}


def run_recsys(cfg: RecsysConfig, steps: int, batch: int = 256,
               device=None, ctx: Optional[ShardingCtx] = None) -> float:
    """``steps`` unclipped ``rankgraph2_optimizer`` steps; returns the
    last loss.  Under ``ctx`` every rank runs the same batches on its row
    shards of the kind's tables (``models.init_params(ctx=)``,
    ``row_sharded_leaves``) and gets the same loss."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev, ctx=ctx)
    flat = R.flatten_params(params)
    opt = opt_lib.rankgraph2_optimizer()
    st = opt.init(flat)
    name = "loss" if cfg.kind == "sasrec" else "bce"
    for t in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in _batches(cfg, rng, batch).items()}
        loss, g = loss_and_grads(params, cfg, b, ctx)
        with torch.no_grad():
            upd, st = opt.update(g, st, flat)
            opt_lib.apply_updates(flat, upd)
        if t % max(steps // 5, 1) == 0:
            print(f"[{t}] {cfg.kind} {name} {float(loss):.3f}")
    return float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="The GNN family (equiformer-v2) is not ported yet: ROADMAP "
               "item 4.")
    ap.add_argument("--arch", default="dlrm-rm2",
                    choices=[a for a in list_archs()
                             if get_arch(a).family in ("lm", "recsys")])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    t0 = time.perf_counter()
    run = run_lm if arch.family == "lm" else run_recsys
    run(_reduced(arch.config), args.steps, device=args.device)
    print(f"done in {time.perf_counter()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
