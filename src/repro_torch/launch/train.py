"""Architecture launcher (``--arch <id>``) of the port, as
``repro/launch/train.py``: a reduced-size training loop for a registered
recsys architecture, on CUDA unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec --device cpu

Batches come from ``numpy.random.default_rng(0)`` in the JAX launcher's
order, so both launchers feed the same ids; the initial parameters come
from a ``torch.Generator`` seeded 0 on the device (``jax.random`` draws
cannot be reproduced).  Like the JAX loop, this one does not clip the
gradients (``launch.steps.recsys_train_step`` does).
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig, get_arch, list_archs
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.recsys import models as R
from repro_torch.optim import optimizers as opt_lib


def _reduced(cfg: RecsysConfig) -> RecsysConfig:
    return dc.replace(cfg, default_vocab=5000, dtype="float32",
                      param_dtype="float32")


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
               device=None) -> float:
    """``steps`` unclipped ``rankgraph2_optimizer`` steps; returns the
    last loss."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev)
    flat = R.flatten_params(params)
    opt = opt_lib.rankgraph2_optimizer()
    st = opt.init(flat)
    name = "loss" if cfg.kind == "sasrec" else "bce"
    for t in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in _batches(cfg, rng, batch).items()}
        loss, g = loss_and_grads(params, cfg, b)
        with torch.no_grad():
            upd, st = opt.update(g, st, flat)
            opt_lib.apply_updates(flat, upd)
        if t % max(steps // 5, 1) == 0:
            print(f"[{t}] {cfg.kind} {name} {float(loss):.3f}")
    return float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm2",
                    choices=[a for a in list_archs()
                             if get_arch(a).family == "recsys"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    run_recsys(_reduced(get_arch(args.arch).config), args.steps,
               device=args.device)
    print(f"done in {time.perf_counter()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
