"""The port's ``lm_loss`` under autograd against the JAX package's, on the
same weights (JAX ``init_params`` carried over by ``lm_params_from_jax``)
and the same numpy tokens, at ``repro.launch.train._reduced``'s cut of
olmo-1b, llama3.2-3b and gemma-2b (2 layers, d 128, 4 heads, head dim 32,
vocab 512, f32), B 4 x S 64 and ``block_q`` 32 as ``run_lm`` calls it:

  * the loss and every parameter's gradient against
    ``jax.value_and_grad(lm_loss)``, with ``cfg.remat`` on (each layer
    under ``torch.utils.checkpoint``) and off: the loss within 1e-5
    relative and each gradient within 1e-4 of its largest magnitude (f32
    on both sides, sums in another order; seen: the loss within 2.3e-7,
    the gradients within 2e-6);
  * two AdamW steps (lr 1e-3, ``run_lm``'s optimizer) against JAX's step
    on the same tokens: the losses within 1e-5 relative, and, per the
    ROADMAP's "Optimizer sign" hazard (the first AdamW update is
    g / (|g| + 1e-8) entry by entry, so a near-zero gradient takes its
    sign from the order of its sum), the distribution of the parameter
    gaps rather than the largest: each parameter's median gap within
    1e-6 and at most 1% of its entries more than 1e-4 apart (the update
    moves an entry by at most about 2e-3 over the two steps);
  * ``named_params`` names every leaf once.

On the CPU the model's attention is ``chunked_attention_ref`` under
autograd; on the card it is the kernels' ``FlashAttention``, which
``chip_smoke.py`` Phase 9 holds against this path.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch.train import _reduced
from repro.models.lm import model as JLM
from repro.optim import optimizers as JO
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import model as LM
from repro_torch.optim.optimizers import adamw, apply_updates

torch.set_num_threads(2)

ARCHS = ["olmo-1b", "llama3.2-3b", "gemma-2b"]
B, S, BLOCK_Q, LR = 4, 64, 32, 1e-3
LOSS_REL, GRAD_OF_MAX = 1e-5, 1e-4
GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE = 1e-6, 1e-4, 0.01


def _configs(arch_id: str, remat: bool):
    j = dc.replace(_reduced(jax_get_arch(arch_id).config), remat=remat)
    return j, LMConfig(**dc.asdict(j))


def _setup(arch_id: str, remat: bool, seed: int):
    jcfg, cfg = _configs(arch_id, remat)
    jp, _ = JLM.init_params(jax.random.key(seed), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    params = lm_params_from_jax(jp, device="cpu")
    for p in LM.named_params(params).values():
        p.requires_grad_(True)
    return jcfg, cfg, jp, params


def _tokens(cfg, rng) -> np.ndarray:
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _flat_jax(tree) -> dict:
    """The JAX tree's leaves under ``named_params``'s names (stacked
    layers split per layer)."""
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    for k, v in tree["layers"].items():
        for i in range(v.shape[0]):
            out[f"layers.{i}.{k}"] = np.asarray(v[i])
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_gradients_match_jax(arch_id, remat):
    jcfg, cfg, jp, params = _setup(arch_id, remat, seed=len(arch_id))
    toks = _tokens(cfg, np.random.default_rng(len(arch_id) + 1))
    jloss, jg = jax.value_and_grad(lambda p: JLM.lm_loss(
        p, jcfg, jnp.asarray(toks), block_q=BLOCK_Q))(jp)
    loss = LM.lm_loss(params, cfg, torch.from_numpy(toks).long(),
                      block_q=BLOCK_Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL)
    want = _flat_jax(jg)
    got = LM.named_params(params)
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_OF_MAX * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_two_adamw_steps_match_jax(arch_id):
    jcfg, cfg, jp, params = _setup(arch_id, True, seed=3)
    jopt, opt = JO.make_optimizer("adamw", LR), adamw(LR)

    @jax.jit
    def jstep(p, st, toks):          # repro/launch/train.py::run_lm's step
        loss, g = jax.value_and_grad(
            lambda p_: JLM.lm_loss(p_, jcfg, toks, block_q=BLOCK_Q))(p)
        upd, st = jopt.update(g, st, p)
        return JO.apply_updates(p, upd), st, loss

    flat = LM.named_params(params)
    jst, st = jopt.init(jp), opt.init(flat)
    rng = np.random.default_rng(0)
    for t in range(2):
        toks = _tokens(cfg, rng)
        jp, jst, jloss = jstep(jp, jst, jnp.asarray(toks))
        loss = LM.lm_loss(params, cfg, torch.from_numpy(toks).long(),
                          block_q=BLOCK_Q)
        loss.backward()
        upd, st = opt.update({k: p.grad for k, p in flat.items()}, st, flat)
        apply_updates(flat, upd)
        for p in flat.values():
            p.grad = None
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL,
                                   err_msg=f"step {t}")
    want = _flat_jax(jax.tree.map(np.asarray, jp))
    for name, p in flat.items():
        d = np.abs(p.detach().numpy() - want[name])
        far = float((d > GAP_FAR).mean())
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())


def test_named_params_names_every_leaf_once():
    _, cfg, _, params = _setup("llama3.2-3b", True, seed=0)
    flat = LM.named_params(params)
    leaves = [params[k] for k in params if k != "layers"] + [
        t for lp in params["layers"] for t in lp.values()]
    assert len(flat) == len(leaves)
    assert {id(t) for t in flat.values()} == {id(t) for t in leaves}
    assert "layers.1.wq" in flat and "lm_head" in flat
