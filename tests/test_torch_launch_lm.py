"""The port's LM launcher and train step against the JAX package's:

  * ``run_lm`` from the JAX package's ``init_params(key(0))`` (carried
    over by ``lm_params_from_jax``) against JAX's ``run_lm``, at
    ``_reduced`` olmo-1b and grok-1-314b (2 layers, d 128, head dim 32,
    f32, B 4 x S 64, AdamW at 1e-3, ``block_q`` 32): every step's loss
    within 1e-4 relative (JAX's ``run_lm`` returns its last loss, so it
    runs once for each step count; seen: within 1e-7);
  * the reduced kimi-k2 (top-8 of the 4 experts the cut leaves) raises
    in both packages, naming k;
  * ``main --arch <id> --device cpu --steps 2`` exits 0 for every LM
    arch but kimi-k2, and raises for that;
  * ``lm_train_step`` against the train_4k cell's step written out in JAX
    (``value_and_grad(lm_loss)``, ``clip_by_global_norm(1.0)``,
    ``make_optimizer(cfg.optimizer)``, ``apply_updates``), two steps at
    reduced llama3.2-3b (AdamW) and grok-1-314b (Adafactor; against JAX's
    params as a list of layers, since its Adafactor over stacked layers
    factors and clips across them): the losses
    and gradient norms within 1e-5 relative (seen: 2e-7); the parameters, as
    ``tests/test_torch_lm_train.py`` holds them after AdamW steps (the
    first update is about g / |g| entry by entry, so a near-zero gradient
    takes its sign from the order of its sum): each parameter's median gap
    within 1e-6 and at most 1% of its entries more than 1e-4 apart.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import train as JT
from repro.models.lm import model as JLM
from repro.optim import optimizers as JO
from repro_torch.configs.base import LMConfig, get_arch, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import train as T
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.lm import model as LM
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)

STEPS, LOSS_REL = 3, 1e-4
STEP_REL, GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE = 1e-5, 1e-6, 1e-4, 0.01
LM_ARCHS = [a for a in list_archs() if get_arch(a).family == "lm"]


def _reduced(arch_id: str):
    j = JT._reduced(jax_get_arch(arch_id).config)
    return j, LMConfig(**dc.asdict(j))


@pytest.mark.parametrize("arch_id", ["olmo-1b", "grok-1-314b"])
def test_run_lm_matches_jax(arch_id):
    jcfg, cfg = _reduced(arch_id)
    assert T._reduced(get_arch(arch_id).config) == cfg
    want = [JT.run_lm(jcfg, n) for n in range(1, STEPS + 1)]
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0),
                                                  jcfg)[0])
    got = T.run_lm(cfg, STEPS, device="cpu",
                   params=lm_params_from_jax(jp, device="cpu"))
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)


def test_reduced_kimi_raises_in_both():
    jcfg, cfg = _reduced("kimi-k2-1t-a32b")
    assert cfg.n_experts == 4 and cfg.n_experts_per_tok == 8
    with pytest.raises(ValueError, match="k=8"):
        JT.run_lm(jcfg, 1)
    with pytest.raises(ValueError, match="k=8"):
        T.run_lm(cfg, 1, device="cpu")


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_main_runs_every_lm_arch(arch_id, capsys):
    argv = ["--arch", arch_id, "--device", "cpu", "--steps", "2"]
    if arch_id == "kimi-k2-1t-a32b":
        with pytest.raises(ValueError, match="k=8"):
            T.main(argv)
        return
    assert T.main(argv) == 0
    out = capsys.readouterr().out
    assert "[0] lm loss" in out and "[1] lm loss" in out and "done in" in out


def _flat_jax(tree) -> dict:
    """The JAX tree's leaves under ``named_params``'s names, from stacked
    layers or a list of them."""
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = [{k: v[i] for k, v in layers.items()}
                  for i in range(len(next(iter(layers.values()))))]
    for i, lp in enumerate(layers):
        out.update({f"layers.{i}.{k}": np.asarray(v) for k, v in lp.items()})
    return out


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "grok-1-314b"])
def test_lm_train_step_matches_jax(arch_id):
    jcfg, cfg = _reduced(arch_id)
    if cfg.optimizer == "adafactor":
        # the port keeps one leaf a layer; JAX's Adafactor over stacked
        # (L, ...) leaves factors the norms across layers and clips each
        # update over the whole stack, so its numbers follow scan_layers
        # (ROADMAP, "Reference properties"): compare with JAX's list of
        # layers
        jcfg, cfg = (dc.replace(c, scan_layers=False) for c in (jcfg, cfg))
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(1),
                                                  jcfg)[0])
    params = lm_params_from_jax(jp, device="cpu")
    jopt, opt = JO.make_optimizer(jcfg.optimizer), \
        O.make_optimizer(cfg.optimizer)

    @jax.jit
    def jstep(p, st, toks):      # repro/launch/steps.py::_lm_cell's step
        loss, grads = jax.value_and_grad(
            lambda p_: JLM.lm_loss(p_, jcfg, toks))(p)
        grads, gnorm = JO.clip_by_global_norm(grads, 1.0)
        upd, st = jopt.update(grads, st, p)
        return loss, gnorm, JO.apply_updates(p, upd), st

    jst, st = jopt.init(jp), opt.init(LM.named_params(params))
    rng = np.random.default_rng(2)
    for t in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        jloss, jnorm, jp, jst = jstep(jp, jst, jnp.asarray(toks))
        loss, gnorm, st = lm_train_step(params, cfg, opt, st,
                                        torch.from_numpy(toks).long())
        assert float(jnorm) > 1.0               # the clipping binds
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_REL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=STEP_REL,
                                   err_msg=f"step {t}")
    assert st.count == 2
    want = _flat_jax(jax.tree.map(np.asarray, jp))
    for name, p in LM.named_params(params).items():
        d = np.abs(p.detach().numpy() - want[name])
        far = float((d > GAP_FAR).mean())
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())
