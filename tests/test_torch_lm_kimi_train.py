"""kimi-k2-1t-a32b's training at its own head dim, 112, on a narrow cut
(2 layers, d 128, 8 query heads over 1 KV head: kimi's 8:1 grouping, 16
experts top-8 at ff 64, vocab 128, f32), the port against the JAX
package on the same weights (``lm_params_from_jax``) and numpy tokens:

  * ``lm_params_from_jax`` lays out kimi's tree at head dim 112 (the
    projections (128, 8 x 112) and (128, 112), the experts' leaves);
  * ``lm_loss`` (aux included) and every gradient with remat on and off
    against ``jax.value_and_grad`` of the reference's ``lm_loss``, at
    ``tests/test_torch_lm_moe.py``'s tolerances (the loss within 1e-5
    relative, each gradient within 1e-4 of its largest magnitude; f32
    on both sides, sums in another order);
  * two ``lm_train_step``s (Adafactor, clipping at 1.0) against the
    train_4k cell's step written out in JAX with ``scan_layers=False``
    (Adafactor over stacked layers factors across them): the losses and
    gradient norms within 1e-5 relative, the parameters by the
    distribution of their gaps (``tests/test_torch_launch_lm.py``'s rule:
    each parameter's median gap within 1e-6, at most 1% of its entries
    more than 1e-4 apart);
  * ``lm_train_step(ctx=)`` under a (1, 4) expert mesh (4 experts a
    rank), four gloo ranks on the CPU, against JAX's step under the same
    mesh of ``AxisType.Auto`` axes, two steps, held by
    ``tests/test_torch_lm_mesh_train.py``'s rules (its child and ranks).

On the CPU the attention is ``chunked_attention_ref`` under autograd; on
the card it is ``FlashAttention`` with the backward kernels at D 112,
which ``chip_smoke.py`` Phases 1 and 13 hold against this path.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models.lm import model as JLM
from repro.optim import optimizers as JO
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.lm import model as LM
from repro_torch.optim import optimizers as O
from test_torch_lm_mesh_train import (JAX_CHILD, RANK, _assemble, _flat,
                                      _layout, _nest, _norm_rel, _run, _wait)

torch.set_num_threads(2)

ARCH = "kimi-k2-1t-a32b"
CUT = dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=1, head_dim=112,
           d_ff=64, moe_d_ff=64, vocab_size=128, n_experts=16)
B, S, BLOCK_Q = 4, 32, 16
LOSS_REL, GRAD_OF_MAX, STEP_REL = 1e-5, 1e-4, 1e-5
GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE = 1e-6, 1e-4, 0.01
MESH, STEPS = (1, 4), 2


def _cut(**over):
    j = dc.replace(jax_get_arch(ARCH).config, dtype="float32",
                   param_dtype="float32", **{**CUT, **over})
    return j, LMConfig(**dc.asdict(j))


def _tokens(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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


def test_cut_keeps_kimi_s_head_shape_and_params_convert():
    jcfg, cfg = _cut()
    base = jax_get_arch(ARCH).config
    assert cfg.resolved_head_dim == 112 == base.d_model // base.n_heads
    assert cfg.n_heads // cfg.n_kv_heads == base.n_heads // base.n_kv_heads
    assert cfg.n_experts_per_tok == base.n_experts_per_tok == 8
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(3),
                                                  jcfg)[0])
    params = LM.named_params(lm_params_from_jax(jp, device="cpu"))
    want = _flat_jax(jp)
    assert sorted(params) == sorted(want)
    d, H, hd, E, ff = 128, 8, 112, 16, 64
    shapes = {"wq": (d, H * hd), "wk": (d, hd), "wv": (d, hd),
              "wo": (H * hd, d), "router": (d, E), "w_gate": (E, d, ff),
              "w_up": (E, d, ff), "w_down": (E, ff, d)}
    for i in range(2):
        for k, shape in shapes.items():
            assert tuple(params[f"layers.{i}.{k}"].shape) == shape, k
    for name, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_jax(remat):
    jcfg, cfg = _cut(remat=remat)
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(5),
                                                  jcfg)[0])
    params = lm_params_from_jax(jp, device="cpu")
    for p in LM.named_params(params).values():
        p.requires_grad_(True)
    toks = _tokens(cfg, seed=6)
    jloss, jg = jax.value_and_grad(lambda p: JLM.lm_loss(
        p, jcfg, jnp.asarray(toks), block_q=BLOCK_Q))(jp)
    loss = LM.lm_loss(params, cfg, torch.from_numpy(toks).long(),
                      block_q=BLOCK_Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL)
    want = _flat_jax(jg)
    got = LM.named_params(params)
    assert sorted(got) == sorted(want) and "layers.1.router" in got
    for name, p in got.items():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_OF_MAX * float(np.abs(w).max()), (name, err)


def test_lm_train_step_matches_jax():
    jcfg, cfg = _cut(scan_layers=False)
    assert cfg.optimizer == "adafactor"
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
    for t in range(STEPS):
        toks = _tokens(cfg, seed=20 + t)
        jloss, jnorm, jp, jst = jstep(jp, jst, jnp.asarray(toks))
        loss, gnorm, st = lm_train_step(params, cfg, opt, st,
                                        torch.from_numpy(toks).long())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_REL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=STEP_REL,
                                   err_msg=f"step {t}")
    want = _flat_jax(jax.tree.map(np.asarray, jp))
    for name, p in LM.named_params(params).items():
        d = np.abs(p.detach().numpy() - want[name])
        far = float((d > GAP_FAR).mean())
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())


def test_lm_train_step_under_an_expert_mesh_matches_jax(tmp_path):
    """Mesh (1, 4): one data rank, the 16 experts split 4 a rank; the
    ranks' losses and norms, the reassembled gradients and parameters
    against JAX's step under the same mesh."""
    cut = {**CUT, "scan_layers": False}
    jcfg, cfg = _cut(scan_layers=False)
    toks = _tokens(cfg, seed=1)
    np.savez(tmp_path / "tokens.npz", **{ARCH: toks})
    torch.save({ARCH: dict(cfg=cfg, init=jax.tree.map(
        np.asarray, JLM.init_params(jax.random.key(0), jcfg)[0]),
        tokens=torch.from_numpy(toks).long(), steps=STEPS)},
        tmp_path / "train_inputs.pt")
    tag = f"{MESH[0]}x{MESH[1]}"
    outs = _wait([_run([JAX_CHILD % repr(({ARCH: cut}, (MESH,), B, S,
                                          STEPS)),
                        str(tmp_path / "jax.npz"),
                        str(tmp_path / "tokens.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp_path), tag])
                    for r in range(4)])
    assert "JAX_TRAIN_OK" in outs[0]
    j = dict(np.load(tmp_path / "jax.npz"))
    ranks = [torch.load(tmp_path / f"train-{tag}-rank{r}.pt",
                        weights_only=False)[ARCH] for r in range(4)]
    lay = _layout(ARCH, cfg, MESH)
    assert lay["layers.0.w_gate"][0] == "model"      # experts split
    jtag = f"{ARCH}/{tag}"
    for t in range(STEPS):
        want_loss = float(np.mean(j[f"{jtag}/loss{t}"]))
        want_norm = float(j[f"{jtag}/gnorm{t}"])
        for r in ranks:
            loss, gnorm, _ = r["steps"][t]
            assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), \
                (t, loss, want_loss)
            assert abs(gnorm - want_norm) <= LOSS_REL * want_norm, \
                (t, gnorm, want_norm)
        want = _flat(_nest(j, f"{jtag}/grads{t}"))
        assert set(want) == set(lay)
        for name, spec in lay.items():
            got = _assemble([r["steps"][t][2][name] for r in ranks], spec,
                            MESH)
            assert _norm_rel(got, want[name]) <= LOSS_REL, (t, name)
    want = _flat(_nest(j, f"{jtag}/params"))
    for name, spec in lay.items():
        got = _assemble([r["params"][name] for r in ranks], spec, MESH)
        d = np.abs(got - want[name]).ravel()
        far = float(np.mean(d > GAP_FAR))
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())
    assert all(r["refused"] == [True, True] for r in ranks)
