"""The port's MoE LM layers against the JAX package's, on narrow cuts of
grok-1-314b (4 experts top-2, GeGLU) and kimi-k2-1t-a32b (16 experts
top-8, SwiGLU), 2 layers, head dim 32, with the JAX weights carried over
by ``lm_params_from_jax`` and numpy inputs:

  * ``_pos_in_group`` and the router's expert ids bitwise, also on heavy
    duplicates and on forced ties (duplicated router columns: equal
    probabilities, the lower index first as ``jax.lax.top_k``), the gates
    and aux within 1e-6 (f32 softmax sums in another order; seen: 3e-7);
  * ``_moe_scatter`` with and without dropped slots and ``_moe_dense``
    within 1e-5 of the largest output (f32 products and sums in another
    order; seen: within 5e-7);
  * ``lm_loss`` (aux included) and every gradient with remat on and off,
    at ``tests/test_torch_lm_train.py``'s tolerances (the loss within 1e-5
    relative, each gradient within 1e-4 of its largest magnitude; seen:
    within 2e-6);
  * ``forward``, ``prefill`` and ``decode_step`` logits and caches in f32
    within ``tests/test_torch_lm.py``'s 1e-4, and the prefill / decode
    logits in bf16 within its 5e-2 (seen: 2.6e-6 and 7.9e-3);
  * ``lm_params_from_jax`` on MoE trees, stacked and as a list of layers.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.distributed.sharding import NULL_CTX
from repro.models.lm import model as JLM
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import model as LM

torch.set_num_threads(2)

CUTS = {
    "grok-1-314b": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
                        moe_d_ff=96, d_ff=96, n_experts=4),
    "kimi-k2-1t-a32b": dict(d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, moe_d_ff=64, d_ff=64,
                            n_experts=16),
}
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
LOSS_REL, GRAD_OF_MAX, MOE_OF_MAX, GATE_TOL = 1e-5, 1e-4, 1e-5, 1e-6
B, S = 2, 16


def _cut(arch_id: str, **over):
    j = dc.replace(jax_get_arch(arch_id).config, **{
        "n_layers": 2, "vocab_size": 128, "dtype": "float32",
        "param_dtype": "float32", **CUTS[arch_id], **over})
    return j, LMConfig(**dc.asdict(j))


def _jax_params(jcfg, seed: int):
    return jax.tree.map(np.asarray, JLM.init_params(jax.random.key(seed),
                                                    jcfg)[0])


def _layer0(jp) -> tuple:
    """Layer 0's leaves: numpy (JAX side) and torch (port side)."""
    lp = {k: v[0] for k, v in jp["layers"].items()}
    return lp, {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}


def _tokens(cfg, seed: int, n: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _of_max(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("case", ["random", "heavy", "one", "sorted",
                                  "reversed"])
def test_pos_in_group_bitwise(case):
    rng = np.random.default_rng(len(case))
    n = 777
    flat = {"random": rng.integers(0, 16, n),
            "heavy": rng.choice([0, 3, 3, 3, 3, 9], n),
            "one": np.full(n, 5),
            "sorted": np.sort(rng.integers(0, 7, n)),
            "reversed": np.sort(rng.integers(0, 7, n))[::-1].copy()}[case]
    want = np.asarray(JLM._pos_in_group(jnp.asarray(flat, jnp.int32)))
    got = LM._pos_in_group(torch.from_numpy(flat).long())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_router_matches_jax(arch_id, ties):
    jcfg, cfg = _cut(arch_id)
    lp, tp = _layer0(_jax_params(jcfg, seed=1))
    if ties:       # duplicated columns: equal logits, equal probabilities
        r = lp["router"].copy()
        r[:, 1::2] = r[:, 0::2]
        lp["router"], tp["router"] = r, torch.from_numpy(r.copy())
    xt = np.random.default_rng(2).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    jg, je, jaux = JLM._router(lp, jcfg, jnp.asarray(xt))
    gate, eid, aux = LM._router(tp, cfg, torch.from_numpy(xt))
    np.testing.assert_array_equal(eid.numpy(), np.asarray(je))
    if ties:
        assert (np.asarray(je) % 2 == 0).any() and (
            np.diff(np.asarray(je), axis=-1) != 0).all()
    np.testing.assert_allclose(gate.numpy(), np.asarray(jg), atol=GATE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=GATE_TOL)


def test_router_refuses_k_above_e():
    _, cfg = _cut("kimi-k2-1t-a32b", n_experts=4)
    p = {"router": torch.zeros(cfg.d_model, 4)}
    with pytest.raises(ValueError, match="got k=8 with 4 experts"):
        LM._router(p, cfg, torch.zeros(3, cfg.d_model))


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, None])
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_moe_scatter_and_dense_match_jax(arch_id, capacity_factor):
    """capacity factor 0.5 drops slots, 1.25 is the configs', None (E / k)
    drops nothing."""
    E = CUTS[arch_id]["n_experts"]
    k = jax_get_arch(arch_id).config.n_experts_per_tok
    jcfg, cfg = _cut(arch_id, capacity_factor=capacity_factor or E / k)
    lp, tp = _layer0(_jax_params(jcfg, seed=3))
    x = np.random.default_rng(4).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32)
    flat = np.asarray(JLM._router(lp, jcfg, jnp.asarray(
        x.reshape(-1, cfg.d_model)))[1]).reshape(-1)
    cap = LM.moe_capacity(cfg, B * 24)
    assert cap == max(int(k * B * 24 / E * cfg.capacity_factor) + 1, 8)
    dropped = int((np.asarray(JLM._pos_in_group(jnp.asarray(flat)))
                   >= cap).sum())
    assert (dropped > 0) == (capacity_factor == 0.5)
    want, jaux = JLM._moe_scatter(lp, jcfg, jnp.asarray(x), NULL_CTX)
    got, aux = LM._moe_scatter(tp, cfg, torch.from_numpy(x))
    _of_max(got, want, MOE_OF_MAX)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=GATE_TOL)
    got_b, _ = LM._moe_block(tp, cfg, torch.from_numpy(x))
    assert torch.equal(got_b, got)
    want_d, _ = JLM._moe_dense(lp, jcfg, jnp.asarray(x), NULL_CTX)
    got_d, _ = LM._moe_dense(tp, cfg, torch.from_numpy(x))
    _of_max(got_d, want_d, MOE_OF_MAX)
    if capacity_factor is None:               # nothing dropped: the same
        _of_max(got, want_d, MOE_OF_MAX)


def _flat_jax(tree) -> dict:
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    for k, v in tree["layers"].items():
        for i in range(v.shape[0]):
            out[f"layers.{i}.{k}"] = np.asarray(v[i])
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_lm_loss_and_gradients_match_jax(arch_id, remat):
    jcfg, cfg = _cut(arch_id, remat=remat)
    jp = _jax_params(jcfg, seed=5)
    params = lm_params_from_jax(jp, device="cpu")
    for p in LM.named_params(params).values():
        p.requires_grad_(True)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    jloss, jg = jax.value_and_grad(lambda p: JLM.lm_loss(
        p, jcfg, jnp.asarray(toks), block_q=16))(jp)
    loss = LM.lm_loss(params, cfg, torch.from_numpy(toks).long(),
                      block_q=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL)
    want = _flat_jax(jg)
    got = LM.named_params(params)
    assert sorted(got) == sorted(want) and "layers.1.router" in got
    for name, p in got.items():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_OF_MAX * float(np.abs(w).max()), (name, err)


def _pad(caches, n):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
            for k, v in caches.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_forward_prefill_decode_match_jax(arch_id, dtype, tol):
    jcfg, cfg = _cut(arch_id, dtype=dtype)
    jp = _jax_params(jcfg, seed=7)
    params = lm_params_from_jax(jp, device="cpu")
    toks = _tokens(cfg, seed=8)
    tt = torch.from_numpy(toks).long()
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    if dtype == "float32":
        want, _ = JLM.forward(jp, jcfg, jnp.asarray(toks))
        np.testing.assert_allclose(LM.forward(params, cfg, tt).numpy(),
                                   f32(want), **tol)
    j_last, j_caches = JLM.prefill(jp, jcfg, jnp.asarray(toks), block_q=8)
    last, caches = LM.prefill(params, cfg, tt, block_q=8)
    np.testing.assert_allclose(last.float().numpy(), f32(j_last), **tol)
    if dtype == "float32":
        for n in ("k", "v"):
            np.testing.assert_allclose(caches[n].numpy(), f32(j_caches[n]),
                                       **tol)
    nxt = _tokens(cfg, seed=9, n=1)
    j_pad = jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        j_caches)
    j_dec, _ = JLM.decode_step(jp, jcfg, jnp.asarray(nxt), j_pad, S)
    dec, _ = LM.decode_step(params, cfg, torch.from_numpy(nxt).long(),
                            _pad(caches, 4), S)
    np.testing.assert_allclose(dec.float().numpy(), f32(j_dec), **tol)


@pytest.mark.parametrize("scan", [True, False])
def test_lm_params_from_jax_takes_moe_trees(scan):
    jcfg, cfg = _cut("grok-1-314b", scan_layers=scan)
    jp = _jax_params(jcfg, seed=10)
    params = lm_params_from_jax(jp, device="cpu")
    assert len(params["layers"]) == 2
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    shapes = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
              "w_down": (E, ff, d)}
    for i, lp in enumerate(params["layers"]):
        src = jp["layers"][i] if not scan else {
            k: v[i] for k, v in jp["layers"].items()}
        assert sorted(lp) == sorted(src)
        for k, shape in shapes.items():
            assert tuple(lp[k].shape) == shape
        for k in lp:
            np.testing.assert_array_equal(lp[k].numpy(), np.asarray(src[k]))
    # the port's own init draws the same leaves, shapes and types
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in LM.named_params(own).items()} == \
        {k: tuple(v.shape) for k, v in LM.named_params(params).items()}
