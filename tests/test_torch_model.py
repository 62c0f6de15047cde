"""Port model against the JAX package: JAX ``init_params`` ->
``params_from_jax`` -> the port's ``embed_nodes`` / ``primary_embedding``
on the same numpy inputs.

Tolerances: 1e-5 in float32 (the same arithmetic, summed in another
order); 5e-2 in bfloat16, the bound ``tests/test_kernels.py`` uses for
bf16 (the frameworks round bf16 intermediates at different places)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RankGraph2Config as JaxConfig
from repro.core import model as JM
from repro_torch.configs.base import RankGraph2Config
from repro_torch.convert import params_from_jax
from repro_torch.core import model as M
from repro_torch.nn.core import l2_normalize, linear

torch.set_num_threads(2)

TINY = dict(d_user_feat=40, d_item_feat=24, d_embed=16, n_heads=3,
            d_hidden=32, k_imp=10, k_train=5)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _params(seed=0):
    jp, _ = JM.init_params(jax.random.key(seed), JaxConfig(**TINY))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _side(rng, B, K, cfg):
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    umask = (rng.random((B, K)) < 0.7).astype(np.float32)
    imask = (rng.random((B, K)) < 0.7).astype(np.float32)
    umask[0] = 0.0                              # a node with no neighbours
    return dict(feat=f(B, cfg.d_user_feat),
                unbr_feat=f(B, K, cfg.d_user_feat) * umask[..., None],
                unbr_mask=umask,
                inbr_feat=f(B, K, cfg.d_item_feat) * imask[..., None],
                inbr_mask=imask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("node_type", [JM.USER, JM.ITEM])
def test_embed_nodes_and_primary_match_jax(dtype, node_type):
    jcfg = JaxConfig(**TINY, dtype=dtype)
    pcfg = RankGraph2Config(**TINY, dtype=dtype)
    jp, tp = _params()
    side = _side(np.random.default_rng(node_type), 12, 5, jcfg)
    if node_type == JM.ITEM:                    # item-typed self features
        side["feat"] = side["feat"][:, :jcfg.d_item_feat].copy()
    heads_j, prim_j = JM.embed_side(
        jp, jcfg, {k: jnp.asarray(v) for k, v in side.items()}, node_type)
    heads_p, prim_p = M.embed_side(
        tp, pcfg, {k: torch.from_numpy(v) for k, v in side.items()},
        node_type)
    assert heads_p.dtype == M.DTYPES[dtype]
    tol = TOL[dtype]
    for a, b in ((heads_p, heads_j), (prim_p, prim_j)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)


def test_converter_transposes_linear_weights():
    jp, tp = _params()
    w = np.asarray(jp["f_user"]["l1"]["w"])             # (d_in, d_out)
    b = np.asarray(jp["f_user"]["l1"]["b"])
    lin = tp["f_user"].l1
    assert tuple(lin.weight.shape) == (w.shape[1], w.shape[0])
    np.testing.assert_array_equal(lin.weight.numpy(), w.T)
    x = np.random.default_rng(0).normal(size=(3, w.shape[0]))
    x = x.astype(np.float32)
    np.testing.assert_allclose(linear(lin, torch.from_numpy(x)).numpy(),
                               x @ w + b, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tp["agg_item"].w.numpy(),
                                  np.asarray(jp["agg_item"]["w"]))


def test_init_params_shapes_and_scale_match_jax():
    cfg = RankGraph2Config(**TINY)
    jp, tp = _params()
    a = M.init_params(cfg, generator=torch.Generator().manual_seed(3),
                      device="cpu")
    b = M.init_params(cfg, generator=torch.Generator().manual_seed(3),
                      device="cpu")
    for (name, p), (_, q) in zip(a.state_dict().items(),
                                 tp.state_dict().items()):
        assert p.shape == q.shape and p.dtype == q.dtype, name
        assert torch.equal(p, b.state_dict()[name]), name
        if p.numel() > 500:                     # same variance scaling
            assert abs(float(p.std()) / float(q.std()) - 1) < 0.15, name


def test_l2_normalize_keeps_the_eps_form():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    out = l2_normalize(x)
    np.testing.assert_allclose(out.numpy(), [[3 / (5 + 1e-8),
                                              4 / (5 + 1e-8)], [0, 0]])
