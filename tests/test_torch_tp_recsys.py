"""Tensor parallelism of the recsys family over the ``model`` axis, the
port against the JAX package under the same mesh:

  * ``param_layout`` equals ``repro/launch/steps.py::_param_shardings``'s
    specs (the reference's ``_safe`` of its logical specs, after
    ``logical_to_spec``'s once-per-axis rule) for dlrm-rm2, wide-deep,
    sasrec and bst at full width, on both production meshes' axis names
    and sizes ((16, 16) and (2, 16, 16)), each linear ``w`` reversed (the
    port holds it ``(d_out, d_in)``);
  * the JAX side runs in a child with 4 host devices and meshes (1, 4) and
    (2, 2) with ``AxisType.Auto`` axes under the default rules (``mlp``,
    ``heads`` and ``table_rows`` over ``model``): each kind's forward
    (sasrec: the user representation), loss and gradients, in f32 and in
    bf16 compute, at a small cut from ``init(key(0))``;
  * the port runs the same in four gloo ranks on the CPU, each holding
    its shards (``recsys_params_from_jax(ctx=)``): dlrm's and wide-deep's
    MLPs split by columns, then rows; bst's 4 heads over the model ranks;
    sasrec's one head of dim 10 whole at ``model`` 4 and split within
    the head at ``model`` 2 (its ``wq``/``wk``/``wv`` gathered, the
    attention whole, ``wo`` by rows); ``ff1`` by columns, ``ff2`` by rows.

Held in f32: the outputs within 1e-5 of the largest magnitude of JAX's,
the loss within 1e-5 relative, each rank's block of each gradient within
1e-5 relative, norm-wise, of its block of JAX's.  In bf16: the outputs
within ``BF16_OUT`` of the largest and the loss within ``BF16_LOSS``
relative of JAX's (both sides round after every product; the port sums a
row-split product's partials in f32 and rounds once, GSPMD in its own
order).  A bf16 gradient is a rounding of the f32 one, and at these cuts
bst's is mostly rounding (JAX's own bf16 gradient under the mesh lies up
to 0.9 of the norm from its f32 gradient): each rank's block of each
bf16 gradient must lie, norm-wise, within twice JAX's bf16 error (its
block's gap from JAX's f32 block) plus ``BF16_GRAD`` of JAX's f32 block
(seen: 0.012 past twice the error, for bst).  One
``recsys_train_step`` under the mesh (f32): its clip's norm the
one-process norm within 1e-6 relative, a norm that leaves a split dense
leaf out of the sum over the model group off it, the loss equal, and the
parameters after the step each rank's blocks of the one-process step's
within ``STEP_TOL`` where the one-process gradient entry exceeds
``TINY_GRAD`` in magnitude, and within one AdamW step (``LR_DENSE``)
elsewhere: AdamW's first step is about ``lr`` times the sign of each
entry, but an entry near its ``eps`` follows the entry's last bits, which
the model group's sums in another order move (seen: 1.1e-5 on one entry
of bst's ``mlp.0.w``).

At a large batch an f32 gradient also moves with the order of its sums:
dlrm-rm2's MLPs at full width on 16,384 rows, their later layers summed
in two halves in one process, give the same loss, the last layer's
gradient within 1e-5 and an earlier layer's up to 2^-6 apart (a ReLU
flip; the bound Phase 15a of ``chip_smoke.py`` holds on the card).
"""
import dataclasses as dc
import pickle
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed.sharding import ShardingCtx, make_rules
from repro_torch.models.recsys import models as R
from test_torch_lm_mesh import _block
from test_torch_lm_mesh_train import _norm_rel
from test_torch_recsys_mesh import _jax_flat
from test_torch_recsys_sharded import _run_child, _run_ranks

torch.set_num_threads(2)

MESHES = ((1, 4), (2, 2))
V = 32
KINDS = {
    "dlrm": ("dlrm-rm2", dict(n_dense=4, n_sparse=3, embed_dim=8,
                              default_vocab=V, bot_mlp=(16, 8),
                              top_mlp=(16, 8, 1))),
    "wide_deep": ("wide-deep", dict(n_sparse=3, embed_dim=8,
                                    default_vocab=V, bot_mlp=(16, 8))),
    "sasrec": ("sasrec", dict(embed_dim=10, seq_len=6, n_blocks=1,
                              n_heads=1, default_vocab=V)),
    "bst": ("bst", dict(n_sparse=2, embed_dim=16, seq_len=5, n_blocks=1,
                        n_heads=4, default_vocab=V, top_mlp=(16, 8, 1))),
}
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"),
          "bf16": dict(dtype="bfloat16", param_dtype="float32")}
B = 8
OF_MAX, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 1e-5
BF16_OUT = 2.0 ** -5         # bf16 outputs, of the largest magnitude
BF16_LOSS = 2.0 ** -7        # bf16 loss, relative
BF16_GRAD = 2.0 ** -5        # bf16 gradient blocks: the floor (docstring)
STEP_TOL = 1e-6
TINY_GRAD = 1e-4             # AdamW's eps is 1e-4 of an entry this small
LR_DENSE = 0.004             # rankgraph2_optimizer's AdamW rate


def _cfg(kind, dt="f32"):
    arch, cut = KINDS[kind]
    return dc.replace(get_arch(arch).config, **cut, **DTYPES[dt])


def _batch(kind, cfg, rng):
    """numpy batch: ids in [-40, 3V) (mod V), sequences with -1 pads."""
    def ids(*shape):
        return rng.integers(-40, 3 * V, shape).astype(np.int32)
    lab = (rng.random(B) > .5).astype(np.float32)
    if kind == "dlrm":
        return {"dense": rng.normal(size=(B, cfg.n_dense)).astype(
            np.float32), "sparse": ids(B, cfg.n_sparse), "labels": lab}
    if kind == "wide_deep":
        return {"sparse": ids(B, cfg.n_sparse), "labels": lab}
    seq = rng.integers(-1, 3 * V, (B, cfg.seq_len)).astype(np.int32)
    if kind == "sasrec":
        return {"seq": seq, "pos": ids(B), "neg": ids(B, 4)}
    return {"seq": seq, "target": ids(B), "other": ids(B, cfg.n_sparse),
            "labels": lab}


JAX_CHILD = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import ShardingCtx, make_rules
    from repro.models.recsys import models as RM
    inp = pickle.load(open(sys.argv[1], "rb"))
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    INITS = {"dlrm": RM.dlrm_init, "wide_deep": RM.wide_deep_init,
             "sasrec": RM.sasrec_init, "bst": RM.bst_init}

    def fwd(kind, cfg, p, b, ctx):
        if kind == "dlrm":
            return RM.dlrm_forward(p, cfg, b["dense"], b["sparse"], ctx)
        if kind == "wide_deep":
            return RM.wide_deep_forward(p, cfg, None, b["sparse"], ctx)
        if kind == "sasrec":
            return RM.sasrec_user_repr(p, cfg, b["seq"], ctx)
        return RM.bst_forward(p, cfg, b["seq"], b["target"], b["other"],
                              ctx)

    def loss(kind, cfg, p, b, ctx):
        if kind == "sasrec":
            return RM.sasrec_loss(p, cfg, b["seq"], b["pos"], b["neg"], ctx)
        return RM.bce_loss(fwd(kind, cfg, p, b, ctx), b["labels"])

    out = {}
    for kind, (arch, cut) in inp["kinds"].items():
        for dt, types in inp["dtypes"].items():
            cfg = dc.replace(get_arch(arch).config, **cut, **types)
            p = INITS[kind](jax.random.key(0), cfg)[0]
            if dt == "f32":
                out[f"{kind}/params"] = jax.tree.map(np.asarray, p)
            jb = {k: jnp.asarray(v) for k, v in inp["batches"][kind].items()}
            for shape in inp["meshes"]:
                mesh = jax.make_mesh(shape, ("data", "model"),
                                     axis_types=AUTO)
                ctx = ShardingCtx(make_rules(mesh), mesh)
                o = jax.jit(lambda p, b: fwd(kind, cfg, p, b, ctx))(p, jb)
                l, g = jax.jit(jax.value_and_grad(
                    lambda p, b: loss(kind, cfg, p, b, ctx)))(p, jb)
                out[f"{kind}/{dt}/{shape[0]}x{shape[1]}"] = dict(
                    out=np.asarray(o.astype(jnp.float32)), loss=float(l),
                    grads=jax.tree.map(np.asarray, g))
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_TP_RECSYS_OK")
""")

RANK = textwrap.dedent("""
    import sys, pickle, dataclasses as dc, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import recsys_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.models.recsys import models as R
    from repro_torch.optim import optimizers as O
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    inp = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    jx = pickle.load(open(f"{tmp}/jax.pkl", "rb"))
    norms = []
    clip = O.clip_by_global_norm

    def spy(grads, max_norm, shards=None):
        out = clip(grads, max_norm, shards)
        norms.append(float(out[1]))
        return out
    O.clip_by_global_norm = spy

    def det(t):
        return {k: v.detach().clone() for k, v in t.items()}

    res = {}
    for kind, (arch, cut) in inp["kinds"].items():
        tree = jx[f"{kind}/params"]
        b = {k: torch.from_numpy(v) for k, v in inp["batches"][kind].items()}
        for shape in inp["meshes"]:
            mesh = make_mesh(shape, ("data", "model"))
            ctx = ShardingCtx(make_rules(mesh), mesh)
            m = f"{shape[0]}x{shape[1]}"
            for dt, types in inp["dtypes"].items():
                cfg = dc.replace(get_arch(arch).config, **cut, **types)
                part = recsys_params_from_jax(tree, kind, device="cpu",
                                              ctx=ctx)
                out = ST.recsys_serve_step(part, cfg, b, ctx)
                loss, grads = ST.loss_and_grads(part, cfg, b, ctx)
                res[f"{kind}/{dt}/{m}"] = dict(
                    out=out.float(), loss=float(loss), grads=grads,
                    layout=R.param_layout(cfg, ctx))
            # one clipped f32 step each, from fresh trees
            cfg = dc.replace(get_arch(arch).config, **cut,
                             **inp["dtypes"]["f32"])
            steps = []
            for p, cx in ((recsys_params_from_jax(tree, kind,
                                                  device="cpu"), None),
                          (recsys_params_from_jax(tree, kind, device="cpu",
                                                  ctx=ctx), ctx)):
                opt = O.rankgraph2_optimizer()
                st = opt.init(R.flatten_params(p))
                g = ST.loss_and_grads(p, cfg, b, cx)[1]
                loss, _ = ST.recsys_train_step(p, st, b, cfg, opt, cx)
                steps.append((float(loss), det(R.flatten_params(p)),
                              norms[-1], g))
            # the clip's norm with one split dense leaf counted once a rank
            shards = R.shard_groups(cfg, ctx)
            lay = R.param_layout(cfg, ctx)
            dense = [k for k, s in lay.items() if any(s)
                     and k not in R.ROW_SHARDED[kind]]
            missing = dict(shards, **{dense[0]: (None,) * len(lay[dense[0]])})
            _, g_p = ST.loss_and_grads(recsys_params_from_jax(
                tree, kind, device="cpu", ctx=ctx), cfg, b, ctx)
            res[f"{kind}/{m}/step"] = dict(
                one=steps[0], mesh=steps[1], missing=dense[0],
                norm_missing=float(O.global_norm(g_p, missing)))
    torch.save(res, f"{tmp}/rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_recsys")
    rng = np.random.default_rng(5)
    inp = dict(kinds=KINDS, dtypes=DTYPES, meshes=MESHES,
               batches={k: _batch(k, _cfg(k), rng) for k in KINDS})
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    assert "JAX_TP_RECSYS_OK" in _run_child(
        JAX_CHILD, str(tmp / "inputs.pkl"), str(tmp / "jax.pkl"))
    _run_ranks(RANK, 4, tmp, timeout=240)
    with open(tmp / "jax.pkl", "rb") as f:
        jx = pickle.load(f)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return jx, ranks


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _flat_specs(tree, prefix=""):
    """The reference's spec (or sharding) tree flattened under the port's
    dotted names, a linear ``w``'s spec reversed to the port's layout."""
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        return {f"{prefix}.w": tuple(tree["w"])[::-1],
                f"{prefix}.b": tuple(tree["b"])}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) and not \
        isinstance(tree, jax.sharding.PartitionSpec) else None
    if items is None:
        return {prefix: tuple(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("names,shape", [(("data", "model"), (16, 16)),
                                         (("pod", "data", "model"),
                                          (2, 16, 16))])
def test_param_layout_matches_the_reference(monkeypatch, names, shape):
    """``param_layout`` against ``_param_shardings`` (``_safe`` of the
    reference's specs under ``_rules_for``) for every recsys arch and
    shape at full width, the mesh a stand-in with the production sizes
    (``_safe`` reads only its axis names and shape)."""
    from repro.models.recsys import models as JR
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JS, "_named", lambda mesh, spec: spec)
    jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    pmesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
    archs = [a for a in list_archs() if get_arch(a).family == "recsys"]
    assert len(archs) == 4
    inits = {"dlrm": JR.dlrm_init, "wide_deep": JR.wide_deep_init,
             "sasrec": JR.sasrec_init, "bst": JR.bst_init}
    seen = set()
    for a in archs:
        jcfg = jax_get_arch(a).config
        cfg = get_arch(a).config
        init = inits[jcfg.kind]
        shapes = jax.eval_shape(lambda: init(jax.random.key(0), jcfg)[0])
        specs = init(jax.random.key(0), JS.dataclasses_replace_small(jcfg))[1]
        for pshape, jshape in zip(get_arch(a).shapes,
                                  jax_get_arch(a).shapes):
            rules = JS._rules_for(a, jshape, jmesh)
            ref = _flat_specs(JS._param_shardings(specs, rules, jmesh,
                                                  shapes))
            got = R.param_layout(cfg, ShardingCtx(make_rules(names), pmesh))
            assert set(got) == set(ref), (a, set(got) ^ set(ref))
            for k, spec in got.items():
                want = tuple(ref[k]) + (None,) * (len(spec) - len(ref[k]))
                if k.endswith(".w"):      # reversed: pad at the front
                    want = (None,) * (len(spec) - len(ref[k])) \
                        + tuple(ref[k])
                assert spec == want, (a, pshape.name, k, spec, want)
                seen.update((k.split(".")[0], s) for s in spec
                            if s is not None)
    # every kind splits something over model: rows, columns and heads
    assert {("tables", "model"), ("bot", "model"), ("top", "model"),
            ("deep", "model"), ("blocks", "model"), ("mlp", "model"),
            ("items", "model")} <= seen, seen


def test_the_cuts_layouts():
    """dlrm and wide-deep alternate a column-split first layer with
    row-split later ones; bst's heads split over the model ranks; sasrec's
    one head stays whole at ``model`` 4 and splits within the head at 2."""
    def lay(kind, shape):
        mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
        return R.param_layout(_cfg(kind), ShardingCtx(
            make_rules(("data", "model")), mesh))
    d = lay("dlrm", (1, 4))
    assert d["bot.0.w"] == ("model", None) and d["bot.0.b"] == ("model",)
    assert d["bot.1.w"] == (None, "model") and d["bot.1.b"] == ("model",)
    assert d["top.2.w"] == (None, "model") and d["top.2.b"] == (None,)
    w = lay("wide_deep", (2, 2))
    assert w["deep.0.w"] == ("model", None) and w["deep.2.w"] == (
        None, "model")
    b = lay("bst", (1, 4))
    assert b["blocks.0.wq"] == (None, "model") and _cfg("bst").n_heads == 4
    assert b["blocks.0.wo"] == ("model", None)
    s4, s2 = lay("sasrec", (1, 4)), lay("sasrec", (2, 2))
    assert s4["blocks.0.wq"] == (None, None)           # 10 % 4
    assert s2["blocks.0.wq"] == (None, "model")        # 5 columns of 10
    assert s4["blocks.0.ff1.w"] == ("model", None)     # 40 % 4
    assert s4["blocks.0.ff2.w"] == (None, "model")


CASES = [(k, m, dt) for k in KINDS for m in MESHES for dt in DTYPES]


@pytest.mark.parametrize("kind,mshape,dt", CASES,
                         ids=[f"{k}-{m[0]}x{m[1]}-{d}" for k, m, d in CASES])
def test_tp_recsys_matches_jax(runs, kind, mshape, dt):
    jx, ranks = runs
    m = f"{mshape[0]}x{mshape[1]}"
    want = jx[f"{kind}/{dt}/{m}"]
    jgrads = {k: v.numpy() for k, v in _jax_flat(want["grads"]).items()}
    j32 = {k: v.numpy() for k, v in _jax_flat(
        jx[f"{kind}/f32/{m}"]["grads"]).items()}
    sizes = dict(zip(("data", "model"), mshape))
    out_tol, loss_tol = ((OF_MAX, LOSS_REL) if dt == "f32"
                         else (BF16_OUT, BF16_LOSS))
    split = 0
    for r, res in enumerate(ranks):
        got = res[f"{kind}/{dt}/{m}"]
        coords = {"data": r // mshape[1], "model": r % mshape[1]}
        assert _of_max(got["out"], want["out"]) <= out_tol, (kind, m, dt, r)
        assert abs(got["loss"] - want["loss"]) <= loss_tol * abs(
            want["loss"]), (kind, m, dt, r, got["loss"], want["loss"])
        assert set(got["grads"]) == set(jgrads)
        for k, spec in got["layout"].items():
            w = _block(jgrads[k], spec, coords, sizes)
            g = got["grads"][k].float().numpy()
            assert g.shape == w.shape, (kind, k, g.shape, w.shape)
            if dt == "f32":
                rel = _norm_rel(g, w)
                assert rel <= GRAD_REL, (kind, m, r, k, rel)
            else:
                # within twice JAX's own bf16 error, plus a floor
                w32 = _block(j32[k], spec, coords, sizes)
                rel, own = _norm_rel(g, w32), _norm_rel(w, w32)
                assert rel <= 2 * own + BF16_GRAD, (kind, m, r, k, rel, own)
            split += any(spec) and k not in R.ROW_SHARDED[kind]
    assert split > 0, (kind, m)     # dense leaves split over the model


@pytest.mark.parametrize("kind,mshape", [(k, m) for k in KINDS
                                         for m in MESHES],
                         ids=[f"{k}-{m[0]}x{m[1]}" for k in KINDS
                              for m in MESHES])
def test_tp_train_step_and_its_clip(runs, kind, mshape):
    _, ranks = runs
    m = f"{mshape[0]}x{mshape[1]}"
    sizes = dict(zip(("data", "model"), mshape))
    for r, res in enumerate(ranks):
        s = res[f"{kind}/{m}/step"]
        (l1, whole, n1, g1), (l2, part, n2, _) = s["one"], s["mesh"]
        lay = res[f"{kind}/f32/{m}"]["layout"]
        coords = {"data": r // mshape[1], "model": r % mshape[1]}
        assert l2 == pytest.approx(l1, rel=1e-6)
        assert n2 == pytest.approx(n1, rel=1e-6)
        assert s["norm_missing"] != pytest.approx(n1, rel=1e-6), s["missing"]
        for k, v in whole.items():
            w = _block(v.numpy(), lay[k], coords, sizes)
            tiny = np.abs(_block(g1[k].numpy(), lay[k], coords,
                                 sizes)) <= TINY_GRAD
            gap = np.abs(part[k].numpy() - w)
            assert gap[~tiny].max(initial=0) <= STEP_TOL, (kind, k)
            assert gap[tiny].max(initial=0) <= LR_DENSE, (kind, k)


def test_reordered_sums_move_gradients_past_relus(monkeypatch, capsys):
    """What bounds an f32 gradient check at a large batch: dlrm-rm2's MLPs
    at full width, 16,384 rows of random labels, in one process, with the
    later layers' products summed in two halves (the order a row split
    over two ranks gives) against the plain products.  The loss moves by
    rounding alone, the last layer's gradient too (no ReLU lies behind
    it); an earlier layer's moves by a ReLU whose input lies within
    rounding of zero and flips, which the batch's cancelling terms make
    large (Phase 15a's ``P15_GRAD_REL``, 2^-6, bounds it)."""
    import torch.nn.functional as F
    from repro_torch.launch import steps as ST
    from repro_torch.nn import core as nn
    cfg = dc.replace(get_arch("dlrm-rm2").config, default_vocab=1000,
                     dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = R.init_params(cfg, generator=g, device="cpu")
    n = 16384
    batch = {"dense": torch.randn((n, cfg.n_dense), generator=g),
             "sparse": torch.randint(0, 1000, (n, cfg.n_sparse), generator=g),
             "labels": (torch.rand(n, generator=g) > 0.5).float()}
    l1, g1 = ST.loss_and_grads(params, cfg, batch)

    def halves(layers, x, *, act=F.relu, final_act=None):
        for i, p in enumerate(layers):
            if i == 0:
                x = nn.linear_apply(p, x)
            else:
                h, w = p["w"].shape[1] // 2, p["w"]
                x = (x[:, :h] @ w[:, :h].t() + x[:, h:] @ w[:, h:].t()
                     + p["b"])
            if i < len(layers) - 1:
                x = act(x)
            elif final_act is not None:
                x = final_act(x)
        return x
    monkeypatch.setattr(nn, "mlp_apply", halves)
    l2, g2 = ST.loss_and_grads(params, cfg, batch)
    gaps = {k: float((g1[k] - g2[k]).norm() / g1[k].norm())
            for k in g1 if k != "tables"}
    with capsys.disabled():
        print(f"\nreordered sums, dlrm-rm2 f32 at 16,384 rows: loss "
              f"{abs(float(l1 - l2)) / float(l1):.3g} relative, dense "
              f"gradients norm-wise {gaps}")
    assert abs(float(l1 - l2)) <= 1e-6 * float(l1)
    assert gaps["top.3.w"] <= 1e-5 and gaps["top.3.b"] <= 1e-5
    assert max(gaps.values()) <= 2.0 ** -6
