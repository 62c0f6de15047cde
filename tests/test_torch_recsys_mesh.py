"""wide-deep, sasrec and bst with row-sharded tables (``models.recsys.
models`` under a ``ShardingCtx``), against the JAX package under the same
mesh and against the port's own one-process run, on the same parameters
(JAX's init, carried over with ``recsys_params_from_jax``) and the same
numpy batches:

  * the JAX side runs in a child with 4 host devices at meshes (1, 4) and
    (2, 2) ``("data", "model")`` with ``AxisType.Auto`` axes (the rules of
    ``make_rules``: ``table_rows -> model``), on a batch of 8 and one of 9,
    which (2, 2) pads to 10: the forward (sasrec: the user
    representation), the loss (``bce_loss``; sasrec ``sasrec_loss``) and
    its gradients, under ``jax.jit``, and the same without a mesh;
  * the port runs four gloo ranks on the CPU, each holding its rows of
    ``tables`` and ``wide`` (wide-deep), ``items`` (sasrec), ``items`` and
    ``other`` (bst).  Held: the forwards and losses bitwise the port's
    one-process ones, each rank's shard gradient equal to its rows of the
    one-process gradient and every other gradient equal (the rows of a
    shard get the same terms in the same order), all of them within
    ``F32`` of JAX's under the mesh, the gradients within ``GRAD_REL`` of
    each leaf's largest entry (the same f32 arithmetic in another order:
    bst's items read 2.0e-6 apart at 0.07); one ``recsys_train_step`` within 1e-6 of the one-process
    step, its clip's norm the one-process norm within 1e-6 relative, and a
    norm that leaves one sharded leaf out of the sum over the model group
    off that norm; ``run_recsys(ctx=)`` the one-process losses;
    ``init_params(ctx=)`` and ``recsys_params_from_jax(ctx=)`` a rank's
    rows of the whole trees; ``sasrec_scores(ctx=)`` bitwise.

Ids run from -40 to three times the vocabulary, so every batch holds ids
at and above a rank's row count (8 at (1, 4)) and above the vocabulary:
a lookup that read the row count from a shard's shape would map them to
the wrong rows.
"""
import dataclasses as dc
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.models.recsys import models as R
from test_torch_recsys_sharded import _run_child, _run_ranks

torch.set_num_threads(2)

MESHES = ((1, 4), (2, 2))
BATCHES = (8, 9)
V = 32
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-5              # gradients against JAX: of the leaf's largest
STEP_TOL = 1e-6
KINDS = {
    "wide_deep": ("wide-deep", dict(n_sparse=3, embed_dim=8,
                                    default_vocab=V, bot_mlp=(16, 8))),
    "sasrec": ("sasrec", dict(embed_dim=8, seq_len=6, n_blocks=1,
                              n_heads=1, default_vocab=V)),
    "bst": ("bst", dict(n_sparse=2, embed_dim=8, seq_len=5, n_blocks=1,
                        n_heads=2, default_vocab=V, top_mlp=(16, 1))),
}
F32_CUT = dict(dtype="float32", param_dtype="float32")


def _cfg(kind):
    arch, cut = KINDS[kind]
    return dc.replace(get_arch(arch).config, **cut, **F32_CUT)


def _batch(kind, cfg, rng, n):
    """numpy batch: ids in [-40, 3V) (mod V), sequences with -1 pads."""
    def ids(*shape):
        return rng.integers(-40, 3 * V, shape).astype(np.int32)
    lab = (rng.random(n) > .5).astype(np.float32)
    if kind == "wide_deep":
        return {"sparse": ids(n, cfg.n_sparse), "labels": lab}
    seq = rng.integers(-1, 3 * V, (n, cfg.seq_len)).astype(np.int32)
    if kind == "sasrec":
        return {"seq": seq, "pos": ids(n), "neg": ids(n, 4)}
    return {"seq": seq, "target": ids(n), "other": ids(n, cfg.n_sparse),
            "labels": lab}


JAX_CHILD = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import NULL_CTX, ShardingCtx, make_rules
    from repro.models.recsys import models as RM
    inp = pickle.load(open(sys.argv[1], "rb"))
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    INITS = {"wide_deep": RM.wide_deep_init, "sasrec": RM.sasrec_init,
             "bst": RM.bst_init}

    def fwd(kind, cfg, p, b, ctx):
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
        cfg = dc.replace(get_arch(arch).config, **cut, **inp["f32"])
        p = INITS[kind](jax.random.key(inp["seed"]), cfg)[0]
        out[f"{kind}/params"] = jax.tree.map(np.asarray, p)
        for c, b in enumerate(inp["batches"][kind]):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            for shape in [None, *inp["meshes"]]:
                def run(ctx):
                    o = jax.jit(lambda p, b: fwd(kind, cfg, p, b, ctx))(p, jb)
                    l, g = jax.jit(jax.value_and_grad(
                        lambda p, b: loss(kind, cfg, p, b, ctx)))(p, jb)
                    return dict(out=np.asarray(o), loss=float(l),
                                grads=jax.tree.map(np.asarray, g))
                if shape is None:
                    res = run(NULL_CTX)
                    tag = "one"
                else:
                    mesh = jax.make_mesh(shape, ("data", "model"),
                                         axis_types=AUTO)
                    with mesh:
                        res = run(ShardingCtx(make_rules(mesh), mesh))
                    tag = f"{shape[0]}x{shape[1]}"
                out[f"{kind}/{c}/{tag}"] = res
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_MESH_OK")
""")

RANK = textwrap.dedent("""
    import sys, pickle, dataclasses as dc, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import recsys_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    TP_OFF = {"mlp": None, "heads": None}   # no tensor parallelism
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import run_recsys
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

    def rows_of(t, rows):
        return t[:, rows] if t.dim() == 3 else t[rows]

    res = {}
    for kind, (arch, cut) in inp["kinds"].items():
        cfg = dc.replace(get_arch(arch).config, **cut, **inp["f32"])
        tree = jx[f"{kind}/params"]
        for shape in inp["meshes"]:
            mesh = make_mesh(shape, ("data", "model"))
            # tensor parallelism off: the row-sharded path bitwise
            ctx = ShardingCtx(make_rules(mesh, TP_OFF), mesh)
            tag = f"{kind}/{shape[0]}x{shape[1]}"
            rows = R.shard_rows(ctx, cfg.default_vocab)
            leaves = R.row_sharded_leaves(cfg, ctx)
            res[f"{tag}/rows"] = (rows.start, rows.stop)
            res[f"{tag}/leaves"] = leaves

            def whole_rows(flat):
                return {k: rows_of(v, rows) if k in leaves else v
                        for k, v in flat.items()}
            whole = recsys_params_from_jax(tree, kind, device="cpu")
            part = recsys_params_from_jax(tree, kind, device="cpu", ctx=ctx)
            res[f"{tag}/convert"] = (whole_rows(det(R.flatten_params(whole))),
                                     det(R.flatten_params(part)))
            g0 = R.init_params(cfg, generator=torch.Generator().manual_seed(
                0), device="cpu")
            g1 = R.init_params(cfg, generator=torch.Generator().manual_seed(
                0), device="cpu", ctx=ctx)
            res[f"{tag}/init"] = (whole_rows(R.flatten_params(g0)),
                                  R.flatten_params(g1))
            for c, b in enumerate(inp["batches"][kind]):
                b = {k: torch.from_numpy(v) for k, v in b.items()}
                o_w = ST.recsys_serve_step(whole, cfg, b)
                o_p = ST.recsys_serve_step(part, cfg, b, ctx)
                l_w, g_w = ST.loss_and_grads(whole, cfg, b)
                l_p, g_p = ST.loss_and_grads(part, cfg, b, ctx)
                group = ctx.group("model")
                missing = {k: (group,) for k in leaves[:-1]}
                res[f"{tag}/{c}"] = dict(
                    out=(o_w, o_p), loss=(float(l_w), float(l_p)),
                    grads=(whole_rows(g_w), g_p),
                    norm_missing=float(O.global_norm(g_p, missing)))
                if kind == "sasrec":
                    cand = torch.arange(-5, 3 * cfg.default_vocab)
                    u = o_w.detach()
                    res[f"{tag}/{c}/scores"] = (
                        R.sasrec_scores(whole, cfg, u, cand),
                        R.sasrec_scores(part, cfg, u, cand, ctx))
                # one clipped step each, from fresh trees
                steps = []
                for p, cx in ((recsys_params_from_jax(tree, kind,
                                                      device="cpu"), None),
                              (recsys_params_from_jax(tree, kind,
                                                      device="cpu", ctx=ctx),
                               ctx)):
                    opt = O.rankgraph2_optimizer()
                    st = opt.init(R.flatten_params(p))
                    loss, _ = ST.recsys_train_step(p, st, b, cfg, opt, cx)
                    steps.append((float(loss), det(R.flatten_params(p)),
                                  norms[-1]))
                res[f"{tag}/{c}/step"] = (
                    (steps[0][0], whole_rows(steps[0][1]), steps[0][2]),
                    steps[1])
            res[f"{tag}/run"] = (run_recsys(cfg, 2, batch=16, device="cpu"),
                                 run_recsys(cfg, 2, batch=16, device="cpu",
                                            ctx=ctx))
    torch.save(res, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recsys_mesh")
    rng = np.random.default_rng(0)
    batches = {kind: [_batch(kind, _cfg(kind), rng, n) for n in BATCHES]
               for kind in KINDS}
    inp = dict(kinds=KINDS, f32=F32_CUT, meshes=MESHES, seed=0,
               batches=batches)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    assert "JAX_MESH_OK" in _run_child(JAX_CHILD, str(tmp / "inputs.pkl"),
                                       str(tmp / "jax.pkl"))
    _run_ranks(RANK, 4, tmp, timeout=240)
    with open(tmp / "jax.pkl", "rb") as f:
        jx = pickle.load(f)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return inp, jx, ranks


def _rows_of(x, leaf, rows, leaves):
    if leaf not in leaves:
        return x
    lo, hi = rows
    return x[:, lo:hi] if x.ndim == 3 else x[lo:hi]


def _jax_flat(tree):
    """A JAX gradient tree under the port's flat names and layouts
    (linear ``w`` transposed, as ``recsys_params_from_jax``)."""
    return R.flatten_params(_as_torch(tree))


def _as_torch(tree):
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:
            return {"w": torch.from_numpy(np.asarray(tree["w"])).T,
                    "b": torch.from_numpy(np.asarray(tree["b"]))}
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


CASES = [(k, s, c) for k in KINDS for s in MESHES
         for c in range(len(BATCHES))]
IDS = [f"{k}-{s[0]}x{s[1]}-B{BATCHES[c]}" for k, s, c in CASES]


def test_batches_hold_ids_past_a_shard_and_the_vocab(runs):
    inp, _, _ = runs
    v_loc = V // max(s[1] for s in MESHES)
    for kind, bs in inp["batches"].items():
        ids = np.concatenate([v.reshape(-1) for b in bs
                              for k, v in b.items() if k != "labels"])
        assert (ids >= v_loc).any() and (ids >= V).any() and (ids < 0).any()


@pytest.mark.parametrize("kind,shape,case", CASES, ids=IDS)
def test_forward_and_loss_bitwise_the_one_process_run(runs, kind, shape,
                                                      case):
    _, _, ranks = runs
    tag = f"{kind}/{shape[0]}x{shape[1]}"
    for res in ranks:
        r = res[f"{tag}/{case}"]
        assert torch.equal(*r["out"])
        assert r["loss"][0] == r["loss"][1]


@pytest.mark.parametrize("kind,shape,case", CASES, ids=IDS)
def test_shard_gradients_are_the_whole_gradients_rows(runs, kind, shape,
                                                      case):
    _, _, ranks = runs
    tag = f"{kind}/{shape[0]}x{shape[1]}"
    for res in ranks:
        assert res[f"{tag}/leaves"] == R.ROW_SHARDED[kind]
        whole, part = res[f"{tag}/{case}"]["grads"]
        assert set(whole) == set(part)
        for k in whole:
            assert torch.equal(part[k], whole[k]), k


@pytest.mark.parametrize("kind,shape,case", CASES, ids=IDS)
def test_matches_jax_under_the_same_mesh(runs, kind, shape, case):
    _, jx, ranks = runs
    m = f"{shape[0]}x{shape[1]}"
    want = jx[f"{kind}/{case}/{m}"]
    one = jx[f"{kind}/{case}/one"]
    # the reference under the mesh gives its one-process values
    np.testing.assert_allclose(want["out"], one["out"], **F32)
    jgrads = _jax_flat(want["grads"])
    for res in ranks:
        r = res[f"{kind}/{m}/{case}"]
        leaves, rows = res[f"{kind}/{m}/leaves"], res[f"{kind}/{m}/rows"]
        np.testing.assert_allclose(r["out"][1].numpy(), want["out"], **F32)
        assert r["loss"][1] == pytest.approx(want["loss"], rel=1e-5)
        for k, g in r["grads"][1].items():
            w = _rows_of(jgrads[k], k, rows, leaves).numpy()
            np.testing.assert_allclose(
                g.numpy(), w, rtol=F32["rtol"],
                atol=GRAD_REL * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("kind,shape,case", CASES, ids=IDS)
def test_train_step_and_its_clip(runs, kind, shape, case):
    _, _, ranks = runs
    tag = f"{kind}/{shape[0]}x{shape[1]}"
    for res in ranks:
        (l1, whole, n1), (l2, part, n2) = res[f"{tag}/{case}/step"]
        assert l1 == l2
        assert n2 == pytest.approx(n1, rel=1e-6)
        for k in whole:
            torch.testing.assert_close(part[k], whole[k], rtol=0,
                                       atol=STEP_TOL)
        # a norm that leaves one sharded leaf's shard out of the sum over
        # the model group fails the check above
        missing = res[f"{tag}/{case}"]["norm_missing"]
        assert missing != pytest.approx(n1, rel=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_init_convert_and_run_recsys_under_the_mesh(runs, kind, shape):
    _, _, ranks = runs
    tag = f"{kind}/{shape[0]}x{shape[1]}"
    seen = set()
    for res in ranks:
        lo, hi = res[f"{tag}/rows"]
        assert hi - lo == V // shape[1]
        seen.add(lo)
        for what in ("init", "convert"):
            whole, part = res[f"{tag}/{what}"]
            assert set(whole) == set(part)
            for k in whole:
                assert torch.equal(part[k], whole[k]), (what, k)
        a, b = res[f"{tag}/run"]
        assert a == b
    assert len(seen) == shape[1]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sasrec_scores_under_the_mesh(runs, shape):
    _, _, ranks = runs
    for res in ranks:
        for c in range(len(BATCHES)):
            a, b = res[f"sasrec/{shape[0]}x{shape[1]}/{c}/scores"]
            assert torch.equal(a, b)
