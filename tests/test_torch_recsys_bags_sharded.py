"""dlrm's multi-hot bags over row-sharded tables
(``models.recsys.models._bag_sharded``: f32 partial bags of a rank's rows
summed over the model group, rounded once) on the CPU, where the
EmbeddingBag op runs its plain versions:

  * the JAX side runs in a child with 4 host devices: ``dlrm_forward``
    with (B, F, L) ids under meshes (1, 4) and (2, 2) ``("data",
    "model")`` of ``AxisType.Auto`` axes (the reference runs its bag
    lookup under the mesh there; it does not raise), its loss and
    gradients, and the same without a mesh, on a batch of 8 and one of 9;
  * the port runs four gloo ranks on the CPU, each holding its rows of
    the tables.  Held in f32: the sharded bags within ``BAG_F32`` of the
    one-process op's (the same f32 terms, summed a rank's share first),
    the logits, loss and gradients within ``F32`` / ``GRAD_REL`` of JAX's
    under the mesh, one ``recsys_train_step`` within 1e-6 of the
    one-process step; the shard's table gradient under a fixed cotangent
    bitwise the one-process op's rows (a row's terms come in the same
    order: the plain backward adds them by position); in bf16 compute
    the bags within one bf16 step of the one-process op's, the count of
    entries that differ recorded;
  * ``_bag_sharded`` raises for ``mode="mean"`` and for weights;
  * ``embedding_bag_ref(out_dtype=torch.float32)`` is the f32 sum of
    bf16-rounded rows, and rounding it once gives the bf16 output
    bitwise.
"""
import dataclasses as dc
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models.recsys import models as R
from test_torch_recsys_mesh import _jax_flat
from test_torch_recsys_sharded import _run_child, _run_ranks

torch.set_num_threads(2)

MESHES = ((1, 4), (2, 2))
BATCHES = (8, 9)
V, L = 32, 5
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-5              # gradients against JAX: of the leaf's largest
BAG_F32 = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = 1e-6
CUT = dict(n_dense=4, n_sparse=3, embed_dim=8, default_vocab=V,
           bot_mlp=(16, 8), top_mlp=(16, 1), param_dtype="float32")


def _cfg(dtype="float32"):
    return dc.replace(get_arch("dlrm-rm2").config, **CUT, dtype=dtype)


def _batch(rng, n):
    """Bags of up to L ids in [-3, 3V) (< 0: padding; >= V: mod V), one
    bag empty."""
    sparse = rng.integers(-3, 3 * V, (n, CUT["n_sparse"], L))
    sparse[rng.random(sparse.shape) < 0.3] = -1
    sparse[0, 1] = -1
    return {"dense": rng.normal(size=(n, CUT["n_dense"])).astype(np.float32),
            "sparse": sparse.astype(np.int32),
            "labels": (rng.random(n) > .5).astype(np.float32)}


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
    cfg = dc.replace(get_arch("dlrm-rm2").config, **inp["cut"],
                     dtype="float32")
    p = RM.dlrm_init(jax.random.key(1), cfg)[0]
    out = {"params": jax.tree.map(np.asarray, p)}
    for c, b in enumerate(inp["batches"]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}

        def run(ctx):
            def loss(p, b):
                return RM.bce_loss(RM.dlrm_forward(p, cfg, b["dense"],
                                                   b["sparse"], ctx),
                                   b["labels"])
            o = jax.jit(lambda p, b: RM.dlrm_forward(
                p, cfg, b["dense"], b["sparse"], ctx))(p, jb)
            l, g = jax.jit(jax.value_and_grad(loss))(p, jb)
            return dict(out=np.asarray(o), loss=float(l),
                        grads=jax.tree.map(np.asarray, g))
        out[f"{c}/one"] = run(NULL_CTX)
        for shape in inp["meshes"]:
            mesh = jax.make_mesh(shape, ("data", "model"), axis_types=AUTO)
            with mesh:
                out[f"{c}/{shape[0]}x{shape[1]}"] = run(
                    ShardingCtx(make_rules(mesh), mesh))
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_BAGS_OK")
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
    from repro_torch.models.recsys import models as R
    from repro_torch.optim import optimizers as O
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    inp = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    tree = pickle.load(open(f"{tmp}/jax.pkl", "rb"))["params"]
    base = dc.replace(get_arch("dlrm-rm2").config, **inp["cut"])
    res = {}

    def det(t):
        return {k: v.detach().clone() for k, v in t.items()}

    for shape in inp["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        # tensor parallelism off: the row-sharded path bitwise
        ctx = ShardingCtx(make_rules(mesh, TP_OFF), mesh)
        m = f"{shape[0]}x{shape[1]}"
        rows = R.shard_rows(ctx, base.default_vocab)
        res[f"{m}/rows"] = (rows.start, rows.stop)
        whole = recsys_params_from_jax(tree, "dlrm", device="cpu")
        part = recsys_params_from_jax(tree, "dlrm", device="cpu", ctx=ctx)
        for c, b in enumerate(inp["batches"]):
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            ids = b["sparse"]
            r = {}
            for dt, dtype in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
                one = R._bag_lookup(whole["tables"], ids, dtype)
                sh = R._bag_lookup(part["tables"], ids, dtype, ctx,
                                   base.default_vocab)
                r[f"bags_{dt}"] = (one, sh)
            # the shard's gradient under a fixed cotangent
            G = torch.randn(ids.shape[0], ids.shape[1], base.embed_dim,
                            generator=torch.Generator().manual_seed(c))
            tw = whole["tables"].detach().clone().requires_grad_(True)
            tp = part["tables"].detach().clone().requires_grad_(True)
            (R._bag_lookup(tw, ids, torch.float32) * G).sum().backward()
            (R._bag_sharded(tp, ids, ctx, torch.float32) * G).sum(
                ).backward()
            r["dtab"] = (tw.grad[:, rows], tp.grad)
            cfg = dc.replace(base, dtype="float32")
            r["out"] = ST.recsys_serve_step(part, cfg, b, ctx)
            l_p, g_p = ST.loss_and_grads(part, cfg, b, ctx)
            r["loss"], r["grads"] = float(l_p), g_p
            steps = []
            for cx in (None, ctx):
                p = recsys_params_from_jax(tree, "dlrm", device="cpu",
                                           ctx=cx)
                opt = O.rankgraph2_optimizer()
                st = opt.init(R.flatten_params(p))
                loss, _ = ST.recsys_train_step(p, st, b, cfg, opt, cx)
                flat = det(R.flatten_params(p))
                if cx is None:
                    flat["tables"] = flat["tables"][:, rows]
                steps.append((float(loss), flat))
            r["step"] = steps
            res[f"{m}/{c}"] = r
    torch.save(res, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bags_sharded")
    rng = np.random.default_rng(3)
    inp = dict(cut=CUT, meshes=MESHES,
               batches=[_batch(rng, n) for n in BATCHES])
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    assert "JAX_BAGS_OK" in _run_child(JAX_CHILD, str(tmp / "inputs.pkl"),
                                       str(tmp / "jax.pkl"))
    _run_ranks(RANK, 4, tmp, timeout=240)
    with open(tmp / "jax.pkl", "rb") as f:
        jx = pickle.load(f)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return inp, jx, ranks


CASES = [(s, c) for s in MESHES for c in range(len(BATCHES))]
IDS = [f"{s[0]}x{s[1]}-B{BATCHES[c]}" for s, c in CASES]


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_sharded_bags_against_the_one_process_op(runs, shape, case):
    _, _, ranks = runs
    for res in ranks:
        r = res[f"{_tag(shape)}/{case}"]
        one, sh = r["bags_f32"]
        torch.testing.assert_close(sh, one, **BAG_F32)
        one, sh = r["bags_bf16"]
        assert sh.dtype == torch.bfloat16
        # one rounding of sums that differ in their last f32 bits: at
        # most one bf16 step apart, most entries equal
        step = 2.0 ** -7 * one.float().abs()
        assert bool(((sh.float() - one.float()).abs() <= step).all())
        assert float((sh != one).float().mean()) < 0.05


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_shard_table_gradient_is_the_whole_ones_rows(runs, shape, case):
    _, _, ranks = runs
    seen = set()
    for res in ranks:
        whole, part = res[f"{_tag(shape)}/{case}"]["dtab"]
        assert torch.equal(part, whole)
        assert bool(part.any())
        seen.add(res[f"{_tag(shape)}/rows"])
    assert len(seen) == shape[1]


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_dlrm_with_bags_matches_jax_under_the_mesh(runs, shape, case):
    _, jx, ranks = runs
    want = jx[f"{case}/{_tag(shape)}"]
    np.testing.assert_allclose(want["out"], jx[f"{case}/one"]["out"], **F32)
    jgrads = _jax_flat(want["grads"])
    for res in ranks:
        r = res[f"{_tag(shape)}/{case}"]
        lo, hi = res[f"{_tag(shape)}/rows"]
        np.testing.assert_allclose(r["out"].numpy(), want["out"], **F32)
        assert r["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for k, g in r["grads"].items():
            w = jgrads[k][:, lo:hi] if k == "tables" else jgrads[k]
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=F32["rtol"],
                atol=GRAD_REL * float(w.abs().max()), err_msg=k)


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_dlrm_train_step_with_bags(runs, shape, case):
    _, _, ranks = runs
    for res in ranks:
        (l1, whole), (l2, part) = res[f"{_tag(shape)}/{case}"]["step"]
        assert l2 == pytest.approx(l1, rel=1e-6)
        for k in whole:
            torch.testing.assert_close(part[k], whole[k], rtol=0,
                                       atol=STEP_TOL)


@pytest.mark.parametrize("kw", [dict(mode="mean"),
                                dict(weights=torch.ones(2, 3, L))],
                         ids=["mean", "weights"])
def test_sharded_bags_take_only_unweighted_sums(kw):
    tables = torch.zeros(3, V // 4, 8)
    ids = torch.zeros(2, 3, L, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="mode 'sum' without"):
        R._bag_sharded(tables, ids, None, torch.float32, **kw)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_f32_partial_bags_of_the_plain_version(tdt):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 16, generator=g).to(tdt)
    ids = torch.randint(-1, 50, (40, 7), generator=g)
    ids[3] = -1
    part = embedding_bag_ref(table, ids, None, "sum", torch.bfloat16,
                             torch.float32)
    assert part.dtype == torch.float32
    rows = table[ids.clamp_min(0)].to(torch.bfloat16).float()
    want = (rows * (ids >= 0)[..., None]).sum(dim=1)
    assert torch.equal(part, want)
    assert torch.equal(part.to(torch.bfloat16),
                       embedding_bag_ref(table, ids, None, "sum",
                                         torch.bfloat16))
