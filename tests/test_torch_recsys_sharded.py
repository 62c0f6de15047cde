"""The port's row-sharded recsys lookup (``models.recsys.models.
_lookup_sharded`` and its dispatch) against the JAX package's, on the
same tables and ids made with numpy from a seed:

  * the JAX side runs in a child with 4 host devices: ``_lookup_sharded``
    at meshes (1, 4) and (2, 2) ``("data", "model")`` under jit, on a
    batch of 8 and one of 9, which (2, 2) pads to 10.  The reference's
    own pad path raises ``ShardingTypeError`` under this jax (its
    ``out[:n]`` slice of a data-sharded array); where it does, the child
    pads the ids itself, as the reference's body does, and keeps the
    first 9 rows.  It also takes ``jax.grad`` through
    ``_lookup_sharded`` and through ``_lookup_local``;
  * the port runs the same lookups in four gloo ranks on the CPU, each
    holding its rows of the tables.  Held: every rank's output bitwise
    the JAX output and the local gather; each rank's shard gradient
    (the autograd ``Function``'s backward) equal to its rows of
    ``_lookup_local``'s gradient on the whole table, which JAX's
    gradient through ``_lookup_sharded`` also equals (so the reference
    has no psum scaling to record here); the dispatch
    (``_lookup_simple``) goes local where ``V % nm != 0`` and where
    ``rules["table_rows"]`` is not ``"model"``; a ``dlrm`` forward and
    one ``recsys_train_step`` under each mesh against the same calls
    without one in the same process (the logits bitwise, the loss
    equal, each rank's table rows and the dense parameters after the
    step within 1e-6); ``run_recsys`` under the mesh gives the
    one-process losses;
  * ``row_shards`` and ``shard_rows`` follow the reference's dispatch
    conditions on meshes described by their axes and shapes;
  * ``ShardingCtx.group`` and ``axis_index`` over the two data axes of
    a (2, 2, 1) ``("pod", "data", "model")`` mesh: one group of all four
    ranks, indices row-major.
"""
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import ShardingCtx, make_rules
from repro_torch.models.recsys import models as R

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_, V, D = 3, 16, 8
MESHES = ((1, 4), (2, 2))
BATCHES = (8, 9)


def _run_child(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, *args], env=env,
                       capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _run_ranks(script: str, world: int, tmp, timeout: float = 180.0):
    """Run ``script`` as ``world`` processes (argv: rank, world, tmp dir),
    the port's ranks on the CPU; every one must exit 0 in ``timeout``
    seconds."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), str(tmp)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, o[-2000:], e[-3000:])
    return [o for o, _ in outs]


def _inputs():
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(F_, V, D)).astype(np.float32)
    cases = []
    for B in BATCHES:
        ids = rng.integers(-40, 40, (B, F_))    # negative and >= V: mod V
        w = rng.normal(size=(B, F_, D)).astype(np.float32)
        cases.append((ids, w))
    return tables, cases


JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.recsys import models as RM
    from repro.distributed.sharding import NULL_CTX, ShardingCtx, make_rules
    inp = np.load(sys.argv[1])
    tables, out = jnp.asarray(inp["tables"]), {}
    for c in range(int(inp["n_cases"])):
        ids, w = inp[f"ids{c}"], jnp.asarray(inp[f"w{c}"])
        out[f"local{c}"] = np.asarray(
            RM._lookup_local(tables, jnp.asarray(ids), NULL_CTX))
        out[f"glocal{c}"] = np.asarray(jax.grad(lambda t: jnp.sum(
            RM._lookup_local(t, jnp.asarray(ids), NULL_CTX) * w))(tables))
        for shape in %s:
            mesh = jax.make_mesh(shape, ("data", "model"))
            ctx = ShardingCtx(make_rules(mesh), mesh)
            tag = f"{c}_{shape[0]}x{shape[1]}"
            f = jax.jit(lambda t, i: RM._lookup_sharded(t, i, ctx))
            n, pad = len(ids), (-len(ids)) %% shape[0]
            ids_p = np.pad(ids, ((0, pad), (0, 0)))
            w_p = jnp.pad(w, ((0, pad), (0, 0), (0, 0)))
            with mesh:
                try:
                    o = f(tables, ids)
                    out[f"padded_by_ref{tag}"] = np.asarray(1)
                except Exception as e:
                    # the reference's own pad path: its out[:n] raises;
                    # pad as its body does, keep the first n rows
                    if "ShardingTypeError" not in type(e).__name__:
                        raise
                    o = np.asarray(f(tables, ids_p))[:n]
                    out[f"padded_by_ref{tag}"] = np.asarray(0)
                g = jax.jit(jax.grad(lambda t: jnp.sum(RM._lookup_sharded(
                    t, jnp.asarray(ids_p), ctx) * w_p)))(tables)
            out[f"sharded{tag}"] = np.asarray(o)
            out[f"gsharded{tag}"] = np.asarray(g)
    np.savez(sys.argv[2], **out)
    print("JAX_LOOKUP_OK")
""")

RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import RecsysConfig
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    TP_OFF = {"mlp": None, "heads": None}   # no tensor parallelism
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import run_recsys
    from repro_torch.models.recsys import models as R
    from repro_torch.optim import optimizers as O
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    inp = np.load(f"{tmp}/inputs.npz")
    tables = torch.from_numpy(inp["tables"])
    V = tables.shape[1]
    res = {}
    cfg = RecsysConfig(name="dlrm-small", kind="dlrm", n_dense=4,
                       n_sparse=3, embed_dim=8, default_vocab=V,
                       bot_mlp=(16, 8), top_mlp=(16, 1), dtype="float32",
                       param_dtype="float32")
    rng = np.random.default_rng(1)
    batch = {"dense": torch.from_numpy(
                 rng.normal(size=(9, 4)).astype(np.float32)),
             "sparse": torch.from_numpy(rng.integers(0, 50, (9, 3))),
             "labels": torch.from_numpy(
                 (rng.random(9) > .5).astype(np.float32))}
    for shape in %s:
        mesh = make_mesh(shape, ("data", "model"))
        # tensor parallelism off: the row-sharded path bitwise
        ctx = ShardingCtx(make_rules(mesh, TP_OFF), mesh)
        tag = f"{shape[0]}x{shape[1]}"
        rows = R.shard_rows(ctx, V)
        res[f"rows{tag}"] = (rows.start, rows.stop)
        for c in range(int(inp["n_cases"])):
            ids = torch.from_numpy(inp[f"ids{c}"])
            w = torch.from_numpy(inp[f"w{c}"])
            shard = tables[:, rows].clone().requires_grad_(True)
            out = R._lookup_simple(shard, ids, torch.float32, ctx, V)
            (out * w).sum().backward()
            res[f"out{c}_{tag}"] = out.detach()
            res[f"grad{c}_{tag}"] = shard.grad
            full = tables.clone().requires_grad_(True)
            loc = R._lookup_local(full, ids, torch.float32)
            (loc * w).sum().backward()
            res[f"local{c}_{tag}"] = loc.detach()
            res[f"glocal{c}_{tag}"] = full.grad[:, rows]
            # dispatch: V not a multiple of nm; table_rows off the model
            odd = torch.from_numpy(inp["odd"])
            res[f"odd{c}_{tag}"] = R._lookup_simple(odd, ids, torch.float32,
                                                   ctx)
            res[f"oddlocal{c}_{tag}"] = R._lookup_local(odd, ids,
                                                        torch.float32)
            off = ShardingCtx(make_rules(mesh, {"table_rows": None}), mesh)
            res[f"off{c}_{tag}"] = R._lookup_simple(tables, ids,
                                                   torch.float32, off)
        # dlrm: forward and one train step with and without the mesh
        whole = R.dlrm_init(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
        part = R.dlrm_init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", ctx=ctx)
        res[f"init{tag}"] = torch.equal(part["tables"],
                                        whole["tables"][:, rows])
        res[f"logits{tag}"] = ST.recsys_serve_step(whole, cfg, batch)
        res[f"slogits{tag}"] = ST.recsys_serve_step(part, cfg, batch, ctx)
        opt = O.rankgraph2_optimizer()
        l1, _ = ST.recsys_train_step(whole, opt.init(R.flatten_params(whole)),
                                     batch, cfg, opt)
        l2, _ = ST.recsys_train_step(part, opt.init(R.flatten_params(part)),
                                     batch, cfg, opt, ctx)
        res[f"loss{tag}"] = (float(l1), float(l2))
        res[f"after{tag}"] = ({k: v.detach()[:, rows] if k == "tables"
                               else v.detach() for k, v in
                               R.flatten_params(whole).items()},
                              {k: v.detach() for k, v in
                               R.flatten_params(part).items()})
        res[f"run{tag}"] = (run_recsys(cfg, 2, batch=16, device="cpu"),
                            run_recsys(cfg, 2, batch=16, device="cpu",
                                       ctx=ctx))
    # a group over two axes of size 2: made by every rank, all of them
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    axes = ctx.mesh_axes("batch")
    x = torch.tensor([float(rank)])
    torch.distributed.all_reduce(x, group=ctx.group(axes))
    res["pod_data"] = (axes, ctx.axis_index(axes), ctx.axis_size("batch"),
                       float(x))
    torch.save(res, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lookup")
    tables, cases = _inputs()
    odd = np.random.default_rng(5).normal(size=(F_, 17, D)).astype(
        np.float32)
    arrays = {"tables": tables, "n_cases": np.asarray(len(cases)),
              "odd": odd}
    for c, (ids, w) in enumerate(cases):
        arrays[f"ids{c}"], arrays[f"w{c}"] = ids, w
    np.savez(tmp / "inputs.npz", **arrays)
    assert "JAX_LOOKUP_OK" in _run_child(JAX_CHILD % repr(MESHES),
                                         str(tmp / "inputs.npz"),
                                         str(tmp / "jax.npz"))
    _run_ranks(RANK % repr(MESHES), 4, tmp)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return dict(np.load(tmp / "jax.npz")), ranks


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", range(len(BATCHES)),
                         ids=[f"B{b}" for b in BATCHES])
def test_sharded_lookup_matches_jax_bitwise(runs, shape, case):
    j, ranks = runs
    tag = f"{shape[0]}x{shape[1]}"
    want = j[f"sharded{case}_{tag}"]
    np.testing.assert_array_equal(want, j[f"local{case}"])
    for res in ranks:
        np.testing.assert_array_equal(res[f"out{case}_{tag}"].numpy(), want)
        np.testing.assert_array_equal(res[f"local{case}_{tag}"].numpy(),
                                      want)
    if BATCHES[case] % shape[0]:
        # the reference's pad path, or where it raised, its body on ids
        # padded the same way: recorded, not assumed
        assert int(j[f"padded_by_ref{case}_{tag}"]) in (0, 1)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", range(len(BATCHES)),
                         ids=[f"B{b}" for b in BATCHES])
def test_sharded_lookup_gradient_is_the_local_one(runs, shape, case):
    j, ranks = runs
    tag = f"{shape[0]}x{shape[1]}"
    nm = shape[1]
    glocal = j[f"glocal{case}"]
    # JAX's gradient through ``_lookup_sharded`` is the local one
    np.testing.assert_allclose(j[f"gsharded{case}_{tag}"], glocal,
                               rtol=0, atol=1e-6)
    assembled = np.zeros_like(glocal)
    seen = set()
    for res in ranks:
        lo, hi = res[f"rows{tag}"]
        assert hi - lo == V // nm
        got = res[f"grad{case}_{tag}"].numpy()
        np.testing.assert_allclose(got, res[f"glocal{case}_{tag}"].numpy(),
                                   rtol=0, atol=1e-6)
        assembled[:, lo:hi] = got
        seen.add(lo)
    assert len(seen) == nm
    np.testing.assert_allclose(assembled, glocal, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dispatch_and_dlrm_under_the_mesh(runs, shape):
    _, ranks = runs
    tag = f"{shape[0]}x{shape[1]}"
    for res in ranks:
        for c in range(len(BATCHES)):
            assert torch.equal(res[f"odd{c}_{tag}"],
                               res[f"oddlocal{c}_{tag}"])
            assert torch.equal(res[f"off{c}_{tag}"], res[f"local{c}_{tag}"])
        assert res[f"init{tag}"]
        assert torch.equal(res[f"slogits{tag}"], res[f"logits{tag}"])
        l1, l2 = res[f"loss{tag}"]
        assert l1 == l2
        whole, part = res[f"after{tag}"]
        assert set(whole) == set(part)
        for k in whole:
            torch.testing.assert_close(part[k], whole[k], rtol=0, atol=1e-6)
        a, b = res[f"run{tag}"]
        assert a == pytest.approx(b, rel=1e-6)


def test_group_over_two_mesh_axes(runs):
    _, ranks = runs
    for r, res in enumerate(ranks):
        assert res["pod_data"] == (("pod", "data"), r, 4, 6.0)


def test_row_shards_follows_the_reference_dispatch():
    def ctx(shape, axes=("data", "model"), overrides=None):
        mesh = SimpleNamespace(mesh_dim_names=axes, shape=shape)
        return ShardingCtx(make_rules(axes, overrides), mesh)
    assert R.row_shards(None, 16) == 1
    assert R.row_shards(ShardingCtx(), 16) == 1
    assert R.row_shards(ctx((1, 4)), 16) == 4
    assert R.row_shards(ctx((2, 2)), 16) == 2
    assert R.row_shards(ctx((1, 4)), 18) == 1          # V % nm != 0
    assert R.row_shards(ctx((4, 1)), 16) == 1          # nm == 1
    assert R.row_shards(ctx((4,), ("data",)), 16) == 1  # no model axis
    assert R.row_shards(ctx((1, 4), overrides={"table_rows": None}),
                        16) == 1
    assert R.row_shards(ctx((1, 2, 4), ("pod", "data", "model")), 16) == 4
    assert R.shard_rows(None, 16) is None
    with pytest.raises(ValueError, match="expected 4 rows"):
        R._lookup_simple(torch.zeros(3, 16, 2), torch.zeros(2, 3,
                                                            dtype=torch.long),
                         torch.float32, ctx((1, 4)), 16)
