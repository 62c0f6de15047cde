"""The port's ``distributed/`` modules and shard-local negatives against the
JAX package, on the same inputs made with numpy from a seed:

  * ``make_rules`` and ``logical_to_spec`` for every logical name and
    every ordered pair of names, over the meshes ``("data",)``,
    ``("data", "model")`` and ``("pod", "data", "model")``, with and
    without overrides (a JAX ``PartitionSpec`` read as a tuple), and
    ``tree_logical_to_spec`` on a nested tree: equal;
  * ``ShardingCtx.axis_size`` over mesh shapes against the JAX
    context's, ``constrain`` returning its input, ``axis_index`` and
    ``group`` raising without a mesh;
  * ``HeartbeatMonitor``, ``StragglerTracker``, ``ElasticPlan.plan``
    (including its raise) and ``recovery_cost_model`` driven by the
    same fake clock: equal;
  * ``int8_roundtrip``: bitwise; ``powersgd_roundtrip`` fed JAX's ``q``:
    within 1e-5; ``compressed(adamw)`` (int8) over three steps: updates
    and error feedback within 1e-6 relative; ``compression_ratio``:
    equal; the PowerSGD wrapper's error feedback adds up;
  * ``sample_negatives(shard_block=)`` with JAX's draws injected:
    bitwise, at dividing blocks, at the whole batch and at blocks that
    fall back to it (not dividing B, above B);
  * ``launch.mesh``: a one-rank gloo group on the CPU, meshes of one
    rank with the three axis layouts, the raise on a world size that is
    not the mesh's, and the production mesh's raise.
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import negatives as JN
from repro.distributed import compression as JC
from repro.distributed import runtime as JR
from repro.distributed import sharding as JS
from repro.optim import optimizers as JO
from repro_torch.core import negatives as N
from repro_torch.distributed import compression as C
from repro_torch.distributed import runtime as R
from repro_torch.distributed import sharding as S
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)

MESHES = (("data",), ("data", "model"), ("pod", "data", "model"))
OVERRIDES = (None, {"embed": "data", "mlp": None, "seq": ("data", "model"),
                    "table_rows": ("pod", "model"), "new_name": "model"})
NAMES = sorted(set(S.DEFAULT_RULES) | {"new_name", "unknown"})


def _jax_mesh(axes):
    return jax.make_mesh((1,) * len(axes), axes)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["default", "override"])
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(a))
def test_rules_and_specs_match_jax(axes, overrides):
    jr = JS.make_rules(_jax_mesh(axes), overrides)
    pr = S.make_rules(axes, overrides)
    assert pr == jr
    assert list(pr) == list(jr)
    for a in NAMES:
        for b in [None] + NAMES:
            spec = (a,) if b is None else (a, b, None)
            assert S.logical_to_spec(spec, pr) == tuple(
                JS.logical_to_spec(spec, jr)), spec
    assert S.logical_to_spec(None, pr) == tuple(JS.logical_to_spec(None, jr))
    tree = {"a": ("batch", "embed"), "b": [None, ("mlp", "heads")],
            "c": {"d": ("heads", "head_dim", "batch"), "e": (None,)}}
    want = JS.tree_logical_to_spec(tree, jr)
    got = S.tree_logical_to_spec(tree, pr)
    assert got["a"] == tuple(want["a"])
    assert [tuple(x) for x in want["b"]] == list(got["b"])
    assert got["c"] == {k: tuple(v) for k, v in want["c"].items()}


@pytest.mark.parametrize("shape,axes", [
    ((4,), ("data",)), ((2, 4), ("data", "model")),
    ((1, 4), ("data", "model")), ((2, 2, 4), ("pod", "data", "model"))])
def test_axis_size_matches_jax(shape, axes):
    rules = S.make_rules(axes)
    # the JAX context reads only ``axis_names`` and ``devices.shape``
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    jctx = JS.ShardingCtx(JS.make_rules(_jax_mesh(axes)), jmesh)
    pctx = S.ShardingCtx(rules, SimpleNamespace(mesh_dim_names=axes,
                                                shape=shape))
    for name in NAMES:
        assert pctx.axis_size(name) == jctx.axis_size(name), name
    assert S.NULL_CTX.axis_size("batch") == 1
    assert S.ShardingCtx(rules).axis_size("batch") == 1
    assert pctx.mesh_axes("batch") == tuple(
        a for a in ("pod", "data") if a in axes)


def test_constrain_is_a_noop_and_no_mesh_raises():
    x = torch.arange(12.0).reshape(3, 4)
    ctx = S.ShardingCtx(S.make_rules(("data", "model")),
                        SimpleNamespace(mesh_dim_names=("data", "model"),
                                        shape=(2, 2)))
    assert ctx(x, "batch", "mlp") is x
    assert S.NULL_CTX(x, "batch") is x
    assert S.constrain(x, ("batch", None), ctx.rules) is x
    with pytest.raises(ValueError):
        S.NULL_CTX.axis_index("data")
    with pytest.raises(ValueError):
        S.NULL_CTX.group("data")
    with pytest.raises(ValueError):
        ctx.axis_index("pod")


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_monitor(mod):
    clock = FakeClock()
    hosts = [f"h{i}" for i in range(5)]
    mon = mod.HeartbeatMonitor(hosts, deadline_s=30.0, clock=clock)
    tr = mod.StragglerTracker(mon, tolerance=1.5)
    rng = np.random.default_rng(0)
    out = []
    for step in range(1, 12):
        for i, h in enumerate(hosts):
            if h == "h4" and step > 6:     # h4 stops beating
                continue
            clock.t += float(rng.uniform(0.5, 1.5)) * (3.0 if h == "h2"
                                                       else 1.0)
            mon.beat(h, step + (step % 3 if h == "h1" else 0))
        clock.t += 4.0
        out.append((mon.suspects(), mon.healthy(), tr.stragglers(),
                    {h: (st.last_beat, st.last_step, st.ewma_step_s)
                     for h, st in mon.hosts.items()}))
    return out


def test_runtime_matches_jax():
    assert _drive_monitor(R) == _drive_monitor(JR)
    for n_new, kw in [(256, {}), (96, {}), (40, {"model_axis": 8}),
                      (7, {}), (48, {"model_axis": 16, "min_data": 3})]:
        a = R.ElasticPlan.plan(n_new, **kw)
        b = JR.ElasticPlan.plan(n_new, **kw)
        assert (a.n_old, a.n_new, a.data_axis, a.model_axis,
                a.mesh_shape()) == (b.n_old, b.n_new, b.data_axis,
                                    b.model_axis, b.mesh_shape())
    for mod in (R, JR):
        with pytest.raises(ValueError, match="cannot hold"):
            mod.ElasticPlan.plan(32, model_axis=16, min_data=3)
    for args in [(100, 1.5, 60.0, 5000.0, 1024), (10, 0.2, 5.0, 1e-12, 1),
                 (1000, 3.0, 600.0, 20000.0, 4096)]:
        assert R.recovery_cost_model(*args) == JR.recovery_cost_model(*args)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 6), (1,), (64, 32)])
def test_int8_roundtrip_is_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 10 ** rng.uniform(-3, 2)).astype(
        np.float32)
    want = np.asarray(JC.int8_roundtrip(jnp.asarray(x)))
    got = C.int8_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    z = np.zeros(shape, np.float32)
    np.testing.assert_array_equal(C.int8_roundtrip(torch.from_numpy(z)),
                                  np.asarray(JC.int8_roundtrip(z)))


@pytest.mark.parametrize("shape,rank", [((32, 24), 4), ((3, 10, 12), 2),
                                        ((6, 50), 4), ((4, 4), 4),
                                        ((9,), 4)])
def test_powersgd_roundtrip_with_jax_q(shape, rank):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(JC.powersgd_roundtrip(jnp.asarray(x), rank, key))
    # the q the JAX function draws from ``key``
    q = np.array(jax.random.normal(key, (shape[-1], rank), jnp.float32))
    got = C.powersgd_roundtrip(torch.from_numpy(x), rank,
                               q=torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _tree(rng):
    return {"a": rng.normal(size=(12, 8)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(2, 6, 7)).astype(np.float32)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_compressed_adamw_int8_three_steps_match_jax():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [{k: (v * 10 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, v in _tree(rng).items()} for _ in range(3)]
    jopt = JC.compressed(JO.adamw(0.01), scheme="int8")
    popt = C.compressed(O.adamw(0.01), scheme="int8")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        jp = JO.apply_updates(jp, ju)
        pu, ps = popt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ps, pp)
        O.apply_updates(pp, pu)
        for k in params:
            assert _rel(pu[k].numpy(), np.asarray(ju[k])) <= 1e-6, k
            assert _rel(ps.error[k].numpy(), np.asarray(js.error[k])) \
                <= 1e-6, k
            assert _rel(pp[k].numpy(), np.asarray(jp[k])) <= 1e-6, k
    assert any(float(np.abs(np.asarray(js.error[k])).max()) > 0
               for k in params)


def test_compressed_powersgd_error_feedback_adds_up():
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    opt = C.compressed(O.sgd(0.1), scheme="powersgd", rank=2, seed=5)
    st = opt.init(params)
    err = {k: torch.zeros_like(v) for k, v in params.items()}
    for _ in range(3):
        g = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
        upd, st = opt.update(g, st, params)
        for k in params:   # sgd: update = -lr * g_hat, g_hat = g + e - e'
            g_hat = -upd[k] / 0.1
            torch.testing.assert_close(g_hat + st.error[k], g[k] + err[k],
                                       atol=1e-5, rtol=1e-5)
        err = dict(st.error)
    # the same seed draws the same q: the same updates
    again = C.compressed(O.sgd(0.1), scheme="powersgd", rank=2, seed=5)
    a, _ = opt.update(g, opt.init(params), params)
    b, _ = again.update(g, again.init(params), params)
    for k in params:
        assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError):
        C.compressed(O.sgd(0.1), scheme="fp4")


@pytest.mark.parametrize("scheme,rank", [("int8", 4), ("powersgd", 4),
                                         ("powersgd", 1)])
def test_compression_ratio_matches_jax(scheme, rank):
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    assert C.compression_ratio({k: torch.from_numpy(v) for k, v
                                in tree.items()}, scheme, rank) == \
        JC.compression_ratio({k: jnp.asarray(v) for k, v in tree.items()},
                             scheme, rank)


# ---------------------------------------------------------------------------
# shard-local negatives
# ---------------------------------------------------------------------------

def jax_draws(key, B, H, n_neg, n_pool, pool_fill, blk):
    """The index draws JAX ``sample_negatives`` makes from ``key`` at
    block ``blk``, as ``negatives.negative_draws`` lays them out."""
    n_inb, n_pool, n_aug = N.split_counts(n_neg, n_pool, H)
    hi = jnp.maximum(blk, 2)
    k1, k2, k3 = jax.random.split(key, 3)
    fill = jnp.maximum(pool_fill, 1)
    d = dict(inb=jax.random.randint(k1, (B, n_inb), 1, hi),
             pool=jax.random.randint(k2, (B, n_pool), 0, fill),
             fallback=jax.random.randint(k3, (B, n_pool), 1, hi),
             aug_off=jax.random.randint(jax.random.fold_in(key, 7),
                                        (B, n_aug), 1, hi),
             aug_head=jax.random.randint(jax.random.fold_in(key, 8),
                                         (B, n_aug), 0, H))
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in d.items()}


@pytest.mark.parametrize("shard_block", [4, 8, 24, 0, 5, 48, 1])
@pytest.mark.parametrize("pool_fill", [0, 13])
@pytest.mark.parametrize("H", [1, 3])
def test_shard_local_negatives_bitwise(shard_block, pool_fill, H):
    rng = np.random.default_rng(H + pool_fill + shard_block)
    B, d, n_neg, n_pool = 24, 8, 16, 4
    prim = rng.normal(size=(B, d)).astype(np.float32)
    heads = rng.normal(size=(B, H, d)).astype(np.float32)
    pool = rng.normal(size=(20, d)).astype(np.float32)
    key = jax.random.key(11)
    fill = jnp.int32(pool_fill)
    want = JN.sample_negatives(key, jnp.asarray(prim), jnp.asarray(heads),
                               jnp.asarray(pool), fill, n_neg, n_pool,
                               shard_block=shard_block)
    blk = N.block_size(B, shard_block)
    assert blk == (shard_block if shard_block in (4, 8, 24, 1) else B)
    got = N.sample_negatives(
        torch.from_numpy(prim), torch.from_numpy(heads),
        torch.from_numpy(pool), pool_fill, n_neg, n_pool,
        draws=jax_draws(key, B, H, n_neg, n_pool, fill, blk),
        shard_block=shard_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn from a generator: in-batch rows stay in the row's block
    g = torch.Generator().manual_seed(0)
    dr = N.negative_draws(B, H, n_neg, n_pool, pool_fill, generator=g,
                          shard_block=shard_block)
    for k in ("inb", "fallback", "aug_off"):
        if dr[k].numel():
            assert int(dr[k].min()) >= 1
            assert int(dr[k].max()) < max(blk, 2)
    own = N.sample_negatives(torch.from_numpy(prim), torch.from_numpy(heads),
                             torch.from_numpy(pool), pool_fill, n_neg,
                             n_pool, draws=dr, shard_block=shard_block)
    n_inb = N.split_counts(n_neg, n_pool, H)[0]
    rows = torch.arange(B)[:, None] // blk * blk + (
        torch.arange(B)[:, None] + dr["inb"]) % blk
    assert torch.equal(own[:, :n_inb], torch.from_numpy(prim)[rows])
    if blk > 1:
        assert torch.all(rows // blk == torch.arange(B)[:, None] // blk)


# ---------------------------------------------------------------------------
# launch.mesh on one gloo rank
# ---------------------------------------------------------------------------

def test_mesh_builders_on_one_rank(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    backend, dev = LM.init_distributed(0, 1, str(tmp_path / "rdv"),
                                       device="cpu")
    try:
        assert (backend, dev.type) == ("gloo", "cpu")
        for axes in MESHES:
            mesh = LM.make_mesh((1,) * len(axes), axes)
            assert S.mesh_axis_names(mesh) == axes
            assert LM.mesh_chip_count(mesh) == 1
            ctx = S.ShardingCtx(S.make_rules(mesh), mesh)
            assert ctx.axis_size("batch") == 1
            assert ctx.axis_index(ctx.mesh_axes("batch")) == 0
            assert dist.get_world_size(ctx.group("data")) == 1
        host = LM.make_host_mesh()
        assert tuple(host.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            LM.make_mesh((2, 2), ("data", "model"))
        with pytest.raises(ValueError, match="needs 256 ranks"):
            LM.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 ranks"):
            LM.make_production_mesh(multi_pod=True)
        assert math.prod((2, 16, 16)) == 512
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="init_distributed"):
        LM.make_mesh((1,), ("data",))
