"""``launch.steps.recsys_retrieval_step(ctx=)``, the sharded retrieval
step: the query and candidate rows through the sharded lookup, the
candidates split over the ``candidates`` rule's axes (``("pod",
"data")``), each rank's own top k, and the merge of the gathered
(value, global index) pairs in ``jax.lax.top_k``'s order.

The JAX side runs in a child with 4 host devices: the reference's
``retrieval_cand`` step body (``repro/launch/steps.py::_recsys_cell``:
``take_rows`` of the query and the candidates, the ``candidates``
constraint, ``jax.lax.top_k``) under meshes (1, 4), (2, 2) and (4, 1)
``("data", "model")`` of ``AxisType.Auto`` axes, for every recsys kind
in f32.  The port runs four gloo ranks on the CPU.  At (1, 4) the
candidates stay whole (a data axis of 1) over row-sharded tables; at
(2, 2) both split; at (4, 1) the tables stay whole and the candidates
split four ways.  Candidate ids repeat (203 drawn from 96 ids, taken mod
32), so the top k holds ties, which must come lower index first.  Held:
every rank's (values, indices) bitwise the port's one-process step, the
indices equal to JAX's and the values within ``F32``; dlrm also in bf16
against the one-process step; 3 candidates over 4 ranks leave a rank an
empty block.  ``dot_scores`` in chunks and ``merge_top_k``'s order are
also held on their own.
"""
import dataclasses as dc
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from test_torch_recsys_bags_sharded import CUT as DLRM_CUT
from test_torch_recsys_mesh import KINDS as MESH_KINDS
from test_torch_recsys_sharded import _run_child, _run_ranks

torch.set_num_threads(2)

MESHES = ((1, 4), (2, 2), (4, 1))
KINDS = {**MESH_KINDS, "dlrm": ("dlrm-rm2", {
    k: v for k, v in DLRM_CUT.items() if k != "param_dtype"})}
V = 32
F32 = dict(rtol=1e-5, atol=1e-6)
QUERIES = ((203, 20), (203, 100), (3, 3))     # (candidates, k)


def _inputs(rng):
    """Per kind one query (a batch of one) and per case the candidate
    ids, in [-7, 3V) (mod V: repeats)."""
    batches = {}
    for kind, (arch, cut) in KINDS.items():
        cfg = dc.replace(get_arch(arch).config, **cut)
        if kind in ("dlrm", "wide_deep"):
            batches[kind] = {"sparse": rng.integers(
                -7, 3 * V, (1, cfg.n_sparse)).astype(np.int32)}
        else:
            batches[kind] = {"seq": rng.integers(
                -1, 3 * V, (1, cfg.seq_len)).astype(np.int32)}
    cands = [rng.integers(-7, 3 * V, n).astype(np.int32)
             for n, _ in QUERIES]
    return batches, cands


JAX_CHILD = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import ShardingCtx, make_rules
    from repro.models.recsys import models as R
    inp = pickle.load(open(sys.argv[1], "rb"))
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    INITS = {"dlrm": R.dlrm_init, "wide_deep": R.wide_deep_init,
             "sasrec": R.sasrec_init, "bst": R.bst_init}
    out = {}
    for kind, (arch, cut) in inp["kinds"].items():
        cfg = dc.replace(get_arch(arch).config, **cut, dtype="float32",
                         param_dtype="float32")
        params = INITS[kind](jax.random.key(2), cfg)[0]
        out[f"{kind}/params"] = jax.tree.map(np.asarray, params)
        batch = {k: jnp.asarray(v) for k, v in inp["batches"][kind].items()}
        for shape in inp["meshes"]:
            mesh = jax.make_mesh(shape, ("data", "model"), axis_types=AUTO)
            ctx = ShardingCtx(make_rules(mesh), mesh)

            # repro/launch/steps.py::_recsys_cell's retrieval_cand body
            def step(params, batch, cand_ids, k):
                if kind == "sasrec":
                    u = R.sasrec_user_repr(params, cfg, batch["seq"], ctx)
                elif kind == "bst":
                    V = params["items"].shape[0]
                    e = R.take_rows(params["items"], batch["seq"][0] % V,
                                    ctx)
                    u = jnp.mean(e, axis=0, keepdims=True).astype(
                        jnp.dtype(cfg.dtype))
                else:
                    tab = params["tables"]
                    e = R.take_rows(tab[0], batch["sparse"][0] %
                                    tab.shape[1], ctx)
                    u = jnp.mean(e, axis=0, keepdims=True).astype(
                        jnp.dtype(cfg.dtype))
                table = params["items"] if kind in ("sasrec", "bst") \\
                    else params["tables"][0]
                cvec = R.take_rows(table, cand_ids % table.shape[0], ctx)
                cvec = ctx(cvec.astype(u.dtype), "candidates", None)
                scores = (u @ cvec.T)[0]
                return jax.lax.top_k(scores, k)

            for q, (cand, (n, k)) in enumerate(zip(inp["cands"],
                                                   inp["queries"])):
                with mesh:
                    v, i = jax.jit(step, static_argnums=3)(
                        params, batch, jnp.asarray(cand), k)
                out[f"{kind}/{shape[0]}x{shape[1]}/{q}"] = (np.asarray(v),
                                                            np.asarray(i))
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_RETRIEVAL_OK")
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
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    inp = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    jx = pickle.load(open(f"{tmp}/jax.pkl", "rb"))
    res = {}
    for kind, (arch, cut) in inp["kinds"].items():
        types = ("float32", "bfloat16") if kind == "dlrm" else ("float32",)
        batch = {k: torch.from_numpy(v)
                 for k, v in inp["batches"][kind].items()}
        for shape in inp["meshes"]:
            mesh = make_mesh(shape, ("data", "model"))
            # tensor parallelism off: the one-process step's bits
            ctx = ShardingCtx(make_rules(mesh, TP_OFF), mesh)
            whole = recsys_params_from_jax(jx[f"{kind}/params"], kind,
                                           device="cpu")
            part = recsys_params_from_jax(jx[f"{kind}/params"], kind,
                                          device="cpu", ctx=ctx)
            for dt in types:
                cfg = dc.replace(get_arch(arch).config, **cut, dtype=dt,
                                 param_dtype="float32")
                for q, (cand, (n, k)) in enumerate(zip(inp["cands"],
                                                       inp["queries"])):
                    cand = torch.from_numpy(cand)
                    res[f"{kind}/{dt}/{shape[0]}x{shape[1]}/{q}"] = (
                        ST.recsys_retrieval_step(whole, cfg, batch, cand, k),
                        ST.recsys_retrieval_step(part, cfg, batch, cand, k,
                                                 ctx))
    torch.save(res, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("retrieval_mesh")
    batches, cands = _inputs(np.random.default_rng(4))
    inp = dict(kinds=KINDS, meshes=MESHES, batches=batches, cands=cands,
               queries=QUERIES)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    assert "JAX_RETRIEVAL_OK" in _run_child(
        JAX_CHILD, str(tmp / "inputs.pkl"), str(tmp / "jax.pkl"))
    _run_ranks(RANK, 4, tmp, timeout=240)
    with open(tmp / "jax.pkl", "rb") as f:
        jx = pickle.load(f)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return inp, jx, ranks


CASES = [(kind, s, q) for kind in KINDS for s in MESHES
         for q in range(len(QUERIES))]
IDS = [f"{k}-{s[0]}x{s[1]}-N{QUERIES[q][0]}k{QUERIES[q][1]}"
       for k, s, q in CASES]


def test_candidates_tie():
    _, cands = _inputs(np.random.default_rng(4))
    ids = np.remainder(cands[0], V)
    assert len(np.unique(ids)) < len(ids)


@pytest.mark.parametrize("kind,shape,q", CASES, ids=IDS)
def test_merged_top_k_is_the_one_process_step_and_jax(runs, kind, shape, q):
    _, jx, ranks = runs
    m = f"{shape[0]}x{shape[1]}"
    jv, ji = jx[f"{kind}/{m}/{q}"]
    n, k = QUERIES[q]
    assert len(ji) == min(n, k)
    for res in ranks:
        (v1, i1), (v2, i2) = res[f"{kind}/float32/{m}/{q}"]
        assert torch.equal(i2, i1) and torch.equal(v2, v1)
        np.testing.assert_array_equal(i2.numpy(), ji)
        np.testing.assert_allclose(v2.numpy(), jv, **F32)
        # ties: equal values come lower index first
        same = v2[1:] == v2[:-1]
        assert bool((i2[1:][same] > i2[:-1][same]).all())
    if n > k:
        assert bool((jv[1:] == jv[:-1]).any())     # the top k holds ties


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bf16_retrieval_under_the_mesh(runs, shape):
    _, _, ranks = runs
    for res in ranks:
        for q in range(len(QUERIES)):
            (v1, i1), (v2, i2) = res[f"dlrm/bfloat16/{shape[0]}x{shape[1]}"
                                     f"/{q}"]
            assert v2.dtype == torch.bfloat16
            assert torch.equal(i2, i1) and torch.equal(v2, v1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dot_scores_in_chunks(monkeypatch, dtype):
    """Scored a few rows at a time, each score is the one-pass row-wise
    sum's bitwise, the candidate rows are left as they were, and equal
    rows tie wherever they stand."""
    from repro_torch.launch import steps
    g = torch.Generator().manual_seed(7)
    u = torch.randn((1, 24), generator=g).to(dtype)
    cvec = torch.randn((50, 24), generator=g).to(dtype)
    cvec[31] = cvec[3]
    kept = cvec.clone()
    whole = (cvec.float() * u.float()).sum(-1).to(dtype)
    monkeypatch.setattr(steps, "SCORE_ROWS", 7)
    got = steps.dot_scores(u, cvec)
    assert got.dtype == dtype and torch.equal(got, whole)
    assert torch.equal(cvec, kept)
    assert got[31] == got[3]


def test_merge_top_k_order():
    """Pairs in any order merge to value descending, the lower index
    first among equal values, as ``top_k`` ranks one array."""
    from repro_torch.launch.steps import merge_top_k, top_k
    scores = torch.tensor([0.5, 2.0, 2.0, -1.0, 2.0, 0.5, 3.0, 0.5])
    perm = torch.tensor([5, 2, 7, 0, 4, 6, 1, 3])
    v, i = merge_top_k(scores[perm], perm, 6)
    wv, wi = top_k(scores, 6)
    assert torch.equal(i, wi) and torch.equal(v, wv)
    assert i.tolist() == [6, 1, 2, 4, 0, 5]
