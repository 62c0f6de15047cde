"""The cells (``launch/steps.py::build_cell``, ``all_cells``) and the dry
run (``launch/dryrun.py``) against the reference's cells:

  * one module-scoped child with 512 host devices (``XLA_FLAGS`` set
    before its first JAX import, as ``repro/launch/dryrun.py`` does)
    builds every reference cell at the production meshes (16, 16) and
    (2, 16, 16) and writes each cell's ``model_flops``, the shard shape
    (``NamedSharding.shard_shape``) and item size of every parameter
    leaf, and the shapes of its batch leaves;
  * ``all_cells()`` is the reference's less the four ``equiformer-v2``
    cells; every ``model_flops`` is equal;
  * every parameter's shard on an ``AbstractMesh`` at the first and the
    last rank's coordinates has the reference's shard shape (a layer's
    leaf against the stacked leaf's shard less its leading dim, a linear
    weight reversed: the port holds it (d_out, d_in));
  * the dry run's parameter bytes are the reference shards' bytes; it
    runs with no process group, allocates on ``meta`` only and writes
    only where it is told;
  * the whole batches the port's train steps take (recsys, rankgraph2's
    ``dedup`` packs) have the reference's global shapes;
  * the rankgraph2 ``train_batch`` cell at a cut config on a (2, 2)
    gloo CPU mesh, materialised from a seed, gives bitwise the losses
    and parameters of ``make_train_step(cfg, opt, ctx)`` on the same
    state, batch and draws; its ``retrieval_cand`` cell, each rank on its
    block of 1,000,000 candidates, gives bitwise the one-process top 100.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import trainer as T
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.steps import all_cells, build_cell
from repro_torch.models.lm import model as LM
from repro_torch.models.recsys import models as R

from test_torch_dp_train import _run_ranks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"singlepod": False, "multipod": True}
CELLS = all_cells()

JAX_CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, numpy as np
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_cell, all_cells

    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def leaves(tree):
        return jax.tree_util.tree_flatten_with_path(tree)[0]

    out = {"cells": [list(c) for c in all_cells()], "meshes": {}}
    for tag, multi in (("singlepod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi)
        recs = {}
        for a, s in all_cells():
            if a == "equiformer-v2":
                continue
            cell = build_cell(a, s, mesh)
            args, shs = cell.args, cell.in_shardings
            if a == "rankgraph2" and s == "train_batch":
                params, pshard, batch = args[0].params, shs[0].params, args[1]
            elif a == "rankgraph2" and s == "retrieval_cand":
                params, pshard, batch = {}, {}, args
            else:
                params, pshard = args[0], shs[0]
                batch = args[2] if s.startswith("train") else args[1:]
            recs[f"{a}/{s}"] = dict(
                flops=float(cell.model_flops),
                params={name(p): [list(l.shape),
                                  list(sh.shard_shape(l.shape)),
                                  np.dtype(l.dtype).itemsize]
                        for (p, l), sh in zip(leaves(params),
                                              jax.tree.leaves(pshard))},
                batch={name(p): list(l.shape) for p, l in leaves(batch)})
        out["meshes"][tag] = recs
    json.dump(out, open(sys.argv[1], "w"))
    print("JAX_CELLS_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "ref.json"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_CHILD, str(path)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "JAX_CELLS_OK" in r.stdout, \
        (r.stdout[-2000:], r.stderr[-3000:])
    return json.loads(path.read_text())


def _last(multi):
    return (1, 15, 15) if multi else (15, 15)


def _port_params(cell):
    """name -> a rank's shard of every parameter, in the reference's
    naming (``.w``/``.b`` for the encoders' linear layers)."""
    params = cell.parts.get("params")
    if params is None:
        return {}
    family = get_arch(cell.arch_id).family
    if family == "lm":
        return LM.named_params(params)
    if family == "recsys":
        return R.flatten_params(params)
    return {re.sub(r"\.weight$", ".w", re.sub(r"\.bias$", ".b", k)): v
            for k, v in T.named_params(params).items()}


def _reversed(family, name):
    """Whether the port holds leaf ``name`` transposed: a linear weight
    (d_out, d_in)."""
    if family == "recsys":
        return R._linear_w(name)
    return family == "rankgraph2" and re.search(r"\.l[12]\.w$", name)


def test_all_cells_are_the_reference_s_less_equiformer(ref):
    want = [tuple(c) for c in ref["cells"]]
    assert len(want) == 44
    assert CELLS == [c for c in want if c[0] != "equiformer-v2"]
    assert len(CELLS) == 40
    assert sorted({a for a, _ in want} - {a for a, _ in CELLS}) == \
        ["equiformer-v2"]


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_model_flops_equal(ref, arch_id, shape):
    for tag, multi in MESHES.items():
        cell = build_cell(arch_id, shape, abstract_production_mesh(multi))
        assert cell.model_flops == ref["meshes"][tag][
            f"{arch_id}/{shape}"]["flops"], tag


@pytest.mark.parametrize("arch_id,shape", CELLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_parameter_shards_equal(ref, mesh, arch_id, shape):
    multi = MESHES[mesh]
    want = ref["meshes"][mesh][f"{arch_id}/{shape}"]["params"]
    family = get_arch(arch_id).family
    for coords in (None, _last(multi)):
        cell = build_cell(arch_id, shape,
                          abstract_production_mesh(multi, coords))
        got = _port_params(cell)
        seen = set()
        for name, t in got.items():
            shard = list(t.shape)[::-1] if _reversed(family, name) \
                else list(t.shape)
            m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
            if family == "lm" and m and f"layers.{m[2]}" in want:
                key, drop = f"layers.{m[2]}", True     # stacked layers
            else:
                key, drop = name, False
            assert key in want, (mesh, coords, name)
            _, ref_shard, itemsize = want[key]
            assert shard == ref_shard[1:] if drop else shard == ref_shard, \
                (mesh, coords, name, shard, ref_shard)
            assert t.element_size() == itemsize, (name, t.dtype)
            assert t.device.type == "meta"
            seen.add(key)
        assert seen == set(want), (mesh, sorted(set(want) - seen))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_parameter_bytes_equal(ref, mesh):
    recs = dryrun.run(CELLS, [mesh])
    assert len(recs) == len(CELLS)
    for r in recs:
        want = ref["meshes"][mesh][f"{r['arch']}/{r['shape']}"]
        total = sum(int(np.prod(shard)) * itemsize
                    for _, shard, itemsize in want["params"].values())
        assert r["bytes"]["params"] == total, (mesh, r["arch"], r["shape"])
        assert r["model_flops"] == want["flops"]
        assert "not reported" in r["xla_analyses"]


def test_dryrun_cli_runs_without_a_process_group(tmp_path, capsys):
    """``--list`` names the 40 cells; ``--mesh both --out`` writes a
    header and 80 records where it is told, nothing under
    ``benchmarks/``, and makes no process group."""
    import torch.distributed as dist
    bench = os.path.join(REPO, "benchmarks")
    before = sorted(os.walk(bench)) if os.path.isdir(bench) else None
    assert dryrun.main(["--list"]) == 0
    listed = capsys.readouterr().out.split("\n")
    assert [tuple(l.split()) for l in listed if l] == CELLS
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--mesh", "both", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 2 * len(CELLS)
    head = json.loads(lines[0])
    assert "not reported" in head["xla_analyses"]
    rec = [json.loads(l) for l in lines[1:]]
    assert {r["mesh"] for r in rec} == set(MESHES)
    assert all(r["bytes"]["total"] > 0 for r in rec)
    assert not dist.is_initialized()
    after = sorted(os.walk(bench)) if os.path.isdir(bench) else None
    assert before == after
    with pytest.raises(RuntimeError, match="no process groups"):
        build_cell("olmo-1b", "train_4k",
                   abstract_production_mesh()).ctx.group("model")


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "wide-deep", "sasrec", "bst",
                                     "rankgraph2"])
def test_whole_train_batches_are_the_reference_s(ref, arch_id):
    """Every rank passes the whole batch to the port's train steps: its
    leaves have the reference's global shapes (rankgraph2's packs sized
    by the reference's ``E`` and ``U``)."""
    for mesh, multi in MESHES.items():
        cell = build_cell(arch_id, "train_batch",
                          abstract_production_mesh(multi))
        want = ref["meshes"][mesh][f"{arch_id}/train_batch"]["batch"]

        def flat(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                key = f"{prefix}.{k}" if prefix else k
                out.update(flat(v, key) if isinstance(v, dict)
                           else {key: list(v.shape)})
            return out
        assert flat(cell.parts["batch"]) == want, (arch_id, mesh)


CUT = dict(d_user_feat=16, d_item_feat=16, d_embed=8, n_heads=2,
           d_hidden=16, k_train=3, n_negatives=8, n_pool_neg=2,
           dtype="float32")

RANK = textwrap.dedent("""
    import sys, dataclasses as dc, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import RankGraph2Config, RQConfig, get_arch
    from repro_torch.core import negatives as N
    from repro_torch.core import trainer as T
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.optim import optimizers as O
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"))
    cut = RankGraph2Config(**%r, rq=RQConfig(codebook_sizes=(8, 4),
                                             hist_len=8))
    cell = S.build_cell("rankgraph2", "train_batch", mesh, cfg=cut)
    ctx = cell.ctx

    def state():
        st, _ = T.init_state(cut, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        return T.shard_state(st, cut, ctx)
    a, b = state(), state()
    meta = T.named_params(cell.args[0].params)
    shapes_ok = all(meta[k].shape == v.shape
                    for k, v in T.named_params(a.params).items())
    B = get_arch("rankgraph2").shape("train_batch").dims["batch"] // 3
    batch = S.rankgraph2_train_batch(
        cut, B, device="cpu", generator=torch.Generator().manual_seed(1))
    same_shapes = all(
        batch[g][k][f].shape == cell.args[1][g][k][f].shape
        for g in batch for k in batch[g] for f in batch[g][k])
    g = torch.Generator().manual_seed(2)
    dp = ctx.axis_size("batch")
    draws = {key: N.negative_draws(
        B, cut.n_heads, cut.n_negatives, cut.n_pool_neg, 0, generator=g,
        shard_block=N.shard_block_for(B, dp))
        for key in T.draw_keys(cut, batch)}
    a, ma = cell.fn(a, batch, draws=draws)
    b, mb = T.make_train_step(cut, O.rankgraph2_optimizer(), ctx)(
        b, batch, draws=draws)
    # the knn retrieval cell: this rank's block of the candidates against
    # the one-process top k of the whole pool
    knn = S.build_cell("rankgraph2", "retrieval_cand", mesh, cfg=cut)
    n = get_arch("rankgraph2").shape("retrieval_cand").dims["n_candidates"]
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, cut.d_embed), generator=g)
    pool = torch.randn((n, cut.d_embed), generator=g)
    axes = knn.ctx.mesh_axes("candidates")
    blk = S.C.block_rows(n, knn.ctx.size(axes), knn.ctx.axis_index(axes))
    got = knn.fn(q, pool[blk])
    want = S.top_k(S.dot_scores(q, pool), 100)
    torch.save(dict(ma=ma, mb=mb, shapes_ok=shapes_ok, same=same_shapes,
                    pa=T.named_params(a.params), pb=T.named_params(b.params),
                    knn_rows=knn.args[1].shape[0] == blk.stop - blk.start,
                    knn=[torch.equal(x, y) for x, y in zip(got, want)]),
               f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def test_rankgraph2_cell_step_on_a_cpu_mesh(tmp_path):
    _run_ranks(RANK % (CUT,), 4, tmp_path, timeout=300)
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["shapes_ok"] and res["same"], r
        assert set(res["ma"]) == set(res["mb"])
        for k in res["ma"]:
            assert torch.isfinite(res["ma"][k]), (r, k)
            assert torch.equal(res["ma"][k], res["mb"][k]), (r, k)
        for k in res["pa"]:
            assert torch.equal(res["pa"][k], res["pb"][k]), (r, k)
        assert res["knn_rows"] and res["knn"] == [True, True], r
