"""End-to-end RankGraph-2 pipeline: log -> graph -> PPR -> train -> embed,
as ``repro/core/pipeline.py``.

The graph is built on the host, exactly as in the JAX package; the
padded adjacency, the neighbour tables, the feature tables and the train
state go to ``device`` (CUDA unless given ``"cpu"``), where the PPR walk
(``ppr_walk`` kernel), the train steps (``fused_contrastive`` kernels)
and the final RQ assignment (``rq_assign`` kernel) run.  Stage times are
host-clock seconds taken after a device sync.

    edge_types         subset of ("uu", "ui", "ii")          (Table 5)
    neighbor_strategy  "ppr" | "topweight" | "random"        (Table 6)
    popbias            Eq. 3 correction on/off               (Table 7)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core import graph_builder as GB
from repro_torch.core import model as M
from repro_torch.core import trainer as T
from repro_torch.core.rq_index import assign_codes
from repro_torch.data.edge_dataset import (EdgeDataset, NeighborTables,
                                           build_neighbor_tables)
from repro_torch.data.synthetic import SyntheticWorld
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class PipelineResult:
    user_emb: torch.Tensor          # (n_users, d) cfg.dtype, on the device
    item_emb: torch.Tensor
    user_codes: torch.Tensor        # (n_users,) int64 flat cluster ids
    state: T.TrainState
    cfg: RankGraph2Config
    graph: GB.HeteroGraph
    tables: NeighborTables
    metrics: Dict[str, float]       # the last step's
    seconds: Dict[str, float]
    history: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)       # every step's metrics


def _strip_edge_types(g: GB.HeteroGraph, keep: Sequence[str]
                      ) -> GB.HeteroGraph:
    empty = GB.EdgeSet(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0, np.float32))
    return GB.HeteroGraph(
        g.n_users, g.n_items,
        ui=g.ui if "ui" in keep else empty,
        uu=g.uu if "uu" in keep else empty,
        ii=g.ii if "ii" in keep else empty,
        group1_users=g.group1_users, group1_items=g.group1_items,
        build_seconds=g.build_seconds)


def _fallback_tables(g: GB.HeteroGraph, k_imp: int, strategy: str,
                     seed: int) -> NeighborTables:
    """Table 6 alternatives: per-node neighbors by random sampling or
    top edge weight (single hop), in PPR-table format."""
    rng = np.random.default_rng(seed)
    nu, ni = g.n_users, g.n_items
    n = nu + ni
    user_nbrs = np.full((n, k_imp), -1, np.int64)
    item_nbrs = np.full((n, k_imp), -1, np.int64)

    def fill(edges, src_off, dst_off, table):
        if len(edges) == 0:
            return
        if strategy == "topweight":
            nbrs, _ = GB.padded_adjacency(edges, (nu if src_off == 0 else ni),
                                          k_imp)
            rows = np.flatnonzero((nbrs >= 0).any(axis=1))
            table[rows + src_off] = np.where(nbrs[rows] >= 0,
                                             nbrs[rows] + dst_off, -1)
        else:  # random: uniform neighbors among all edges of the node
            order = np.argsort(edges.src, kind="stable")
            s, d = edges.src[order], edges.dst[order]
            starts = np.searchsorted(s, np.arange(
                nu if src_off == 0 else ni))
            ends = np.searchsorted(s, np.arange(
                nu if src_off == 0 else ni) + 1)
            deg = ends - starts
            rows = np.flatnonzero(deg > 0)
            pick = (rng.random((len(rows), k_imp))
                    * deg[rows][:, None]).astype(np.int64)
            table[rows + src_off] = d[starts[rows][:, None] + pick] + dst_off

    fill(g.uu, 0, 0, user_nbrs)
    fill(g.ui, 0, nu, item_nbrs)
    iu = GB.EdgeSet(g.ui.dst, g.ui.src, g.ui.weight)
    fill(iu, nu, 0, user_nbrs)
    fill(g.ii, nu, nu, item_nbrs)
    return NeighborTables(user_nbrs, item_nbrs, nu, ni)


def run_pipeline(world: SyntheticWorld, cfg: RankGraph2Config, *,
                 edge_types: Sequence[str] = ("uu", "ui", "ii"),
                 neighbor_strategy: str = "ppr",
                 popbias: bool = True,
                 steps: int = 300,
                 batch_per_type: int = 128,
                 pool_size: int = 2048,
                 seed: int = 0,
                 ppr_backend: str = "device",
                 device=None) -> PipelineResult:
    """Construct, walk, train ``steps`` steps and embed every node.
    Batch t is the dataset's batch (seed, t); its negatives come from a
    ``torch.Generator`` on the device seeded ``1000 + t``; the initial
    parameters from one seeded ``seed``."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times: Dict[str, float] = {}

    t0 = time.perf_counter()
    g = GB.build_graph(world.day0, alpha_pop=cfg.alpha_pop if popbias
                       else 0.0, c_u=cfg.c_u, c_i=cfg.c_i,
                       k_cap=cfg.k_cap, seed=seed)
    g = _strip_edge_types(g, edge_types)
    times["construct"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if neighbor_strategy == "ppr":
        tables = build_neighbor_tables(
            g, k_imp=cfg.k_imp, n_walks=cfg.ppr_walks,
            walk_len=cfg.ppr_len, restart=cfg.ppr_restart, seed=seed,
            backend=ppr_backend, device=dev)
    else:
        tables = _fallback_tables(g, cfg.k_imp, neighbor_strategy, seed)
    sync()
    times["ppr"] = time.perf_counter() - t0

    # id-only batches: features live on the device and the step gathers
    # them; the host ships ids + masks only
    ds = EdgeDataset(tables, world.user_feat, world.item_feat,
                     k_train=cfg.k_train, device=dev, g=g)
    state, optimizer = T.init_state(
        cfg, generator=torch.Generator().manual_seed(seed),
        pool_size=pool_size, device=dev)
    step_fn = T.make_train_step(
        cfg, optimizer, features=T.FeatureStore(ds.user_feat, ds.item_feat))

    per_type = {et: batch_per_type for et in ("uu", "ui", "ii")
                if et in edge_types or et == "ui"}
    t0 = time.perf_counter()
    history = []
    for t in range(steps):
        batch = ds.sample_batch(t, seed, per_type)
        gen = torch.Generator(dev).manual_seed(1000 + t)
        state, m = step_fn(state, batch, generator=gen)
        history.append(m)
    sync()
    times["train"] = time.perf_counter() - t0
    history = [{k: float(v) for k, v in m.items()} for m in history]
    metrics = history[-1] if history else {}

    t0 = time.perf_counter()
    nu = g.n_users
    user_emb = T.embed_all(state.params, cfg, ds, node_type=M.USER,
                           ids=np.arange(nu), batch=2048)
    item_emb = T.embed_all(state.params, cfg, ds, node_type=M.ITEM,
                           ids=np.arange(nu, nu + g.n_items), batch=2048)
    with torch.no_grad():
        codes = assign_codes(state.params["rq"], user_emb, cfg.rq)
    sync()
    times["embed"] = time.perf_counter() - t0

    return PipelineResult(user_emb, item_emb, codes, state, cfg, g, tables,
                          metrics, times, history)
