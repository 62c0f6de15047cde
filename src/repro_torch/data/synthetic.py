"""Synthetic engagement corpus with planted latent-interest structure, a
numpy copy of ``repro/data/synthetic.py`` (same draws, bit for bit).

Public benchmarks are orders of magnitude below the paper's scale (their
§5.1 argument), and the raw logs are proprietary — so offline evaluation
here uses a generative world model whose ground truth we control:

  * T latent topics; each user/item has a mixture over topics;
  * engagement probability ∝ exp(z_u · z_i / temp) with a popularity
    boost for head items (Zipf), which is exactly the bias Eq. 3 corrects;
  * day-N events are the training window, day-(N+1) events are the
    held-out future engagements used for Recall@K (paper §5.2 protocol);
  * node features are noisy linear views of the latents (inductive
    setting: the model must *learn* the structure from features+graph).

This makes the paper's qualitative claims testable at CPU scale.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.graph_builder import EngagementLog


@dataclasses.dataclass
class SyntheticWorld:
    user_latent: np.ndarray     # (n_users, T)
    item_latent: np.ndarray     # (n_items, T)
    user_feat: np.ndarray       # (n_users, d_uf)
    item_feat: np.ndarray       # (n_items, d_if)
    item_pop: np.ndarray        # (n_items,) popularity boost
    day0: EngagementLog         # training window (24h)
    day1: EngagementLog         # next-day eval window

    @property
    def n_users(self) -> int:
        return len(self.user_latent)

    @property
    def n_items(self) -> int:
        return len(self.item_latent)


def make_world(n_users: int = 2000, n_items: int = 3000, *,
               n_topics: int = 16, d_user_feat: int = 64,
               d_item_feat: int = 64, events_per_user: float = 30.0,
               pop_zipf: float = 1.1, pop_strength: float = 1.0,
               feat_noise: float = 0.3, temp: float = 0.25,
               noise_frac: float = 0.0,
               seed: int = 0) -> SyntheticWorld:
    """``noise_frac``: fraction of events drawn uniformly at random —
    spurious engagements that create noisy co-engagement ties (the
    regime where multi-hop PPR consensus beats 1-hop sampling)."""
    rng = np.random.default_rng(seed)
    T = n_topics
    # sparse-ish topic mixtures
    zu = rng.dirichlet(np.full(T, 0.3), n_users).astype(np.float32)
    zi = rng.dirichlet(np.full(T, 0.3), n_items).astype(np.float32)
    zu /= np.linalg.norm(zu, axis=1, keepdims=True)
    zi /= np.linalg.norm(zi, axis=1, keepdims=True)
    # Zipf popularity boost (head items accumulate co-engagement that
    # reflects popularity, not interest -> the Eq.3 target)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = (1.0 / ranks ** pop_zipf)
    pop = pop[rng.permutation(n_items)]
    pop = (pop / pop.mean()).astype(np.float32)

    # noisy feature views (inductive signal)
    pu = rng.normal(0, 1, (T, d_user_feat)).astype(np.float32)
    pi = rng.normal(0, 1, (T, d_item_feat)).astype(np.float32)
    uf = zu @ pu + feat_noise * rng.normal(0, 1, (n_users, d_user_feat)
                                           ).astype(np.float32)
    itf = zi @ pi + feat_noise * rng.normal(0, 1, (n_items, d_item_feat)
                                            ).astype(np.float32)

    def sample_day(day: int, ts0: float) -> EngagementLog:
        # legacy arithmetic key, kept so the stream equals the JAX package's
        r = np.random.default_rng(seed + 1000 + day)
        n_ev = int(n_users * events_per_user)
        users = r.integers(0, n_users, n_ev)
        # score = affinity + popularity boost; Gumbel-max sampling over a
        # candidate subset (keeps this O(n_ev * C))
        C = min(256, n_items)
        cand = r.integers(0, n_items, (n_ev, C))
        aff = np.einsum("et,ect->ec", zu[users],
                        zi[cand]) / temp
        score = aff + pop_strength * np.log(pop[cand] + 1e-6) * 0.8
        g = r.gumbel(0, 1, score.shape)
        items = cand[np.arange(n_ev), np.argmax(score + g, axis=1)]
        if noise_frac > 0:
            spurious = r.random(n_ev) < noise_frac
            items = np.where(spurious, r.integers(0, n_items, n_ev), items)
        etype = r.choice(4, n_ev, p=[0.7, 0.15, 0.1, 0.05]).astype(np.int32)
        ts = ts0 + r.random(n_ev) * 86400.0
        return EngagementLog(users.astype(np.int64), items.astype(np.int64),
                             etype, ts, n_users, n_items)

    return SyntheticWorld(zu, zi, uf, itf, pop,
                          day0=sample_day(0, 0.0),
                          day1=sample_day(1, 86400.0))


def next_day_ground_truth(world: SyntheticWorld) -> Tuple[np.ndarray, ...]:
    """(user -> set of day-1 items) as a CSR-ish pair for recall eval."""
    order = np.argsort(world.day1.user_id, kind="stable")
    u = world.day1.user_id[order]
    it = world.day1.item_id[order]
    starts = np.searchsorted(u, np.arange(world.n_users))
    ends = np.searchsorted(u, np.arange(world.n_users) + 1)
    return u, it, starts, ends
