# Copied verbatim from src/repro/core/moe_schedule.py; keep the two in step.
"""EP-scheduled MoE dispatch (DESIGN.md §3.2) — the paper's model applied to
Mixture-of-Experts routing.

A MoE layer's token→expert routing is a data-affinity problem in exactly the
paper's sense: the *expert weights* are the shared data objects (vertices)
and each routed token is a task touching its top-k experts.  Grouping tokens
so that tokens sharing experts land on the same expert-parallel shard
minimizes the number of (expert, shard) pairs — i.e. the all-to-all /
weight-replication volume — which is the vertex-cut cost `C = Σ_e (p_e − 1)`
with a device's HBM playing the cache role that SM shared memory plays in
the paper.

top-2 routing (jamba) maps to the model literally: one edge per token.  For
top-k > 2 (qwen3-moe top-8, qwen2-moe top-4) a token is a *hyperedge*; we
use the same path decomposition the clone-and-connect transform uses for
vertex incidence lists: the k experts of a token are chained into k−1
pairwise edges.  (This is the standard clique-sparsifier; it preserves the
connectivity objective while keeping m = T·(k−1) linear in tokens.)

Outputs:
  * ``token_shard``  — which expert-parallel shard each token's computation
    is scheduled on (the edge partition).
  * ``expert_shard`` — expert placement: each expert lands on the shard that
    owns the plurality of its tokens (majority vote over incident edges).
  * traffic model    — cross-shard expert fetches under the EP schedule vs
    the default contiguous schedule with round-robin expert placement
    (the analogue of paper Fig. 11's transaction comparison).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .edge_partition import edge_partition
from .graph import EdgeList
from .metrics import evaluate_edge_partition

__all__ = [
    "routing_affinity_graph",
    "MoEDispatchPlan",
    "plan_moe_dispatch",
    "dispatch_traffic",
]


def routing_affinity_graph(expert_ids: np.ndarray, n_experts: int) -> tuple[EdgeList, np.ndarray]:
    """Build the expert-affinity graph from routed ids.

    ``expert_ids`` is (T, k): the top-k expert of each token.  Returns the
    EdgeList (one path of k−1 edges per token; vertices are experts) and the
    (m,) map from edge id back to token id.
    """
    expert_ids = np.asarray(expert_ids, dtype=np.int64)
    if expert_ids.ndim == 1:
        expert_ids = expert_ids[:, None]
    t, k = expert_ids.shape
    if k < 2:
        # top-1: no sharing structure between experts via single tokens; the
        # graph is edgeless — one degenerate self-edge per token keeps the
        # "edge = token" bookkeeping intact (self loops never cost cut).
        u = expert_ids[:, 0]
        return EdgeList(n=n_experts, u=u.copy(), v=u.copy()), np.arange(t)
    u = expert_ids[:, :-1].reshape(-1)
    v = expert_ids[:, 1:].reshape(-1)
    edge_token = np.repeat(np.arange(t), k - 1)
    return EdgeList(n=n_experts, u=u.copy(), v=v.copy()), edge_token


@dataclasses.dataclass(frozen=True)
class MoEDispatchPlan:
    n_experts: int
    n_shards: int
    token_shard: np.ndarray   # (T,) int32 expert-parallel shard per token
    expert_shard: np.ndarray  # (E,) int32 home shard per expert
    ep_cross_fetches: int     # (token, remote-expert) pairs under this plan
    default_cross_fetches: int  # same under contiguous tokens + round-robin experts
    vertex_cut: int           # C of the edge partition (model objective)
    balance: float

    @property
    def traffic_ratio(self) -> float:
        """EP cross-shard fetches / default cross-shard fetches (lower=better)."""
        if self.default_cross_fetches == 0:
            return 1.0 if self.ep_cross_fetches == 0 else float("inf")
        return self.ep_cross_fetches / self.default_cross_fetches


def dispatch_traffic(
    expert_ids: np.ndarray, token_shard: np.ndarray, expert_shard: np.ndarray
) -> int:
    """Cross-shard fetches: routed (token, expert) pairs whose expert does
    not live on the token's shard — each is one all-to-all transfer of a
    token activation (the redundant load of the paper's model)."""
    expert_ids = np.asarray(expert_ids, dtype=np.int64)
    if expert_ids.ndim == 1:
        expert_ids = expert_ids[:, None]
    home = expert_shard[expert_ids]              # (T, k) shard of each routed expert
    return int((home != token_shard[:, None]).sum())


def _majority_expert_placement(
    expert_ids: np.ndarray, token_shard: np.ndarray, n_experts: int, n_shards: int
) -> np.ndarray:
    """expert -> shard owning the plurality of its routed tokens.

    Ties and unrouted experts fall back to balanced round-robin over the
    least-loaded shards (keeps expert counts per shard even, which the
    expert-parallel layout requires: n_experts/n_shards slots per shard).
    """
    expert_ids = np.asarray(expert_ids, dtype=np.int64)
    if expert_ids.ndim == 1:
        expert_ids = expert_ids[:, None]
    t, k = expert_ids.shape
    votes = np.zeros((n_experts, n_shards), dtype=np.int64)
    flat_e = expert_ids.reshape(-1)
    flat_s = np.repeat(token_shard, k)
    np.add.at(votes, (flat_e, flat_s), 1)

    per_shard = n_experts // n_shards
    extra = n_experts % n_shards
    cap = np.full(n_shards, per_shard, dtype=np.int64)
    cap[:extra] += 1

    # Greedy assignment by decreasing vote strength, respecting slot caps —
    # the balance constraint of Definition 2 applied to expert placement.
    expert_shard = np.full(n_experts, -1, dtype=np.int32)
    load = np.zeros(n_shards, dtype=np.int64)
    order = np.argsort(-votes.max(axis=1), kind="stable")
    for e in order:
        pref = np.argsort(-votes[e], kind="stable")
        placed = False
        for s in pref:
            if load[s] < cap[s]:
                expert_shard[e] = s
                load[s] += 1
                placed = True
                break
        if not placed:  # pragma: no cover - caps always sum to n_experts
            s = int(np.argmin(load))
            expert_shard[e] = s
            load[s] += 1
    return expert_shard


def plan_moe_dispatch(
    expert_ids: np.ndarray,
    n_experts: int,
    n_shards: int,
    method: str = "ep",
    seed: int = 0,
) -> MoEDispatchPlan:
    """Schedule tokens + place experts across expert-parallel shards.

    The edge partition groups tokens (tasks) into shards minimizing expert
    replication; expert placement then follows the token majority.  The
    default comparison point is what a framework does with no model:
    contiguous token chunks + round-robin expert placement.
    """
    expert_ids = np.asarray(expert_ids, dtype=np.int64)
    if expert_ids.ndim == 1:
        expert_ids = expert_ids[:, None]
    t, k = expert_ids.shape

    graph, edge_token = routing_affinity_graph(expert_ids, n_experts)
    res = edge_partition(graph, n_shards, method=method, seed=seed)

    # Token shard = shard of its first path edge (all of a token's edges are
    # chained, so the partitioner already pulls them together; using the
    # first is the Definition-4 reconstruction applied per token).
    token_shard = np.empty(t, dtype=np.int32)
    first_edge = np.searchsorted(edge_token, np.arange(t), side="left")
    token_shard[:] = res.labels[first_edge]

    expert_shard = _majority_expert_placement(expert_ids, token_shard, n_experts, n_shards)
    ep_fetches = dispatch_traffic(expert_ids, token_shard, expert_shard)

    # Default: contiguous equal chunks of tokens, round-robin experts.
    chunk = -(-t // n_shards)
    default_token_shard = (np.arange(t) // chunk).astype(np.int32)
    default_expert_shard = (np.arange(n_experts) % n_shards).astype(np.int32)
    default_fetches = dispatch_traffic(expert_ids, default_token_shard, default_expert_shard)

    quality = evaluate_edge_partition(graph, res.labels, n_shards)
    return MoEDispatchPlan(
        n_experts=n_experts,
        n_shards=n_shards,
        token_shard=token_shard,
        expert_shard=expert_shard,
        ep_cross_fetches=ep_fetches,
        default_cross_fetches=default_fetches,
        vertex_cut=quality.vertex_cut,
        balance=quality.balance,
    )
