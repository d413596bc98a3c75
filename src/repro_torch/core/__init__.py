"""Host-side partitioner and plan service of the port (numpy only).

Every module here is a copy of the module of the same name in
``src/repro/core/`` (one header line names it), so the port imports nothing
of the JAX package.  Only what the EP-SpMV serving slice uses is exported;
replicas, transport, hierarchy, MoE scheduling and the overhead model come
with later slices.
"""
from .edge_partition import EdgePartitionResult, edge_partition
from .graph import (
    CSRGraph,
    EdgeList,
    affinity_graph_from_coo,
    csr_from_edges,
    synthetic_bipartite_graph,
)
from .partition import MultilevelOptions
from .partition_service import (
    AdmissionRejectedError,
    DoubleBuffer,
    PartitionService,
    PlanPadding,
    PlanTicket,
    ServicePlan,
    graph_fingerprint,
)
from .reorder import PackPlan, build_pack_plan

__all__ = [
    "AdmissionRejectedError",
    "CSRGraph",
    "DoubleBuffer",
    "EdgeList",
    "EdgePartitionResult",
    "MultilevelOptions",
    "PackPlan",
    "PartitionService",
    "PlanPadding",
    "PlanTicket",
    "ServicePlan",
    "affinity_graph_from_coo",
    "build_pack_plan",
    "csr_from_edges",
    "edge_partition",
    "graph_fingerprint",
    "synthetic_bipartite_graph",
]
