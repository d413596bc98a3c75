"""Host-side partitioner, plan service and replication of the port (numpy only).

Every module here is a copy of the module of the same name in
``src/repro/core/`` (one header line names it), so the port imports nothing
of the JAX package.  Only what the EP-SpMV serving slices use is exported:
the partitioner, the plan service, the replicated plan service
(``replica``) and its cross-process transport (``transport``); hierarchy,
MoE scheduling and the overhead model come with later slices.
"""
from .edge_partition import EdgePartitionResult, edge_partition
from .graph import (
    CSRGraph,
    EdgeList,
    affinity_graph_from_coo,
    csr_from_edges,
    synthetic_bipartite_graph,
    synthetic_mesh_graph,
    synthetic_random_graph,
)
from .partition import MultilevelOptions
from .partition_service import (
    AdmissionRejectedError,
    DeadlineShedError,
    DoubleBuffer,
    PartitionService,
    PlanPadding,
    PlanTicket,
    ServiceClosedError,
    ServiceMetrics,
    ServicePlan,
    ServiceStats,
    graph_fingerprint,
)
from .replica import (
    FaultInjector,
    ReplicaExhaustedError,
    ReplicaGroup,
    ReplicaMetrics,
    ReplicaStats,
    ReplicaTicket,
)
from .reorder import PackPlan, build_pack_plan
from .transport import (
    DeadlineExceeded,
    PlanServer,
    ProtocolError,
    RemoteReplica,
    ReplicaConnection,
    WireError,
)

__all__ = [
    "AdmissionRejectedError",
    "CSRGraph",
    "DeadlineExceeded",
    "DeadlineShedError",
    "DoubleBuffer",
    "EdgeList",
    "EdgePartitionResult",
    "FaultInjector",
    "MultilevelOptions",
    "PackPlan",
    "PartitionService",
    "PlanPadding",
    "PlanServer",
    "PlanTicket",
    "ProtocolError",
    "RemoteReplica",
    "ReplicaConnection",
    "ReplicaExhaustedError",
    "ReplicaGroup",
    "ReplicaMetrics",
    "ReplicaStats",
    "ReplicaTicket",
    "ServiceClosedError",
    "ServiceMetrics",
    "ServicePlan",
    "ServiceStats",
    "WireError",
    "affinity_graph_from_coo",
    "build_pack_plan",
    "csr_from_edges",
    "edge_partition",
    "graph_fingerprint",
    "synthetic_bipartite_graph",
    "synthetic_mesh_graph",
    "synthetic_random_graph",
]
