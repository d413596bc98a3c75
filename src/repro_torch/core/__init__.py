"""Host-side partitioner, plan services, replication and the overhead model of the port.

Numpy and the standard library only: every module here is a copy of the
module of the same name in ``src/repro/core/`` (one header line names it),
so the port imports nothing of the JAX package, and this package exports
the same names as ``repro.core``: the EP model (data-affinity graphs,
clone-and-connect + multilevel partitioning, the baselines, the cpack
layout), the hierarchical partition, MoE dispatch scheduling, the adaptive
overhead controller (paper §4.2), the plan service with its cache and
scheduler, and the replicated plan service with its cross-process
transport.  Nothing here imports torch.
"""
from .baselines import (
    default_schedule,
    greedy_powergraph,
    hypergraph_partition,
    random_partition,
)
from .coarsen import ClusterCoarsener, LevelStats, contract_clusters
from .edge_partition import EdgePartitionResult, edge_partition
from .hierarchy import HierarchicalPartition, hierarchical_edge_partition
from .moe_schedule import (
    MoEDispatchPlan,
    dispatch_traffic,
    plan_moe_dispatch,
    routing_affinity_graph,
)
from .graph import (
    CSRGraph,
    EdgeList,
    affinity_graph_from_coo,
    csr_from_edges,
    synthetic_banded_graph,
    synthetic_bipartite_graph,
    synthetic_mesh_graph,
    synthetic_powerlaw_graph,
    synthetic_random_graph,
)
from .metrics import (
    PartitionQuality,
    edge_balance_factor,
    evaluate_edge_partition,
    parts_per_vertex,
    redundant_load_fraction,
    replication_factor,
    vertex_cut_cost,
)
from .overhead import AdaptiveScheduler
from .partition import (
    LocalVcycleStats,
    MultilevelOptions,
    PartitionStats,
    local_partition_vertices,
    partition_vertices,
)
from .partition_service import (
    AdmissionRejectedError,
    DeadlineShedError,
    DoubleBuffer,
    GearPolicy,
    IncrementalStats,
    PartitionService,
    PlanCache,
    PlanCancelledError,
    PlanPadding,
    PlanScheduler,
    PlanTicket,
    ServiceClosedError,
    ServiceMetrics,
    ServicePlan,
    ServiceStats,
    TenantCacheStats,
    graph_fingerprint,
    incremental_repartition,
    incremental_repartition_reference,
    local_repartition,
)
from .replica import (
    FaultInjector,
    ReplicaExhaustedError,
    ReplicaGroup,
    ReplicaMetrics,
    ReplicaStats,
    ReplicaTicket,
)
from .reorder import PackPlan, build_pack_plan, build_pack_plan_reference, cpack_order
from .transport import (
    DeadlineExceeded,
    PlanServer,
    ProtocolError,
    RemoteReplica,
    ReplicaConnection,
    WireError,
)
from .transform import (
    ClonedGraph,
    clone_and_connect,
    contracted_clone_graph,
    reconstruct_edge_partition,
)

__all__ = [
    "AdaptiveScheduler",
    "AdmissionRejectedError",
    "CSRGraph",
    "ClonedGraph",
    "ClusterCoarsener",
    "DeadlineExceeded",
    "DeadlineShedError",
    "DoubleBuffer",
    "EdgeList",
    "EdgePartitionResult",
    "FaultInjector",
    "GearPolicy",
    "HierarchicalPartition",
    "IncrementalStats",
    "LevelStats",
    "LocalVcycleStats",
    "MoEDispatchPlan",
    "MultilevelOptions",
    "PackPlan",
    "PartitionQuality",
    "PartitionService",
    "PartitionStats",
    "PlanCache",
    "PlanCancelledError",
    "PlanPadding",
    "PlanScheduler",
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
    "WireError",
    "ServiceMetrics",
    "ServicePlan",
    "ServiceStats",
    "TenantCacheStats",
    "affinity_graph_from_coo",
    "build_pack_plan",
    "build_pack_plan_reference",
    "clone_and_connect",
    "contract_clusters",
    "contracted_clone_graph",
    "cpack_order",
    "csr_from_edges",
    "default_schedule",
    "dispatch_traffic",
    "edge_balance_factor",
    "edge_partition",
    "hierarchical_edge_partition",
    "plan_moe_dispatch",
    "routing_affinity_graph",
    "evaluate_edge_partition",
    "graph_fingerprint",
    "greedy_powergraph",
    "hypergraph_partition",
    "incremental_repartition",
    "incremental_repartition_reference",
    "local_partition_vertices",
    "local_repartition",
    "parts_per_vertex",
    "partition_vertices",
    "random_partition",
    "reconstruct_edge_partition",
    "redundant_load_fraction",
    "replication_factor",
    "synthetic_banded_graph",
    "synthetic_bipartite_graph",
    "synthetic_mesh_graph",
    "synthetic_powerlaw_graph",
    "synthetic_random_graph",
    "vertex_cut_cost",
]
