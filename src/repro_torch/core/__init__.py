"""``repro_torch/core`` ↔ ``repro/core``: the paper's variational dual-tree
transition-matrix approximation under any registered Bregman divergence,
O(|B|) inference, bandwidth learning, greedy refinement, streaming
insert/delete, label propagation on the VDT, exact and GRF backends, and the
exact / kNN baselines it is compared against."""
from repro_torch.core.baselines import (build_knn_graph,
                                        exact_transition_matrix, knn_matvec,
                                        streaming_exact_matvec)
from repro_torch.core.blocks import (BlockPartition, coarsest_partition,
                                     complete_forest, refresh_active,
                                     validate_partition)
from repro_torch.core.convert import vdt_from_numpy
from repro_torch.core.divergence import (DIVERGENCES, Divergence,
                                         get_divergence, mahalanobis,
                                         register_divergence,
                                         resolve_divergence)
from repro_torch.core.label_prop import (ccr, label_propagate,
                                         one_hot_labels, route_backend)
from repro_torch.core.matvec import mpt_matvec
from repro_torch.core.qopt import QState, optimize_q
from repro_torch.core.refine import refine_to_budget, refinement_gains
from repro_torch.core.sigma import fit_sigma_q, sigma_init, sigma_star
from repro_torch.core.streaming import (CapacityError, StreamUpdate,
                                        delete_points, insert_points)
from repro_torch.core.tree import PartitionTree, build_tree
from repro_torch.core.vdt import VariationalDualTree, VdtStats

__all__ = ["BlockPartition", "CapacityError", "DIVERGENCES", "Divergence",
           "PartitionTree", "QState", "StreamUpdate", "VariationalDualTree",
           "VdtStats", "build_knn_graph", "build_tree", "ccr",
           "coarsest_partition", "complete_forest", "delete_points",
           "exact_transition_matrix", "fit_sigma_q", "get_divergence",
           "insert_points", "knn_matvec", "label_propagate", "mahalanobis",
           "mpt_matvec", "one_hot_labels", "optimize_q", "refine_to_budget",
           "refinement_gains", "refresh_active", "register_divergence",
           "resolve_divergence", "route_backend", "sigma_init", "sigma_star",
           "streaming_exact_matvec", "validate_partition", "vdt_from_numpy"]
