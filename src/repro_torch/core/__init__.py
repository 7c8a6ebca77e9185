"""``repro_torch/core`` ↔ ``repro/core``: the paper's variational dual-tree
transition-matrix approximation, O(|B|) inference, bandwidth learning,
greedy refinement, label propagation on the VDT, exact and GRF backends, and
the exact / kNN baselines it is compared against."""
from repro_torch.core.baselines import (build_knn_graph,
                                        exact_transition_matrix, knn_matvec,
                                        streaming_exact_matvec)
from repro_torch.core.blocks import (BlockPartition, coarsest_partition,
                                     validate_partition)
from repro_torch.core.convert import vdt_from_numpy
from repro_torch.core.divergence import resolve_divergence
from repro_torch.core.label_prop import (ccr, label_propagate,
                                         one_hot_labels, route_backend)
from repro_torch.core.matvec import mpt_matvec
from repro_torch.core.qopt import QState, optimize_q
from repro_torch.core.refine import refine_to_budget, refinement_gains
from repro_torch.core.sigma import fit_sigma_q, sigma_init, sigma_star
from repro_torch.core.tree import PartitionTree, build_tree
from repro_torch.core.vdt import VariationalDualTree, VdtStats

__all__ = ["BlockPartition", "PartitionTree", "QState", "VariationalDualTree",
           "VdtStats", "build_knn_graph", "build_tree", "ccr",
           "coarsest_partition", "exact_transition_matrix", "fit_sigma_q",
           "knn_matvec", "label_propagate", "mpt_matvec", "one_hot_labels",
           "optimize_q", "refine_to_budget", "refinement_gains",
           "resolve_divergence", "route_backend", "sigma_init", "sigma_star",
           "streaming_exact_matvec", "validate_partition", "vdt_from_numpy"]
