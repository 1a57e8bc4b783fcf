"""Computational-graph IR: the universal intermediate representation.

Host-side symbolic DAG (generation/optimization/AD) lowered to array form
for batched TPU evaluation by ``feynmandiagram_tpu_torch.ops``.
"""
from .operators import (Op, SUM, PROD, UNITARY, Power, decrement_power,
                        unary_istrivial, isassociative)
from .graph import (Graph, uid, uid_reset, constant_graph, linear_combination,
                    multi_product, isequiv)
from .eval import eval_graph, eval_graphs, apply_op
from .tree_properties import (haschildren, onechild, isleaf, isbranch, ischain,
                              eldest, has_zero_subfactors, count_leaves,
                              count_operation, count_expanded_operation)
from .transform import (replace_subgraph, replace_subgraph_inplace,
                        open_parenthesis, open_parenthesis_inplace,
                        flatten_prod, flatten_prod_inplace,
                        flatten_sum, flatten_sum_inplace,
                        flatten_chains, flatten_chains_inplace,
                        remove_zero_valued_subgraphs, remove_zero_valued_subgraphs_inplace,
                        merge_linear_combination, merge_linear_combination_inplace,
                        merge_multi_product, merge_multi_product_inplace)
from .optimize import (optimize, optimize_inplace,
                       flatten_all_chains_inplace, merge_all_linear_combinations_inplace,
                       merge_all_multi_products_inplace, remove_all_zero_valued_subgraphs_inplace,
                       remove_duplicated_leaves_inplace, remove_duplicated_nodes_inplace,
                       unique_nodes, burn_from_targetleaves_inplace, structural_key)
from .operation import (forward_ad, back_ad, node_derivative, all_parent,
                        build_all_leaf_derivative, forward_ad_root,
                        build_derivative_graph, linear_combination_number_with_graph)
from .io import stringrep, show_tree, plot_tree, plot_tree_graphical
from .common_config import set_datatype, get_datatype
from .feynman_graph import (FeynmanGraph, FeynmanProperties, DiagramType,
                            feynman_diagram, propagator, interaction, external_vertex,
                            group_by_external, relabel, relabel_inplace, collect_labels,
                            standardize_labels, standardize_labels_inplace,
                            diagram_type, vertices, topology, is_external, is_internal,
                            external_indices, external_legs)
