"""Front-end layer: physics vocabulary, diagram ids, loop pools, and the
SoA leaf tables consumed by the batched TPU leaf evaluators.

Reference: FeynmanDiagram.jl/src/frontend/.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .common import (TwoBodyChannel, Alli, PHr, PHEr, PPr, AnyChan,
                     Filter, Wirreducible, Girreducible, NoHartree, NoFock,
                     NoBubble, Proper, DirectOnly,
                     Response, Composite, ChargeCharge, SpinSpin,
                     ProperChargeCharge, ProperSpinSpin, UpUp, UpDown,
                     AnalyticProperty, Instant, Dynamic, short)
from .diagram_id import (DiagramId, PropagatorId, BareGreenId, BareInteractionId,
                         GenericId, GreenId, SigmaId, PolarId, Ver3Id, Ver4Id,
                         BareHoppingId, BareGreenNId, GreenNId, ConnectedGreenNId,
                         mirror_symmetrize, index, reconstruct)
from .pool import LoopPool
from .label_product import LabelProduct


def leafstates(leaf_maps: Sequence[Dict[int, "Graph"]], maxloop_num: int):
    """Flatten leaf maps into SoA tables for batched leaf evaluation.

    ``leaf_maps[k]`` maps the 0-based leaf-value index to the leaf Graph of
    partition k (e.g. one partition per (order, Gorder, Vorder)).  Returns
    ``(leaf_values, leaf_types, leaf_orders, leaf_in_tau, leaf_out_tau,
    leaf_loop_index), loop_basis`` where ``loop_basis`` is the deduplicated
    momentum basis shared by all partitions.

    These tables are exactly what the TPU leaf kernels consume: momenta come
    from one ``varK @ loop_basis`` matmul, then vectorized G/V kernels gather
    (in_tau, out_tau, loop_index) per leaf.  Reference: frontends.jl:178-232.
    """
    num_g = len(leaf_maps)
    leaf_type = [[] for _ in range(num_g)]
    leaf_orders = [[] for _ in range(num_g)]
    leaf_in_tau = [[] for _ in range(num_g)]
    leaf_out_tau = [[] for _ in range(num_g)]
    leaf_loop_index = [[] for _ in range(num_g)]
    leaf_value = [None] * num_g

    loop_basis: List[np.ndarray] = []
    for ikey, leafmap in enumerate(leaf_maps):
        n = len(leafmap)
        leaf_value[ikey] = np.ones(n)
        for idx in range(n):
            leaf = leafmap[idx]
            if not leaf.isleaf():
                raise ValueError("leafmap must contain only leaves")
            diag_id = leaf.properties
            loopmom = np.zeros(maxloop_num)
            k = np.asarray(diag_id.extK)
            if len(k) > maxloop_num:
                raise ValueError(f"extK dim {len(k)} > maxloop_num {maxloop_num}")
            loopmom[:len(k)] = k
            for bi, b in enumerate(loop_basis):
                if np.allclose(b, loopmom, rtol=1.49e-8):
                    leaf_loop_index[ikey].append(bi)
                    break
            else:
                loop_basis.append(loopmom)
                leaf_loop_index[ikey].append(len(loop_basis) - 1)

            leaf_in_tau[ikey].append(diag_id.extT[0])
            leaf_out_tau[ikey].append(diag_id.extT[1])
            leaf_orders[ikey].append(list(leaf.orders))
            leaf_type[ikey].append(index(type(diag_id)))

    return (leaf_value, leaf_type, leaf_orders, leaf_in_tau, leaf_out_tau,
            leaf_loop_index), [b for b in loop_basis]


def leafstates_label(leaf_maps, label_prod: LabelProduct):
    """LabelProduct variant of ``leafstates`` for FeynmanGraph leaves
    (frontends.jl:115-160): type 0 = interaction, 1 = fermionic, 2 = bosonic.

    Returns (leaf_value, leaf_type, leaf_orders, leaf_in_tau, leaf_out_tau,
    leaf_loop_index) with 0-based loop indices into the label product's
    momentum axis.
    """
    from ..computational_graph.feynman_graph import DiagramType, diagram_type

    num_g = len(leaf_maps)
    leaf_type = [[] for _ in range(num_g)]
    leaf_orders = [[] for _ in range(num_g)]
    leaf_in_tau = [[] for _ in range(num_g)]
    leaf_out_tau = [[] for _ in range(num_g)]
    leaf_loop_index = [[] for _ in range(num_g)]
    leaf_value = [None] * num_g

    for ikey, leafmap in enumerate(leaf_maps):
        n = len(leafmap)
        leaf_value[ikey] = np.ones(n)
        for idx in range(n):
            g = leafmap[idx]
            vertices = g.properties.vertices
            dtype = diagram_type(g)
            if dtype == DiagramType.INTERACTION:
                op_in = op_out = vertices[0][0].label
                leaf_type[ikey].append(0)
                leaf_loop_index[ikey].append(0)
            elif dtype == DiagramType.PROPAGATOR:
                op_in = vertices[1][0].label
                op_out = vertices[0][0].label
                fermionic = vertices[0].isfermionic()
                leaf_type[ikey].append(1 if fermionic else 2)
                leaf_loop_index[ikey].append(
                    label_prod.linear_to_index(op_in)[-1])
            else:
                raise ValueError(f"unsupported leaf diagram type {dtype}")
            leaf_orders[ikey].append(list(g.orders))
            leaf_in_tau[ikey].append(label_prod[op_in][0])
            leaf_out_tau[ikey].append(label_prod[op_out][0])
    return (leaf_value, leaf_type, leaf_orders, leaf_in_tau, leaf_out_tau,
            leaf_loop_index)
