"""Graphviz DOT export for debugging/visualization (FeynmanDiagram.jl to_dot.jl).

Port of ``feynmandiagram_tpu/backends/to_dot.py``, unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..computational_graph import Graph

_OP_LABEL = {"sum": "⊕", "prod": "⊗", "unitary": "1"}


def to_dot_str(graphs: Sequence[Graph], *, graph_name: str = "FeynmanDiagram",
               max_label: int = 40) -> str:
    lines = [f"digraph {graph_name} {{", "    node [style=filled, fillcolor=dodgerblue];"]
    seen = set()
    edges = []
    for g in graphs:
        for node in g.post_order():
            if node.id in seen:
                continue
            seen.add(node.id)
            if node.isleaf():
                label = str(node.properties) if node.properties is not None else node.name or "leaf"
                label = label[:max_label]
                lines.append(f'    g{node.id} [shape=box, fillcolor=lightgrey, label="{label}"];')
            else:
                op = node.operator
                label = _OP_LABEL.get(op.kind, f"^{op.n}")
                lines.append(f'    g{node.id} [shape=circle, label="{label}"];')
            for sub, fac in zip(node.subgraphs, node.subgraph_factors):
                attr = "" if fac == 1 else f' [label="{fac:g}"]'
                edges.append(f"    g{node.id} -> g{sub.id}{attr};")
    lines.extend(edges)
    lines.append("}")
    return "\n".join(lines) + "\n"


def compile_dot(graphs: Sequence[Graph], filename: str, *,
                graph_name: str = "FeynmanDiagram") -> str:
    with open(filename, "w") as f:
        f.write(to_dot_str(graphs, graph_name=graph_name))
    return filename
