"""Source-code exports: flatten the DAG to SSA source in several languages.

Port of ``feynmandiagram_tpu/backends/source.py`` (the Compilers module of
FeynmanDiagram.jl, backend/static.jl and compiler_python.jl): each unique
node becomes one assignment in post order, leaves load from ``leafVal``,
roots store into ``root``.  These exports are for interop and debugging;
the production path is ``backends.compile``.  The Python export emits
batched torch or numpy source: ``leafVal`` is ``[num_leaves, batch]``,
``leafVal[i]`` one leaf's batch, and the function runs on whatever device
``leafVal`` is on.  The JAX package's ``framework="jax"`` has no place
here, and ``to_stablehlo`` raises: see its docstring.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..computational_graph import Graph


def _node_expr(node: Graph, name_of: Dict[int, str], lang: str) -> str:
    op = node.operator
    subs = [(name_of[s.id], f) for s, f in zip(node.subgraphs, node.subgraph_factors)]

    def term(n, f):
        if f == 1:
            return n
        if lang == "julia":
            return f"{n} * {f}"
        return f"{n} * {f!r}" if lang == "python" else f"{n} * {f}"

    if op.kind == "sum":
        return " + ".join(term(n, f) for n, f in subs)
    if op.kind == "prod":
        return " * ".join(f"({term(n, f)})" if f != 1 else n for n, f in subs)
    if op.kind == "power":
        n, f = subs[0]
        base = f"{n} ** {op.n}" if lang == "python" else (
            f"{n} ^ {op.n}" if lang == "julia" else f"pow({n}, {op.n})")
        return f"({base}) * {f}" if f != 1 else base
    if op.kind == "unitary":
        return repr(float(node.weight))
    raise ValueError(f"cannot export operator {op}")


def _flatten(graphs: Sequence[Graph], leafmap: Optional[Dict[int, int]] = None
             ) -> Tuple[List[Graph], Dict[int, str], Dict[int, int]]:
    """Post-order unique nodes + SSA names + leaf value indices."""
    order: List[Graph] = []
    seen = set()
    for g in graphs:
        for node in g.post_order():
            if node.id not in seen:
                seen.add(node.id)
                order.append(node)
    if leafmap is None:
        leafmap = {}
        for node in order:
            if node.isleaf() and node.operator.kind != "unitary":
                leafmap.setdefault(node.id, len(leafmap))
    name_of = {node.id: f"g{node.id}" for node in order}
    return order, name_of, leafmap


_FRAMEWORKS = {"torch": ("torch", "torch"), "numpy": ("numpy as np", "np")}


def to_python_str(graphs: Sequence[Graph], *, framework: str = "torch",
                  name: str = "eval_graph", leafmap: Optional[Dict[int, int]] = None
                  ) -> Tuple[str, Dict[int, int]]:
    """Emit a batched Python evaluation function (compiler_python.jl:9-52).

    ``leafVal`` has shape [num_leaves, batch]; returns stacked roots.
    ``framework`` is ``"torch"`` or ``"numpy"``.
    """
    if framework not in _FRAMEWORKS:
        raise ValueError(f"framework {framework!r}: the port exports "
                         f"{sorted(_FRAMEWORKS)} (it leads to no jax import)")
    mod, np_name = _FRAMEWORKS[framework]
    order, name_of, leafmap = _flatten(graphs, leafmap)
    lines = [f"import {mod}", "", "", f"def {name}(leafVal):"]
    for node in order:
        if node.isleaf() and node.operator.kind != "unitary":
            lines.append(f"    {name_of[node.id]} = leafVal[{leafmap[node.id]}]")
        else:
            lines.append(f"    {name_of[node.id]} = {_node_expr(node, name_of, 'python')}")
    roots = ", ".join(name_of[g.id] for g in graphs)
    lines.append(f"    return {np_name}.stack([{roots}])")
    return "\n".join(lines) + "\n", leafmap


def to_julia_str(graphs: Sequence[Graph], *, root_name: str = "root",
                 name: str = "eval_graph!", leafmap: Optional[Dict[int, int]] = None
                 ) -> Tuple[str, Dict[int, int]]:
    """Emit scalar Julia source compatible with the reference's
    eval_graph!(root, leafVal) contract (static.jl:98-133)."""
    order, name_of, leafmap = _flatten(graphs, leafmap)
    lines = [f"function {name}({root_name}, leafVal)"]
    for node in order:
        if node.isleaf() and node.operator.kind != "unitary":
            lines.append(f"    {name_of[node.id]} = leafVal[{leafmap[node.id] + 1}]")
        else:
            lines.append(f"    {name_of[node.id]} = {_node_expr(node, name_of, 'julia')}")
    for i, g in enumerate(graphs):
        lines.append(f"    {root_name}[{i + 1}] = {name_of[g.id]}")
    lines.append("end")
    return "\n".join(lines) + "\n", leafmap


def to_c_str(graphs: Sequence[Graph], *, name: str = "eval_graph",
             dtype: str = "double", leafmap: Optional[Dict[int, int]] = None
             ) -> Tuple[str, Dict[int, int]]:
    """Emit C source (static.jl:135-197)."""
    order, name_of, leafmap = _flatten(graphs, leafmap)
    lines = ["#include <math.h>", "",
             f"void {name}({dtype}* root, {dtype}* leafVal)", "{"]
    for node in order:
        if node.isleaf() and node.operator.kind != "unitary":
            lines.append(f"    {dtype} {name_of[node.id]} = leafVal[{leafmap[node.id]}];")
        else:
            lines.append(f"    {dtype} {name_of[node.id]} = {_node_expr(node, name_of, 'c')};")
    for i, g in enumerate(graphs):
        lines.append(f"    root[{i}] = {name_of[g.id]};")
    lines.append("}")
    return "\n".join(lines) + "\n", leafmap


def compile_python(graphs: Sequence[Graph], filename: Optional[str] = None,
                   *, framework: str = "torch"):
    """Write (or return) the Python export; returns (callable, leafmap) when
    no filename is given (the in-process analog of Compilers.compile)."""
    src, leafmap = to_python_str(graphs, framework=framework)
    if filename is not None:
        with open(filename, "w") as f:
            f.write(src)
        return filename, leafmap
    namespace: Dict = {}
    exec(src, namespace)
    return namespace["eval_graph"], leafmap


def compile_julia(graphs: Sequence[Graph], filename: str):
    src, leafmap = to_julia_str(graphs)
    with open(filename, "a") as f:
        f.write(src)
    return filename, leafmap


def compile_c(graphs: Sequence[Graph], filename: str):
    src, leafmap = to_c_str(graphs)
    with open(filename, "a") as f:
        f.write(src)
    return filename, leafmap


def to_stablehlo(graphs: Sequence[Graph], batch: int = 128) -> str:
    """Not available in the port; raises ``NotImplementedError``.

    The JAX package dumps its jitted evaluator as StableHLO text, XLA's
    input language.  The port has no XLA to hand StableHLO to, and its
    evaluator launches a hand-written CUDA kernel through ctypes, which no
    graph exporter can trace.  ``to_python_str``, ``to_c_str`` and the
    ``.npz`` artifact (``backends.compile.export_artifact``) are its exports.
    """
    raise NotImplementedError(
        "to_stablehlo: StableHLO is XLA's input language and the port has no XLA; its "
        "evaluator launches a ctypes CUDA kernel that no exporter can trace. Use "
        "to_python_str, to_c_str or backends.compile.export_artifact instead.")
