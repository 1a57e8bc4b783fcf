"""String representations for graphs (reference io.jl:76-114)."""
from __future__ import annotations


def _op_symbol(op) -> str:
    return {"sum": "⨁", "prod": "ⓧ", "unitary": "\U0001d7d9"}.get(op.kind, f"^{op.n}")


def stringrep(g, *, with_properties: bool = True) -> str:
    pieces = [str(g.id)]
    if g.name:
        pieces.append(f"{g.name}")
    if with_properties and g.properties is not None:
        pieces.append(f"[{g.properties}]")
    head = ",".join(pieces)
    if not g.subgraphs:
        return f"{head}={g.weight}"
    children = ",".join(str(s.id) for s in g.subgraphs)
    return f"{head}={g.weight}={_op_symbol(g.operator)} ({children})"


def show_tree(g, depth: int = 0, maxdepth: int = 6, _printed=None) -> str:
    """ASCII tree rendering for debugging (DOT export lives in backends.to_dot)."""
    if _printed is None:
        _printed = set()
    pad = "  " * depth
    line = pad + stringrep(g)
    out = [line]
    if depth < maxdepth and g.id not in _printed:
        _printed.add(g.id)
        for sub in g.subgraphs:
            out.append(show_tree(sub, depth + 1, maxdepth, _printed))
    return "\n".join(out)


def plot_tree(g, maxdepth: int = 6) -> str:
    """Print an ASCII rendering of the graph tree (the reference's ete3-based
    plot_tree, io.jl:126-175, maps to this + ``plot_tree_graphical`` + the
    DOT export in backends)."""
    out = show_tree(g, maxdepth=maxdepth)
    print(out)
    return out


def plot_tree_graphical(g, path=None, maxdepth: int = 6, dpi: int = 120):
    """Render the graph as a tree figure via matplotlib (the graphical
    counterpart of the reference's PyCall→ete3 ``plot_tree``,
    io.jl:126-175; shared subgraphs are re-expanded per parent, as the
    reference's tree conversion does).

    ``path``: output image (.png/.pdf/.svg).  When None, returns the
    matplotlib Figure without saving (caller shows/saves it).
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    # layout: leaves get consecutive x in DFS order; parents center over
    # children; y = -depth
    nodes = []           # (x, y, label, is_leaf)
    edges = []           # ((x0, y0), (x1, y1), factor)
    next_x = [0.0]
    # DejaVu-safe operator symbols (the fancy ⨁/ⓧ glyphs are missing)
    mpl_sym = {"sum": "+", "prod": "×"}

    def place(node, depth):
        label = (mpl_sym.get(node.operator.kind,
                             f"^{getattr(node.operator, 'n', '?')}")
                 if node.subgraphs else str(node.id))
        if not node.subgraphs or depth >= maxdepth:
            x = next_x[0]
            next_x[0] += 1.0
            nodes.append((x, -depth, label, True))
            return x
        xs = [place(s, depth + 1) for s in node.subgraphs]
        x = sum(xs) / len(xs)
        nodes.append((x, -depth, label, False))
        for cx, (sub, fac) in zip(xs, zip(node.subgraphs,
                                          node.subgraph_factors)):
            edges.append(((x, -depth), (cx, -(depth + 1)), fac))
        return x

    place(g, 0)
    width = max(4.0, 0.6 * next_x[0])
    height = max(3.0, 1.0 + abs(min(n[1] for n in nodes)))
    fig, ax = plt.subplots(figsize=(width, height))
    for (x0, y0), (x1, y1), fac in edges:
        ax.plot([x0, x1], [y0, y1], "-", color="0.6", lw=0.8, zorder=1)
        if fac != 1.0:
            ax.annotate(f"{fac:g}", ((x0 + x1) / 2, (y0 + y1) / 2),
                        fontsize=6, color="tab:red", ha="center")
    for x, y, label, is_leaf in nodes:
        ax.annotate(label, (x, y), ha="center", va="center", fontsize=8,
                    zorder=2,
                    bbox=dict(boxstyle="round,pad=0.25",
                              fc="#d9ead3" if is_leaf else "#cfe2f3",
                              ec="0.4", lw=0.6))
    ax.set_axis_off()
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        return path
    return fig
