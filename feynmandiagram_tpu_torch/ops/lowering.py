"""Lowering: symbolic Graph DAG -> flat, level-scheduled array-form IR.

This replaces the reference's source-code compiler
(FeynmanDiagram.jl/src/backend/static.jl) with a TPU-first design: instead of
emitting one scalar expression per node evaluated once per Monte-Carlo
sample, the DAG is flattened to numpy arrays grouped by topological level
and node kind, so each level evaluates as a few batched vector ops
(gather-multiply + segment-sum) over the whole MC sample tensor (see
``feynmandiagram_tpu_torch.ops.evaluator``).  It is a copy of the JAX
package's ``ops/lowering.py`` with unchanged behaviour: the two give
identical tables, which the parity tests demand.

Layout
------
- node slots 0..L-1: unique leaves (deduplicated by uid, ordered by the
  caller's leafmap when given) — filled from the leaf-value input
- constant (Unitary) leaves are recorded in ``const_slots``/``const_values``
  and filled by the evaluator
- internal nodes are assigned contiguous slot ranges per (level, kind)
  so each level writes a few dynamic-update-slices:
  * Sum nodes   -> CSR edge list (sorted by destination): segment-sum
  * Prod nodes  -> per-arity index matrices: fused gather-multiply
  * Power nodes -> per-exponent source lists: integer_pow
- Prod nodes with fan-in > MAX_PROD_ARITY are binarized into balanced
  intermediate nodes during lowering (static shapes, better VPU utilization)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..computational_graph.graph import Graph

MAX_PROD_ARITY = 4

# fused-mode slot alignment: bucket outputs are padded/aligned to the TPU
# f32 sublane tile (8 rows) so the gather's [A*C, B] -> [A, C, B] reshape is
# a layout-preserving bitcast and the per-bucket dynamic-update-slice writes
# whole tiles.  Measured on v5e (PARITY.md profile table): unaligned
# reshapes/updates are real copies costing ~30% of the graph phase.
TILE_ROWS = 8


def _pad_to(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _pad_pow2(n: int) -> int:
    a = 1
    while a < n:
        a *= 2
    return a


class _SlotPool:
    """Contiguous-interval first-fit allocator over recycled slots."""

    def __init__(self, top: int):
        self.top = top
        self.intervals: List[List[int]] = []  # sorted [start, end)
        self.pending: List[int] = []

    def free(self, slots: List[int]) -> None:
        self.pending.extend(slots)

    def _merge(self) -> None:
        if not self.pending:
            return
        ivs = self.intervals + [[p, p + 1] for p in self.pending]
        self.pending = []
        ivs.sort()
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        self.intervals = merged

    def alloc(self, count: int, align: int = 1) -> int:
        self._merge()
        for k, (s, e) in enumerate(self.intervals):
            s_al = _pad_to(s, align)
            if e - s_al >= count:
                if s_al > s:
                    self.intervals[k] = [s, s_al]
                    if e > s_al + count:
                        self.intervals.insert(k + 1, [s_al + count, e])
                elif e - s == count:
                    del self.intervals[k]
                else:
                    self.intervals[k][0] = s + count
                return s_al
        s = _pad_to(self.top, align)
        if s > self.top:
            self.intervals.append([self.top, s])
            self.intervals.sort()
        self.top = s + count
        return s


@dataclass
class _Rec:
    """Internal lightweight node record during lowering."""
    op: str                  # 'leaf' | 'const' | 'sum' | 'prod' | 'power'
    children: List[int]      # indices into the record table
    factors: List[float]
    power: int = 0
    value: float = 0.0       # for 'const'
    uid: int = -1            # graph uid (leaves)


@dataclass
class SumPlan:
    start: int               # first destination slot
    count: int               # number of sum nodes in this level
    edge_src: np.ndarray     # [E] int32 source slots
    edge_factor: np.ndarray  # [E] float factors
    edge_seg: np.ndarray     # [E] int32 destination index relative to start (sorted)


@dataclass
class SumBucket:
    """Dense padded form of a group of sum nodes with equal padded fan-in.

    Replaces the scatter-add segment-sum with gather + reshape + reduce:
    ``out = sum(w[idx] * fac, axis=0)`` — all static shapes, no scatter.
    Padding entries use src=0 with factor 0.
    """
    arity: int
    start: int
    count: int
    idx: np.ndarray          # [arity, count] int32
    fac: np.ndarray          # [arity, count]


@dataclass
class FusedBucket:
    """Sum-of-products: ``out[c] = sum_a fac[a, c] * prod_k w[idx[k, a, c]]``.

    The uniform TPU primitive of ``sum_mode='fused'`` (the SDDMM-style fused
    multiply-gather of the BASELINE north star): Sum nodes become arity-a
    buckets of 1-operand terms; fan-out-1 Prod children are inlined as
    multi-operand terms (their node slots disappear); standalone Prods are
    single-term buckets.  Padding terms carry fac=0; padding operands point
    at the constant-one slot (multiplicative identity).
    """
    arity: int               # padded number of terms per node
    n_op: int                # padded number of operands per term
    start: int
    count: int
    idx: np.ndarray          # [n_op, arity, count] int32
    fac: np.ndarray          # [arity, count]


@dataclass
class ProdPlan:
    arity: int
    start: int
    count: int
    idx: np.ndarray          # [arity, count] int32 source slots
    factor: np.ndarray       # [count] product of subgraph factors


@dataclass
class PowerPlan:
    n: int
    start: int
    count: int
    src: np.ndarray          # [count] int32
    factor: np.ndarray       # [count]


@dataclass
class LevelPlan:
    sums: Optional[SumPlan]
    prods: List[ProdPlan]
    pows: List[PowerPlan]
    sum_buckets: List[SumBucket] = field(default_factory=list)
    fused: List[FusedBucket] = field(default_factory=list)


@dataclass
class LoweredGraph:
    num_slots: int
    num_leaves: int          # leaf slots (including constants)
    levels: List[LevelPlan]
    root_slots: np.ndarray   # [num_roots] int32
    leaf_uid_to_slot: Dict[int, int]
    const_slots: np.ndarray  # [num_consts] int32 (subset of leaf slots)
    const_values: np.ndarray
    # diagnostics
    num_edges: int = 0

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _choose_buckets(groups: Dict[int, List[int]], merge_threshold: int
                    ) -> List[Tuple[int, List[int]]]:
    """Greedily merge adjacent-arity bucket groups when the padding cost
    (extra edges) stays below ``merge_threshold`` — fewer, larger device ops.

    ``groups``: padded-arity -> node list.  Returns [(arity, nodes)].
    """
    items = sorted((a, list(nodes)) for a, nodes in groups.items())
    merged = True
    while merged and len(items) > 1:
        merged = False
        best = None
        for k in range(len(items) - 1):
            a_lo, lo = items[k]
            a_hi, hi = items[k + 1]
            extra = (a_hi - a_lo) * len(lo)
            if extra <= merge_threshold and (best is None or extra < best[0]):
                best = (extra, k)
        if best is not None:
            _, k = best
            a_hi = items[k + 1][0]
            items[k + 1] = (a_hi, items[k][1] + items[k + 1][1])
            del items[k]
            merged = True
    return items


def _postorder_records(recs: List[_Rec], root_recs: List[int]
                       ) -> Tuple[List[_Rec], List[int]]:
    """Renumber the record table into postorder (children before parents).

    ``_cse_records`` requires postorder; binarize/split append sub-records
    AFTER their parents, so the table must be reordered before a second
    CSE pass.  Unreachable records are dropped.  Children lists are
    remapped in place on the shared ``_Rec`` objects."""
    index_map: Dict[int, int] = {}
    new_recs: List[_Rec] = []
    for root in root_recs:
        stack = [(root, False)]
        while stack:
            i, expanded = stack.pop()
            if i in index_map:
                continue
            if expanded:
                recs[i].children = [index_map[c] for c in recs[i].children]
                index_map[i] = len(new_recs)
                new_recs.append(recs[i])
            else:
                stack.append((i, True))
                for c in recs[i].children:
                    if c not in index_map:
                        stack.append((c, False))
    return new_recs, [index_map[r] for r in root_recs]


def _cse_records(recs: List[_Rec], root_recs: List[int]) -> List[int]:
    """Value-preserving CSE over the postordered record table (in place).

    Leaves keep their identity (distinct uids stay distinct inputs);
    structurally identical internal nodes merge.  Uses the native graphcore
    kernel when available (numpy/python fallback inside ``native.cse``).
    Returns the remapped root indices.
    """
    from .. import native

    n = len(recs)
    ops = np.zeros(n, np.int8)
    powers = np.zeros(n, np.int32)
    prop = np.zeros(n, np.uint64)
    counts = np.zeros(n, np.int64)
    op_code = {"leaf": 0, "sum": 1, "prod": 2, "power": 3, "const": 4}
    for i, r in enumerate(recs):
        ops[i] = op_code[r.op]
        powers[i] = r.power
        if r.op == "leaf":
            prop[i] = np.uint64(r.uid)  # leaves never merge with each other
        elif r.op == "const":
            prop[i] = np.frombuffer(np.float64(r.value).tobytes(),
                                    dtype=np.uint64)[0]
        counts[i] = len(r.children)
    edge_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=edge_ptr[1:])
    edge_src = np.zeros(int(edge_ptr[-1]), np.int64)
    edge_fac = np.zeros(int(edge_ptr[-1]), np.float64)
    for i, r in enumerate(recs):
        s = edge_ptr[i]
        for j, (c, f) in enumerate(zip(r.children, r.factors)):
            edge_src[s + j] = c
            edge_fac[s + j] = f

    remap, _ = native.cse(ops, powers, prop, edge_ptr, edge_src, edge_fac)

    new_index = {}
    new_recs: List[_Rec] = []
    for i, r in enumerate(recs):
        if remap[i] != i:
            continue
        r.children = [new_index[remap[c]] for c in r.children]
        new_index[i] = len(new_recs)
        new_recs.append(r)
    recs.clear()
    recs.extend(new_recs)
    return [new_index[int(remap[r])] for r in root_recs]


def lower(roots: Sequence[Graph], leafmap: Optional[Dict[int, int]] = None,
          dtype=np.float64, *, sum_mode: str = "csr",
          max_sum_arity: int = 64, merge_threshold: int = 0,
          cse: bool = False, reuse_slots: Optional[bool] = None,
          schedule: str = "auto") -> LoweredGraph:
    """Lower root graphs into a LoweredGraph.

    ``leafmap`` maps leaf uid -> leaf-value index; when given, leaf slot k
    holds the leaf with ``leafmap[uid] == k``.  When absent, leaves are
    numbered in first-visit order (stable across calls on the same DAG).

    ``sum_mode``:
    - 'csr': Sum levels evaluate as sorted segment-sums (scatter-add)
    - 'bucketed': wide sums are pre-split to fan-in <= max_sum_arity and
      grouped by padded power-of-two arity into dense gather+reduce buckets
      (no scatter; the TPU-friendly mode)
    - 'fused': like 'bucketed', but fan-out-1 Prod children of Sum nodes are
      inlined as multi-operand terms of one uniform sum-of-products primitive
      (FusedBucket).  In parquet graphs ~80% of Prod nodes are fan-out-1
      (G*W products under mergeby Sums), so this removes most intermediate
      node materialization — the fastest mode on TPU.

    ``reuse_slots`` (fused mode only; default on for 'fused'): recycle the
    slot of an internal node once the last level reading it has run, with a
    contiguous-interval free list.  Shrinks the device weight buffer to
    roughly the live working set (~3x on order-4 vertex4, far more on
    order-6), cutting buffer-init traffic and HBM footprint — required for
    graphs whose full slot count exceeds per-chip HBM (BASELINE config 5).

    ``schedule``: level assignment of internal nodes.  'asap' = earliest
    (1 + max child level); 'alap' = latest level strictly below every
    consumer — TYPICALLY shorter lifetimes and a smaller peak live set,
    hence a larger VMEM-resident batch under the ``recommended_batch``
    sizing rule.  Neither dominates (with cse=True the interaction with
    bucket grouping can make ALAP peak slightly larger — measured 1122 vs
    1086 on order-3 vertex4, ADVICE r3), so 'auto' (default) simulates the
    reuse allocator under BOTH assignments — host-side integer work only —
    and keeps the one with fewer peak slots (ALAP when reuse is off or on
    ties).  Outputs are exactly equal for every schedule; roots and leaves
    are pinned; all schedules respect all dependencies.
    """
    # ---- collect records (object-identity traversal; leaves dedup by uid)
    recs: List[_Rec] = []
    obj_to_rec: Dict[int, int] = {}
    leaf_uid_rec: Dict[int, int] = {}

    def visit(g: Graph) -> int:
        key = id(g)
        if key in obj_to_rec:
            return obj_to_rec[key]
        if g.isleaf():
            if g.operator.kind == "unitary":
                r = len(recs)
                recs.append(_Rec("const", [], [], value=g.weight, uid=g.id))
            elif g.id in leaf_uid_rec:
                r = leaf_uid_rec[g.id]
            else:
                r = len(recs)
                recs.append(_Rec("leaf", [], [], uid=g.id))
                leaf_uid_rec[g.id] = r
            obj_to_rec[key] = r
            return r
        children = [visit(s) for s in g.subgraphs]
        factors = [float(f) for f in g.subgraph_factors]
        op = g.operator.kind
        r = len(recs)
        if op == "sum":
            recs.append(_Rec("sum", children, factors))
        elif op == "prod":
            recs.append(_Rec("prod", children, factors))
        elif op == "power":
            recs.append(_Rec("power", children, factors, power=g.operator.n))
        else:
            raise ValueError(f"cannot lower operator {g.operator}")
        obj_to_rec[key] = r
        return r

    # iterative wrapper to avoid Python recursion limits on deep DAGs
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 1000000))
    try:
        root_recs = [visit(g) for g in roots]
    finally:
        sys.setrecursionlimit(old_limit)

    # ---- structural CSE on the flat records (native-accelerated).
    # Between passes, canonicalize Prod records: sort children (Prod is
    # commutative) and hoist the internal factor product onto every parent
    # edge, so prods that compute proportional values become structurally
    # identical and hash-cons together.  Measured on the order-4/5 parquet
    # lowerings (round 5): ~21% of multi-operand product terms repeat an
    # operand set under different Sum parents with different coefficient
    # splits — invisible to factor-sensitive hashing.  The loop reruns CSE
    # until no prod changes (children indices are canonical only after the
    # previous merge pass).
    if cse:
        root_recs = _cse_records(recs, root_recs)
        for _ in range(4):
            root_set0 = set(root_recs)
            scale: Dict[int, float] = {}
            changed = False
            for i, r in enumerate(recs):
                if r.op != "prod" or i in root_set0:
                    continue
                s = 1.0
                for f in r.factors:
                    s *= f
                new_children = sorted(r.children)
                if new_children != r.children or s != 1.0:
                    changed = True
                    r.children = new_children
                    r.factors = [1.0] * len(r.children)
                    if s != 1.0:
                        scale[i] = s
            if scale:
                for r in recs:
                    if r.op == "power":
                        c = r.children[0]
                        if c in scale:
                            # power applies BEFORE the edge factor:
                            # (v/s)^n * (f*s^n) == v^n * f
                            r.factors[0] *= scale[c] ** r.power
                    else:
                        r.factors = [f * scale.get(c, 1.0)
                                     for c, f in zip(r.children, r.factors)]
            if not changed:
                break
            root_recs = _cse_records(recs, root_recs)

    # ---- binarize wide prods
    def binarize(r_idx: int) -> None:
        rec = recs[r_idx]
        while rec.op == "prod" and len(rec.children) > MAX_PROD_ARITY:
            new_children: List[int] = []
            new_factors: List[float] = []
            it = list(zip(rec.children, rec.factors))
            for i in range(0, len(it), 2):
                chunk = it[i:i + 2]
                if len(chunk) == 1:
                    new_children.append(chunk[0][0])
                    new_factors.append(chunk[0][1])
                else:
                    sub = len(recs)
                    recs.append(_Rec("prod", [c for c, _ in chunk], [f for _, f in chunk]))
                    new_children.append(sub)
                    new_factors.append(1.0)
            rec.children = new_children
            rec.factors = new_factors

    for i in range(len(recs)):
        binarize(i)

    # ---- split wide sums for the bucketed/fused modes
    if sum_mode in ("bucketed", "fused"):
        def split_sum(r_idx: int) -> None:
            rec = recs[r_idx]
            while rec.op == "sum" and len(rec.children) > max_sum_arity:
                new_children: List[int] = []
                new_factors: List[float] = []
                it = list(zip(rec.children, rec.factors))
                for i in range(0, len(it), max_sum_arity):
                    chunk = it[i:i + max_sum_arity]
                    if len(chunk) == 1:
                        new_children.append(chunk[0][0])
                        new_factors.append(chunk[0][1])
                    else:
                        sub = len(recs)
                        recs.append(_Rec("sum", [c for c, _ in chunk],
                                         [f for _, f in chunk]))
                        new_children.append(sub)
                        new_factors.append(1.0)
                rec.children = new_children
                rec.factors = new_factors

        for i in range(len(recs)):
            split_sum(i)

    # ---- second CSE pass over the binarize/split products (round 5):
    # binarization pairs children in (sorted, post-canonicalization) order,
    # so wide prods sharing child prefixes spawn structurally identical
    # sub-prods — created AFTER the main CSE pass and invisible to it.
    # The table must be re-postordered first (binarize appends children
    # after their parents).  Measured on order-4 vertex4: 4,166 repeated
    # operand pairs exist at this point.
    if cse:
        recs2, root_recs = _postorder_records(recs, root_recs)
        recs.clear()
        recs.extend(recs2)
        root_recs = _cse_records(recs, root_recs)

    # a constant-one slot pads merged Prod buckets and fused-bucket operands
    # (multiplicative identity)
    ones_rec = -1
    if sum_mode == "fused" or (sum_mode == "bucketed" and merge_threshold > 0):
        ones_rec = len(recs)
        recs.append(_Rec("const", [], [], value=1.0))

    # ---- fused mode: decide which Prod records inline into their Sum parent
    inline_set: set = set()
    if sum_mode == "fused":
        n_use = [0] * len(recs)
        consumer = [-1] * len(recs)
        for i, r in enumerate(recs):
            for c in r.children:
                n_use[c] += 1
                consumer[c] = i
        root_set = set(root_recs)
        for i, r in enumerate(recs):
            if (r.op == "prod" and i not in root_set and n_use[i] == 1
                    and 1 <= len(r.children) <= MAX_PROD_ARITY
                    and recs[consumer[i]].op == "sum"):
                inline_set.add(i)

    def eff_children(i: int) -> List[int]:
        """Operand edges of record i after inlining (fused mode)."""
        r = recs[i]
        if not inline_set or r.op != "sum":
            return r.children
        out: List[int] = []
        for c in r.children:
            if c in inline_set:
                out.extend(recs[c].children)
            else:
                out.append(c)
        return out

    def terms_of(i: int) -> List[Tuple[List[int], float]]:
        """Sum-of-products term list of record i: [(operand recs, coeff)]."""
        r = recs[i]
        if r.op == "sum":
            terms = []
            for c, f in zip(r.children, r.factors):
                if c in inline_set:
                    rc = recs[c]
                    coeff = f
                    for fk in rc.factors:
                        coeff *= fk
                    terms.append((list(rc.children), coeff))
                else:
                    terms.append(([c], f))
            return terms
        coeff = 1.0
        for fk in r.factors:
            coeff *= fk
        return [(list(r.children), coeff)]

    # ---- depth (level) computation, iterative topological
    depth = [0] * len(recs)
    state = [0] * len(recs)  # 0=unvisited, 1=done
    for start_i in range(len(recs)):
        if state[start_i]:
            continue
        stack = [(start_i, False)]
        while stack:
            i, expanded = stack.pop()
            if expanded:
                ch = eff_children(i)
                depth[i] = 0 if not ch else 1 + max(depth[c] for c in ch)
                state[i] = 1
                continue
            if state[i]:
                continue
            stack.append((i, True))
            for c in eff_children(i):
                if not state[c]:
                    stack.append((c, False))

    # ---- schedule selection.  ALAP pulls each internal non-root node down
    # to just above its earliest consumer; 'auto' (default, reuse on) runs a
    # cheap peak-slot simulation of BOTH assignments and keeps the smaller
    # (ADVICE r3 #1 / VERDICT r4 #6: neither schedule dominates — deep
    # shared parquet nodes favor ASAP at some orders).
    if reuse_slots is None:
        reuse_slots = sum_mode == "fused"
    if reuse_slots and sum_mode != "fused":
        raise ValueError("reuse_slots requires sum_mode='fused'")
    align = TILE_ROWS if sum_mode == "fused" else 1
    PINNED = 1 << 30

    def alap_depths(depth_in: List[int]) -> List[int]:
        d_out = list(depth_in)
        root_set_sched = set(root_recs)
        consumer_min = [None] * len(recs)
        # descending ASAP order visits every consumer before its producers
        # (depth[consumer] > depth[producer] strictly), so d_out[i] is final
        # when visited and can be propagated into its children's minima
        order_desc = sorted((i for i in range(len(recs)) if i not in inline_set),
                            key=lambda i: -depth_in[i])
        for i in order_desc:
            movable = (d_out[i] > 0 and i not in root_set_sched
                       and recs[i].op not in ("leaf", "const"))
            if movable and consumer_min[i] is not None \
                    and consumer_min[i] - 1 > d_out[i]:
                d_out[i] = consumer_min[i] - 1
            d = d_out[i]
            for c in eff_children(i):
                if consumer_min[c] is None or d < consumer_min[c]:
                    consumer_min[c] = d
        return d_out

    _terms_cache: Dict[int, List[Tuple[List[int], float]]] = {}

    def terms_cached(i: int):
        t = _terms_cache.get(i)
        if t is None:
            t = _terms_cache[i] = terms_of(i)
        return t

    def fused_groupings(nodes: List[int]) -> List[Tuple[Tuple[int, int],
                                                        List[int]]]:
        """Group fused-mode sum/prod nodes of one level by (padded term
        count, max operands per term), largest group first; shared by the
        real lowering pass and the schedule simulation so their allocation
        sequences match exactly.  Arity is exact up to 8 (padding reads are
        real gather traffic), then pow2."""
        by_key: Dict[Tuple[int, int], List[int]] = {}
        for i in nodes:
            terms = terms_cached(i)
            a = len(terms)
            key = (a if a <= 8 else _pad_pow2(a),
                   max(len(ops) for ops, _ in terms))
            by_key.setdefault(key, []).append(i)
        # optional coalescing: merge (arity, n_op) groups while the padding
        # cost (extra gathered elements) stays under the threshold
        if merge_threshold > 0 and len(by_key) > 1:
            items = [[k, v] for k, v in sorted(by_key.items())]
            merged_any = True
            while merged_any and len(items) > 1:
                merged_any = False
                best = None
                for x in range(len(items)):
                    for y in range(x + 1, len(items)):
                        (a1, o1), g1 = items[x]
                        (a2, o2), g2 = items[y]
                        na, no = max(a1, a2), max(o1, o2)
                        extra = ((na * no - a1 * o1) * len(g1)
                                 + (na * no - a2 * o2) * len(g2))
                        if extra <= merge_threshold and (
                                best is None or extra < best[0]):
                            best = (extra, x, y, na, no)
                if best is not None:
                    _, x, y, na, no = best
                    items[x] = [(na, no), items[x][1] + items[y][1]]
                    del items[y]
                    merged_any = True
            by_key = {tuple(k): v for k, v in items}
        return sorted(by_key.items(), key=lambda kv: -len(kv[1]))

    def _sim_peak(depth_arr: List[int], n_leaf_slots: int) -> int:
        """Peak slot count of the fused+reuse allocator under ``depth_arr``,
        replaying the exact allocation/free sequence without building the
        index tables (host-side integer work only)."""
        last_read_s = [0] * len(recs)
        for i in range(len(recs)):
            if i in inline_set:
                continue
            for c in eff_children(i):
                if depth_arr[i] > last_read_s[c]:
                    last_read_s[c] = depth_arr[i]
        for r in root_recs:
            last_read_s[r] = PINNED
        if ones_rec >= 0:
            last_read_s[ones_rec] = PINNED
        pool = _SlotPool(n_leaf_slots)
        free_events: Dict[int, List[int]] = {}
        maxd = max(depth_arr) if recs else 0
        by_depth: List[List[int]] = [[] for _ in range(maxd + 1)]
        for i, r in enumerate(recs):
            if i not in inline_set and r.op in ("sum", "prod", "power"):
                by_depth[depth_arr[i]].append(i)
        for lev in range(1, maxd + 1):
            for fl in list(free_events):
                if fl < lev:
                    pool.free(free_events.pop(fl))
            nodes = by_depth[lev]
            pows_by_n: Dict[int, List[int]] = {}
            for i in nodes:
                if recs[i].op == "power":
                    pows_by_n.setdefault(recs[i].power, []).append(i)
            group_lists = [g for _, g in fused_groupings(
                [i for i in nodes if recs[i].op != "power"])]
            group_lists += [pows_by_n[n] for n in sorted(pows_by_n)]
            for group in group_lists:
                n_pad = _pad_to(len(group), align)
                start = pool.alloc(n_pad, align)
                for k, i in enumerate(group):
                    if last_read_s[i] != PINNED:
                        free_events.setdefault(last_read_s[i],
                                               []).append(start + k)
                for k in range(len(group), n_pad):
                    free_events.setdefault(lev, []).append(start + k)
        return pool.top

    if schedule == "auto":
        if reuse_slots:
            n_leaf_slots_pre = sum(1 for r in recs if r.op in ("leaf", "const"))
            d_alap = alap_depths(depth)
            # ALAP wins ties (typically shorter lifetimes downstream)
            if _sim_peak(d_alap, n_leaf_slots_pre) <= _sim_peak(
                    depth, n_leaf_slots_pre):
                depth = d_alap
        else:
            depth = alap_depths(depth)
    elif schedule == "alap":
        depth = alap_depths(depth)
    elif schedule != "asap":
        raise ValueError(f"unknown schedule {schedule!r}")

    # ---- slot assignment
    leaf_recs = [i for i, r in enumerate(recs) if r.op == "leaf"]
    const_recs = [i for i, r in enumerate(recs) if r.op == "const"]
    if leafmap is not None:
        for i in leaf_recs:
            if recs[i].uid not in leafmap:
                raise KeyError(f"leaf uid {recs[i].uid} missing from leafmap")
        leaf_recs.sort(key=lambda i: leafmap[recs[i].uid])
        slots_used = {leafmap[recs[i].uid] for i in leaf_recs}
        if slots_used != set(range(len(leaf_recs))):
            raise ValueError("leafmap indices must be 0..num_leaves-1 and unique")
    slot_of = {}
    for k, i in enumerate(leaf_recs):
        slot_of[i] = k
    nl = len(leaf_recs)
    for k, i in enumerate(const_recs):
        slot_of[i] = nl + k
    num_leaf_slots = nl + len(const_recs)

    max_depth = max(depth) if recs else 0
    levels: List[LevelPlan] = []
    next_slot = num_leaf_slots
    num_edges = 0

    # ---- slot recycling (fused mode): liveness + contiguous-interval pool
    last_read = [0] * len(recs)
    if reuse_slots:
        for i in range(len(recs)):
            if i in inline_set:
                continue
            for c in eff_children(i):
                if depth[i] > last_read[c]:
                    last_read[c] = depth[i]
        for r in root_recs:
            last_read[r] = PINNED
        if ones_rec >= 0:
            last_read[ones_rec] = PINNED

    pool = _SlotPool(num_leaf_slots)
    free_events: Dict[int, List[int]] = {}

    def alloc_group(group: List[int], lev: int) -> int:
        """Assign a contiguous (aligned, padded) slot range to ``group``;
        register liveness.  Padding slots beyond ``len(group)`` hold the
        zero rows the padded bucket writes; they are freed right after this
        level so the reuse pool recycles them."""
        nonlocal next_slot
        n_pad = _pad_to(len(group), align)
        if reuse_slots:
            start = pool.alloc(n_pad, align)
        else:
            start = next_slot = _pad_to(next_slot, align)
        next_slot += n_pad
        for k, i in enumerate(group):
            slot_of[i] = start + k
            if reuse_slots and last_read[i] != PINNED:
                free_events.setdefault(last_read[i], []).append(start + k)
        if reuse_slots:
            for k in range(len(group), n_pad):
                free_events.setdefault(lev, []).append(start + k)
        return start

    nodes_by_depth: List[List[int]] = [[] for _ in range(max_depth + 1)]
    for i, r in enumerate(recs):
        if i not in inline_set and r.op in ("sum", "prod", "power"):
            nodes_by_depth[depth[i]].append(i)

    for lev in range(1, max_depth + 1):
        if reuse_slots:
            # slots last read before this level are free for its outputs
            for fl in list(free_events):
                if fl < lev:
                    pool.free(free_events.pop(fl))
        nodes = nodes_by_depth[lev]
        sums = [i for i in nodes if recs[i].op == "sum"]
        prods_by_arity: Dict[int, List[int]] = {}
        pows_by_n: Dict[int, List[int]] = {}
        for i in nodes:
            r = recs[i]
            if r.op == "prod":
                if sum_mode != "fused":
                    prods_by_arity.setdefault(len(r.children), []).append(i)
            elif r.op == "power":
                pows_by_n.setdefault(r.power, []).append(i)

        fused_buckets: List[FusedBucket] = []
        if sum_mode == "fused":
            # sums AND standalone prods all lower to the uniform primitive;
            # grouping (and optional coalescing) in ``fused_groupings`` —
            # shared with the schedule='auto' peak simulation.  Large groups
            # allocate first (less free-pool fragmentation).
            for (arity, n_op), group in fused_groupings(
                    [i for i in nodes if recs[i].op != "power"]):
                start = alloc_group(group, lev)
                cpad = _pad_to(len(group), align)
                ones_slot = slot_of[ones_rec]
                idx = np.full((n_op, arity, cpad), ones_slot, np.int32)
                fac = np.zeros((arity, cpad), dtype)
                for k, i in enumerate(group):
                    for a, (ops, coeff) in enumerate(terms_cached(i)):
                        fac[a, k] = coeff
                        for m, c in enumerate(ops):
                            idx[m, a, k] = slot_of[c]
                        num_edges += len(ops)
                fused_buckets.append(
                    FusedBucket(arity, n_op, start, cpad, idx, fac))
            sums = []

        sum_plan = None
        sum_buckets: List[SumBucket] = []
        if sums and sum_mode == "csr":
            start = next_slot
            for k, i in enumerate(sums):
                slot_of[i] = start + k
            next_slot += len(sums)
            edge_src, edge_factor, edge_seg = [], [], []
            for k, i in enumerate(sums):
                r = recs[i]
                for c, f in zip(r.children, r.factors):
                    edge_src.append(slot_of[c])
                    edge_factor.append(f)
                    edge_seg.append(k)
            num_edges += len(edge_src)
            sum_plan = SumPlan(start, len(sums),
                               np.asarray(edge_src, np.int32),
                               np.asarray(edge_factor, dtype),
                               np.asarray(edge_seg, np.int32))
        elif sums:  # bucketed: group by padded power-of-two fan-in
            def pad_arity(n: int) -> int:
                a = 1
                while a < n:
                    a *= 2
                return a

            by_arity: Dict[int, List[int]] = {}
            for i in sums:
                by_arity.setdefault(pad_arity(len(recs[i].children)), []).append(i)
            for a, group in _choose_buckets(by_arity, merge_threshold):
                start = next_slot
                for k, i in enumerate(group):
                    slot_of[i] = start + k
                next_slot += len(group)
                idx = np.zeros((a, len(group)), np.int32)
                fac = np.zeros((a, len(group)), dtype)
                for k, i in enumerate(group):
                    r = recs[i]
                    for j, (c, f) in enumerate(zip(r.children, r.factors)):
                        idx[j, k] = slot_of[c]
                        fac[j, k] = f
                    num_edges += len(r.children)
                sum_buckets.append(SumBucket(a, start, len(group), idx, fac))

        prod_plans: List[ProdPlan] = []
        if ones_rec >= 0 and merge_threshold > 0:
            prod_groups = _choose_buckets(prods_by_arity, merge_threshold)
        else:
            prod_groups = [(a, prods_by_arity[a]) for a in sorted(prods_by_arity)]
        for arity, group in prod_groups:
            start = next_slot
            for k, i in enumerate(group):
                slot_of[i] = start + k
            next_slot += len(group)
            # padding entries multiply by the constant-one slot
            pad_slot = slot_of[ones_rec] if ones_rec >= 0 else 0
            idx = np.full((arity, len(group)), pad_slot, np.int32)
            fac = np.ones(len(group), dtype)
            for k, i in enumerate(group):
                r = recs[i]
                for a, (c, f) in enumerate(zip(r.children, r.factors)):
                    idx[a, k] = slot_of[c]
                    fac[k] *= f
            num_edges += arity * len(group)
            prod_plans.append(ProdPlan(arity, start, len(group), idx, fac))

        pow_plans: List[PowerPlan] = []
        for n in sorted(pows_by_n):
            group = pows_by_n[n]
            if sum_mode == "fused":
                start = alloc_group(group, lev)
                cpad = _pad_to(len(group), align)
                pad_src = slot_of[ones_rec]  # integer_pow(1) * 0 == 0
            else:
                start = next_slot
                for k, i in enumerate(group):
                    slot_of[i] = start + k
                next_slot += len(group)
                cpad = len(group)
                pad_src = 0
            src = np.full(cpad, pad_src, np.int32)
            fac = np.zeros(cpad, dtype)
            src[:len(group)] = [slot_of[recs[i].children[0]] for i in group]
            fac[:len(group)] = [recs[i].factors[0] for i in group]
            num_edges += len(group)
            pow_plans.append(PowerPlan(n, start, cpad, src, fac))

        levels.append(LevelPlan(sum_plan, prod_plans, pow_plans, sum_buckets,
                                fused_buckets))

    leaf_uid_to_slot = {recs[i].uid: slot_of[i] for i in leaf_recs}
    return LoweredGraph(
        num_slots=pool.top if reuse_slots else next_slot,
        num_leaves=num_leaf_slots,
        levels=levels,
        root_slots=np.asarray([slot_of[r] for r in root_recs], np.int32),
        leaf_uid_to_slot=leaf_uid_to_slot,
        const_slots=np.asarray([slot_of[i] for i in const_recs], np.int32),
        const_values=np.asarray([recs[i].value for i in const_recs], dtype),
        num_edges=num_edges,
    )
