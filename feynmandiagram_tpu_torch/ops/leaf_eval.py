"""Vectorized leaf evaluation: SoA leaf tables -> batched leaf values.

Port of ``feynmandiagram_tpu/ops/leaf_eval.py`` in the flat layout.
``LeafTables`` and ``leaf_tables_from_lowered`` are the reference's numpy
code, re-homed here because the original file imports jax.  The JAX
package runs the phase as a jnp chain that XLA fuses under ``jax.jit``;
here it is one hand-written CUDA kernel (``csrc/leaf_eval.cu``), ``leaf_eval``
(profiler scope ``leaf``), that walks a work list built once on the host
(``work_list``: the leaf rows grouped by basis row, packed into items of
about ``ITEM_LEAVES`` leaves).  Per basis row it computes ``loops[d] =
sum_l basis[n, l] * varK[d, l]`` (``l`` in order, the row's nonzero entries:
the LoopPool update), ``q2 = |loops|^2``, and where its leaves need them
``eps = q2 - kF^2`` and ``sp = softplus(-beta*eps)``; per leaf row the
value: a bare propagator ``sign * exp(-(eps*tau1 + sp))`` with ``(sign,
tau1)`` of ``tau = varT[out] - varT[in]`` (``models.free_fermion.
green_tau_parts``), a G counterterm the Bell recursion of
``models.free_fermion.green_derive_tower``, an interaction counterterm
``models.yukawa.interaction_derive``, a row of no group 1.  Every row of
the ``[num_leaves, batch]`` buffer (new, or the one the caller hands over)
is written, and nothing else.

The plain version, ``leaf_eval_plain``, is two passes over the whole
batch: ``leaf_prep_plain`` writes a scratch table ``[3 n_basis + 3
n_pairs, batch]`` (q2, eps, sp by basis row; sign, tau1, tau by distinct
pair of times) and ``leaf_values_plain`` computes each (kind, order) group
from it.  It repeats the kernel's operations in their order, so the two
agree bit for bit.

Both compute in ``compute_dtype``, float64 by default whatever the storage
type, and each leaf is rounded once, as it is stored.  The JAX package
computes in the storage type; in float32 the exponent ``-eps*tau`` of a
propagator then carries an absolute error of about ``|eps*tau|`` ulps,
which is the relative error of G: on Gamma4 at order 6 float32 leaves are
off by 2.4e-6 at the 99th percentile and 2.7e-5 at worst (on an H100),
enough to put a root past 1e-5 of the float64 pass, scale-relative.

On a CUDA tensor ``leaf_eval`` launches the kernel (built at first use by
``ops/build.py``) and counts the launch in ``leaf_eval.launches`` (a
captured one at each replay, ``utils.profiling.launched``); on a CPU
tensor it runs the plain version.  Nothing falls back: a failed build or
launch raises.  The tables are built and uploaded to the device once, by
``make_leaf_evaluator``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import build
from .kernels import on_device
from ..frontends import BareGreenId, BareInteractionId
from ..models.free_fermion import MAX_DERIV_ORDER, TAU_CUTOFF, _softplus_derivs
from ..models.yukawa import EIGHT_PI
from .dtypes import default_device, default_dtype
from ..utils.profiling import launched, scope


@dataclass
class LeafTables:
    """Static per-leaf metadata (SoA), slot-aligned with the lowered graph."""
    leaf_type: np.ndarray     # [L] int: 1=BareGreenId, 2=BareInteractionId
    g_order: np.ndarray       # [L] int: G-counterterm derivative order
    v_order: np.ndarray       # [L] int: V-counterterm derivative order
    tau_in: np.ndarray        # [L] int, 1-based tau index
    tau_out: np.ndarray       # [L] int, 1-based tau index
    loop_idx: np.ndarray      # [L] int, 0-based index into the loop basis
    loop_basis: np.ndarray    # [n_basis, max_loop_num]

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_type)

    @classmethod
    def from_arrays(cls, **arrays) -> "LeafTables":
        """Tables handed over as numpy arrays (for example the fields of the
        JAX package's ``LeafTables``); unknown or missing names raise."""
        names = {f.name for f in fields(cls)}
        if set(arrays) != names:
            raise ValueError(f"LeafTables needs exactly {sorted(names)}, "
                             f"got {sorted(arrays)}")
        return cls(**{k: np.asarray(v) for k, v in arrays.items()})


def leaf_tables_from_lowered(lowered, leaf_graphs: Dict[int, "Graph"],
                             max_loop_num: int) -> LeafTables:
    """Build LeafTables for the non-constant leaf slots of a LoweredGraph.

    ``leaf_graphs`` maps leaf uid -> leaf Graph (carrying DiagramId
    properties and derivative orders).

    A leaf's momentum takes the first basis row that is ``np.allclose`` to
    it (``rtol`` 1.49e-8, ``atol`` 1e-8), else becomes a new row.  The
    JAX package scans the rows one by one, which is quadratic in the
    leaves.  Here a momentum seen before, bit for bit, takes the row it
    took then (rows are only appended, so its first match cannot change),
    and any other is tested against all rows at once with ``np.isclose``,
    the test that ``np.allclose`` applies, so the tables are identical.
    """
    n_input = lowered.num_leaves - len(lowered.const_slots)
    leaf_type = np.zeros(n_input, np.int32)
    g_order = np.zeros(n_input, np.int32)
    v_order = np.zeros(n_input, np.int32)
    tau_in = np.ones(n_input, np.int32)
    tau_out = np.ones(n_input, np.int32)
    loop_idx = np.zeros(n_input, np.int32)
    basis = np.zeros((n_input, max_loop_num))   # rows 0 .. n_basis - 1 in use
    n_basis = 0
    row_of: Dict[bytes, int] = {}                # a momentum's bytes -> its row

    for uid, slot in lowered.leaf_uid_to_slot.items():
        if slot >= n_input:
            continue
        leaf = leaf_graphs[uid]
        diag_id = leaf.properties
        k = np.zeros(max_loop_num)
        extk = np.asarray(diag_id.extK, float)
        if len(extk) > max_loop_num:
            raise ValueError("extK longer than max_loop_num")
        k[:len(extk)] = extk
        key = k.tobytes()
        row = row_of.get(key)
        if row is None:
            hit = np.flatnonzero(np.isclose(basis[:n_basis], k, rtol=1.49e-8).all(axis=1))
            if hit.size:
                row = int(hit[0])
            else:
                row, basis[n_basis] = n_basis, k
                n_basis += 1
            row_of[key] = row
        loop_idx[slot] = row
        tau_in[slot], tau_out[slot] = diag_id.extT[0], diag_id.extT[1]
        orders = list(leaf.orders) + [0, 0]
        g_order[slot], v_order[slot] = orders[0], orders[1]
        if isinstance(diag_id, BareGreenId):
            leaf_type[slot] = 1
        elif isinstance(diag_id, BareInteractionId):
            leaf_type[slot] = 2
        else:
            raise ValueError(f"unsupported leaf id {type(diag_id)}")

    return LeafTables(leaf_type, g_order, v_order, tau_in, tau_out, loop_idx,
                      basis[:n_basis].copy())


# ---------------------------------------------------------------------------
# the phase's kernel, its plain version and their tables

# a leaf row's kind (csrc/leaf_eval.cu): no group, a bare propagator, a G
# counterterm, an interaction counterterm in either convention
KIND_ONE, KIND_G0, KIND_G_TOWER, KIND_V_LAMBDA, KIND_V_TAYLOR = range(5)
_V_KIND = {"lambda_power": KIND_V_LAMBDA, "taylor": KIND_V_TAYLOR}
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
COMPUTE_DTYPES = (torch.float32, torch.float64)
MAX_POLY_TERMS = 4   # terms of softplus^(k), k <= MAX_DERIV_ORDER
# a segment's meta word (csrc/leaf_eval.cu): its basis row's nonzero entries
# in the low 16 bits, then whether it has a basis row, needs eps, needs sp
SEG_NZ_MASK, SEG_HAS_BASIS, SEG_NEED_EPS, SEG_NEED_SP = 0xFFFF, 1 << 16, 1 << 17, 1 << 18
ITEM_LEAVES = 16     # leaf rows a work item holds (a basis row with more is split)
THREADS = 128        # the kernel's block: this many columns, one a thread
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on sm_90
MAX_DIM = 3          # components of a loop momentum the kernel takes
LAUNCHES_KEPT = 16   # prepared launches a leaf evaluator keeps, one a shape of operands


def _poly_table() -> np.ndarray:
    """``_softplus_derivs`` as the kernel takes it: int32 ``[MAX_DERIV_ORDER
    + 1, 1 + 3 MAX_POLY_TERMS]``, per order k the number of terms of
    softplus^(k), then ``(i, j, coef)`` per term, in the polynomial's order."""
    table = np.zeros((MAX_DERIV_ORDER + 1, 1 + 3 * MAX_POLY_TERMS), np.int32)
    for k, poly in enumerate(_softplus_derivs(MAX_DERIV_ORDER), start=1):
        terms = list(poly.items())
        if len(terms) > MAX_POLY_TERMS:
            raise AssertionError(f"softplus^({k}) has {len(terms)} terms")
        table[k, 0] = len(terms)
        for t, ((i, j), coef) in enumerate(terms):
            table[k, 1 + 3 * t:4 + 3 * t] = i, j, coef
    return table


@dataclass
class LeafPlan:
    """What the phase reads, built once from ``LeafTables``.

    The plain version's tables: ``basis`` ``[n_basis, n_loop]`` in the
    compute type; ``pair_in`` / ``pair_out`` the propagators' distinct pairs
    of times (0-based rows of ``varT``), int32; ``rows`` int32
    ``[num_leaves, 4]``, per leaf row its kind, derivative order, basis row
    and pair; ``groups`` the rows by (kind, order) as int64 index tensors
    ``(kind, order, rows, basis rows, pairs)``; ``polys`` the softplus
    derivatives' table (``_poly_table``, on the host).

    The kernel's work list (``work_list``): ``nz_l`` / ``nz_coef`` the
    basis rows' nonzero entries (loop index, int32; coefficient, compute
    type), row after row; ``segs`` int32 ``[n_seg, 4]``, per segment (a
    basis row, or none, and some of its leaf rows) its first nonzero entry,
    its meta word (``SEG_*``), its first and end leaf in ``leaves``;
    ``leaves`` int32 ``[num_leaves, 4]``, the leaf rows grouped by basis row
    in leaf order: the row of ``out``, ``kind | order << 8`` and the 0-based
    rows of ``varT`` of its times (in, out); ``items`` int32 ``[n_items,
    8]``, per work item its segments (begin, end), the nonzero entries that
    they read (begin, end) and its leaf records (begin, end; then two 0s,
    so that a row is two 16-byte loads), and ``item_max`` the largest item's
    segments, leaf rows and entries (a block stages one item at a time in
    shared memory).  ``n_tau`` is the rows of ``varT`` that the G leaves
    read."""
    basis: torch.Tensor
    pair_in: torch.Tensor
    pair_out: torch.Tensor
    rows: torch.Tensor
    groups: List[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]]
    polys: np.ndarray
    nz_l: torch.Tensor
    nz_coef: torch.Tensor
    segs: torch.Tensor
    leaves: torch.Tensor
    items: torch.Tensor
    item_max: Tuple[int, int, int]
    num_leaves: int
    n_tau: int
    beta: float
    kF2: float
    lam: float

    @property
    def n_basis(self) -> int:
        return self.basis.shape[0]

    @property
    def n_loop(self) -> int:
        return self.basis.shape[1]

    @property
    def n_pairs(self) -> int:
        return self.pair_in.shape[0]

    @property
    def n_items(self) -> int:
        return self.items.shape[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.basis.dtype

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def scratch_rows(self) -> int:
        """Rows of the plain version's scratch table: q2, eps, sp by basis
        row, then sign, tau1, tau by pair."""
        return 3 * self.n_basis + 3 * self.n_pairs


def work_list(rows: np.ndarray, typed: np.ndarray, basis: np.ndarray, tau: np.ndarray,
              item_leaves: int = ITEM_LEAVES):
    """The kernel's work list, on the host: ``(nz_l, nz_coef, segs, leaves,
    items)`` as ``LeafPlan`` holds them (numpy; ``nz_coef`` float64).

    ``rows`` is ``leaf_plan``'s ``[num_leaves, 4]`` (kind, order, basis row,
    pair), ``typed`` the rows of a group, ``basis`` the loop basis, ``tau``
    ``[num_leaves, 2]`` the 0-based rows of ``varT`` of each leaf's times
    (in, out).  The typed rows are grouped by basis row (a stable sort, so
    each basis row's leaves keep their order), the rows of no group come
    last; each group is cut into segments of at most ``item_leaves`` leaves,
    and the segments are packed in order into items of at most
    ``item_leaves`` leaves."""
    if item_leaves < 1:
        raise ValueError(f"item_leaves must be positive, got {item_leaves}")
    nz = basis != 0
    nz_start = np.concatenate([[0], np.cumsum(nz.sum(axis=1))]).astype(np.int64)
    typed_rows = np.flatnonzero(typed)
    order = typed_rows[np.argsort(rows[typed_rows, 2], kind="stable")]
    leaves = np.zeros((len(rows), 4), np.int32)
    segs, items, filled = [], [0], 0
    groups = []
    if order.size:
        cut = np.flatnonzero(np.diff(rows[order, 2])) + 1
        groups = np.split(order, cut)
    other = np.flatnonzero(~typed)
    if other.size:
        groups.append(other)
    pos = 0
    for members in groups:
        kinds = rows[members, 0]
        if typed[members[0]]:
            b = int(rows[members[0], 2])
            meta = int(nz[b].sum()) | SEG_HAS_BASIS
            if np.isin(kinds, (KIND_G0, KIND_G_TOWER)).any():
                meta |= SEG_NEED_EPS
            if (kinds == KIND_G0).any():
                meta |= SEG_NEED_SP
            first_nz = int(nz_start[b])
        else:
            meta, first_nz = 0, 0
        for k in range(0, len(members), item_leaves):
            part = members[k:k + item_leaves]
            if filled and filled + len(part) > item_leaves:
                items.append(len(segs))
                filled = 0
            segs.append((first_nz, meta, pos, pos + len(part)))
            leaves[pos:pos + len(part)] = np.stack(
                [part, rows[part, 0] | rows[part, 1] << 8, tau[part, 0], tau[part, 1]], axis=1)
            pos += len(part)
            filled += len(part)
    if segs:
        items.append(len(segs))
    segs = np.asarray(segs, np.int32).reshape(-1, 4)
    # per item its segments and the nonzero entries they read: consecutive
    # basis rows, or parts of one, so one range
    table = np.zeros((len(items) - 1, 8), np.int32)
    for i, (a, b) in enumerate(zip(items[:-1], items[1:])):
        part = segs[a:b][segs[a:b, 1] & SEG_HAS_BASIS != 0]
        lo = part[:, 0].min() if len(part) else 0
        hi = (part[:, 0] + (part[:, 1] & SEG_NZ_MASK)).max() if len(part) else 0
        table[i, :6] = a, b, lo, hi, segs[a, 2], segs[b - 1, 3]
    nz_l = np.nonzero(nz)[1].astype(np.int32)
    return nz_l, basis[nz].astype(np.float64), segs, leaves, table


def leaf_plan(tables: LeafTables, *, beta: float, kF: float, lam: float, device,
              compute_dtype=torch.float64,
              interaction_convention: str = "lambda_power",
              item_leaves: int = ITEM_LEAVES) -> LeafPlan:
    """The ``LeafPlan`` of ``tables``, uploaded to ``device``; its work list
    holds ``item_leaves`` leaf rows an item.  Raises ``ValueError`` on a G
    derivative order above ``MAX_DERIV_ORDER``, an unknown convention or
    compute type."""
    if interaction_convention not in _V_KIND:
        raise ValueError(f"unknown convention {interaction_convention}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    g_leaf = tables.leaf_type == 1
    v_leaf = tables.leaf_type == 2
    if g_leaf.any() and tables.g_order[g_leaf].max() > MAX_DERIV_ORDER:
        raise ValueError(f"derivative order {int(tables.g_order[g_leaf].max())} not supported")
    # the propagators' pairs of times (0-based; 1-based in the tables)
    tau = np.zeros((tables.num_leaves, 2), np.int64)
    tau[g_leaf] = np.stack([tables.tau_in, tables.tau_out], axis=1)[g_leaf] - 1
    pairs, pair_of = np.unique(tau[g_leaf].T, axis=1, return_inverse=True)
    rows = np.zeros((tables.num_leaves, 4), np.int32)
    rows[g_leaf, 0] = np.where(tables.g_order[g_leaf] == 0, KIND_G0, KIND_G_TOWER)
    rows[g_leaf, 1] = tables.g_order[g_leaf]
    rows[g_leaf, 3] = pair_of.reshape(-1)
    rows[v_leaf, 0] = _V_KIND[interaction_convention]
    rows[v_leaf, 1] = tables.v_order[v_leaf]
    typed = g_leaf | v_leaf
    rows[typed, 2] = tables.loop_idx[typed]
    basis = np.asarray(tables.loop_basis, np.float64)

    def dev(a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    groups = []
    for kind, order in sorted({(int(k), int(o)) for k, o in rows[typed, :2].tolist()}):
        idx = np.flatnonzero((rows[:, 0] == kind) & (rows[:, 1] == order) & typed)
        groups.append((kind, order, dev(idx), dev(rows[idx, 2]), dev(rows[idx, 3])))
    other = np.flatnonzero(~typed)
    if other.size:
        groups.append((KIND_ONE, 0, dev(other), dev(rows[other, 2]), dev(rows[other, 3])))
    nz_l, nz_coef, segs, leaves, items = work_list(rows, typed, basis, tau, item_leaves)
    item_max = tuple(max(int(np.diff(items[:, k:k + 2]).max(initial=0)), floor)
                     for k, floor in ((0, 1), (4, 1), (2, 0)))
    return LeafPlan(basis=dev(basis, compute_dtype),
                    pair_in=dev(pairs[0], torch.int32), pair_out=dev(pairs[1], torch.int32),
                    rows=dev(rows, torch.int32), groups=groups, polys=_poly_table(),
                    nz_l=dev(nz_l, torch.int32), nz_coef=dev(nz_coef, compute_dtype),
                    segs=dev(segs, torch.int32), leaves=dev(leaves, torch.int32),
                    items=dev(items, torch.int32), item_max=item_max,
                    num_leaves=tables.num_leaves,
                    n_tau=int(tau[g_leaf].max()) + 1 if g_leaf.any() else 0,
                    beta=beta, kF2=kF ** 2, lam=lam)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.fd_leaf_eval.restype = i
    lib.fd_leaf_eval.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, d, d, d, d, p,
                                 i, i, i, p]
    lib.fd_leaf_op_rate.restype = i
    lib.fd_leaf_op_rate.argtypes = [i, i, p, i, i, i, p]


def _check_device(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for CUDA; any
    other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device.type}")
    return False


def _check_samples(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor, batch: int) -> None:
    for name, t, types in (("varK", varK, COMPUTE_DTYPES), ("varT", varT, (varK.dtype,))):
        if t.dtype not in types or not t.is_contiguous() or t.device != plan.device:
            raise ValueError(f"{name} must be a contiguous tensor of {types} on {plan.device}, "
                             f"got {t.dtype} on {t.device}")
    if varK.dim() != 3 or varK.shape[0] < 1 or varK.shape[1] != plan.n_loop \
            or varK.shape[2] != batch:
        raise ValueError(f"varK is {tuple(varK.shape)}, expected [dim, {plan.n_loop}, {batch}]")
    if varT.dim() != 2 or varT.shape[0] < plan.n_tau or varT.shape[1] != batch:
        raise ValueError(f"varT is {tuple(varT.shape)}, expected [num_tau >= {plan.n_tau}, "
                         f"{batch}]")


def _check_out(plan: LeafPlan, out: torch.Tensor, batch: int) -> None:
    if out.dtype not in _TYPE_CODE or out.device != plan.device \
            or tuple(out.shape) != (plan.num_leaves, batch) \
            or (out.numel() and out.stride() != (batch, 1)):
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)} on {out.device}, expected a "
                         f"row-major [{plan.num_leaves}, {batch}] tensor of one of "
                         f"{tuple(_TYPE_CODE)} on {plan.device}")


def _check_scratch(plan: LeafPlan, scratch: torch.Tensor) -> None:
    if scratch.dtype != plan.compute_dtype or scratch.device != plan.device \
            or not scratch.is_contiguous() or scratch.dim() != 2 \
            or scratch.shape[0] != plan.scratch_rows():
        raise ValueError(f"scratch must be a contiguous {plan.compute_dtype} "
                         f"[{plan.scratch_rows()}, batch] tensor on {plan.device}")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)`` as the kernel computes it: ``max(x, 0) +
    log1p(exp(-|x|))``, the arithmetic of ``torch.logaddexp``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def leaf_prep_plain(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
                    scratch: torch.Tensor) -> None:
    """The plain version's first half, on any device: the scratch table
    ``[3 n_basis + 3 n_pairs, batch]`` of the samples ``varK`` [dim, n_loop,
    batch] and ``varT`` [num_tau, batch], both float32 or both float64, each
    element widened (or rounded) to the compute type: q2, eps, sp by basis
    row, then sign, tau1, tau by pair of times, in the kernel's operations
    and order.  A loop sum starts from 0 and skips the basis row's entries
    that are exactly 0, as the kernel does."""
    _check_samples(plan, varK, varT, scratch.shape[-1])
    _check_scratch(plan, scratch)
    varK, varT = varK.to(plan.compute_dtype), varT.to(plan.compute_dtype)
    nb, npair = plan.n_basis, plan.n_pairs
    if nb:
        q2 = None
        for d in range(varK.shape[0]):
            acc = torch.zeros_like(scratch[:nb])
            for l in range(plan.n_loop):
                b = plan.basis[:, l, None]
                acc = torch.where(b != 0, acc + b * varK[d, l], acc)
            q2 = acc * acc if q2 is None else q2 + acc * acc
        scratch[:nb] = q2
        if npair:
            eps = q2 - plan.kF2
            scratch[nb:2 * nb] = eps
            scratch[2 * nb:3 * nb] = _softplus(-plan.beta * eps)
    if npair:
        tau = varT[plan.pair_out.long()] - varT[plan.pair_in.long()]
        tau = torch.where(tau.abs() < TAU_CUTOFF, tau.new_full((), -TAU_CUTOFF), tau)
        pos = tau > 0
        base = 3 * nb
        scratch[base:base + npair] = pos.to(tau.dtype) * 2 - 1
        scratch[base + npair:base + 2 * npair] = torch.where(pos, tau, tau + plan.beta)
        scratch[base + 2 * npair:base + 3 * npair] = tau


def _green_tower(tau: torch.Tensor, eps: torch.Tensor, order: int, beta: float,
                 polys: np.ndarray) -> torch.Tensor:
    """``(-1)^n / n! d^n G / d eps^n`` in the kernel's operations and order
    (``models.free_fermion.green_derive_tower``'s closed form)."""
    pos = tau > 0
    b = torch.full_like(tau, beta)
    c = torch.where(pos, -b, b)
    u = c * eps
    g = (pos.to(tau.dtype) * 2 - 1) * torch.exp((-eps) * tau - _softplus(u))
    s = 1.0 / (1.0 + torch.exp(-u))
    sbar = 1.0 / (1.0 + torch.exp(u))
    dphi = [(-tau) - c * s]
    ck = c
    for k in range(2, order + 1):
        ck = ck * c
        sp = None
        for t in range(polys[k, 0]):
            i, j, coef = polys[k, 1 + 3 * t:4 + 3 * t].tolist()
            p = s
            for _ in range(i - 1):
                p = p * s
            for _ in range(j):
                p = p * sbar
            sp = p * coef if sp is None else sp + p * coef
        dphi.append((-ck) * sp)
    bell = [torch.ones_like(tau)]
    for m in range(order):
        acc = (math.comb(m, 0) * bell[m]) * dphi[0]
        for k in range(1, m + 1):
            acc = acc + (math.comb(m, k) * bell[m - k]) * dphi[k]
        bell.append(acc)
    return (g * bell[order]) * ((-1.0) ** order / math.factorial(order))


def leaf_values_plain(plan: LeafPlan, scratch: torch.Tensor, out: torch.Tensor) -> None:
    """The plain version's second half, on any device: per (kind, order)
    group the kernel's operations in its order on the scratch table that
    ``leaf_prep_plain`` wrote, rounded once into the group's rows of
    ``out``."""
    _check_scratch(plan, scratch)
    _check_out(plan, out, scratch.shape[1])
    nb, npair = plan.n_basis, plan.n_pairs
    for kind, order, rows, brow, pair in plan.groups:
        if kind == KIND_G0:
            vals = torch.exp(-(scratch[nb + brow] * scratch[3 * nb + npair + pair]
                               + scratch[2 * nb + brow])) * scratch[3 * nb + pair]
        elif kind == KIND_G_TOWER:
            vals = _green_tower(scratch[3 * nb + 2 * npair + pair], scratch[nb + brow], order,
                                plan.beta, plan.polys)
        elif kind in (KIND_V_LAMBDA, KIND_V_TAYLOR):
            inv = 1.0 / (scratch[brow] + plan.lam)
            if kind == KIND_V_LAMBDA:
                ratio, vals = plan.lam * inv, EIGHT_PI * inv
                for _ in range(order):
                    vals = vals * ratio
            else:
                vals = (-EIGHT_PI if order % 2 else EIGHT_PI) * inv
                for _ in range(order):
                    vals = vals * inv
        else:
            out[rows] = 1
            continue
        out[rows] = vals.to(out.dtype)


def leaf_eval_plain(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
                    out: torch.Tensor) -> None:
    """Plain PyTorch version of ``leaf_eval``, on any device:
    ``leaf_prep_plain`` into a scratch table, then ``leaf_values_plain``
    into ``out``."""
    batch = out.shape[-1]
    _check_samples(plan, varK, varT, batch)
    _check_out(plan, out, batch)
    scratch = torch.empty((plan.scratch_rows(), batch), dtype=plan.compute_dtype,
                          device=out.device)
    leaf_prep_plain(plan, varK, varT, scratch)
    leaf_values_plain(plan, scratch, out)


def _smem_bytes(plan: LeafPlan, rows: int) -> int:
    """A block's shared memory (csrc/leaf_eval.cu): its samples, rows x
    ``THREADS`` of the compute type, then the largest item's entries,
    segments and leaf records, each part 16-byte aligned."""
    def r16(n: int) -> int:
        return -(-n // 16) * 16

    size = plan.basis.element_size()
    segs, leaves, nz = plan.item_max
    return r16(rows * THREADS * size) + r16(nz * size) + 16 * (segs + leaves) + r16(4 * nz)


class LeafLaunch:
    """``leaf_eval``'s launch prepared once for one shape of its operands:
    built from ``plan`` and operands ``varK``, ``varT`` and ``out`` whose
    shapes, dtypes, devices and layouts it checks (``leaf_eval``'s checks),
    it keeps the C call's arguments with the three addresses of a call left
    open.  ``launch(varK, varT, out)`` then launches on operands of those
    same shapes, dtypes, devices and layouts, unchecked, on the current
    stream, and counts the launch in ``leaf_eval.launches``."""

    def __init__(self, plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
                 out: torch.Tensor):
        batch = out.shape[-1]
        _check_samples(plan, varK, varT, batch)
        _check_out(plan, out, batch)
        if varK.shape[0] > MAX_DIM:
            raise ValueError(f"the kernel takes loop momenta of at most {MAX_DIM} components, "
                             f"got {varK.shape[0]}")
        smem = _smem_bytes(plan, varK.shape[0] * plan.n_loop + varT.shape[0])
        if smem > SMEM_LIMIT:
            raise ValueError(f"a block takes {smem} bytes of shared memory, more than "
                             f"{SMEM_LIMIT}")
        self.device = out.device
        self.empty = not plan.num_leaves
        self._fn = None if self.empty else build.load("leaf_eval", _bind).fd_leaf_eval
        self._tables = (plan.nz_l.data_ptr(), plan.nz_coef.data_ptr(), plan.segs.data_ptr(),
                        plan.leaves.data_ptr(), plan.items.data_ptr())
        self._rest = (plan.n_items, *plan.item_max, varK.shape[0], plan.n_loop, varT.shape[0],
                      batch, plan.kF2, plan.beta, plan.lam, TAU_CUTOFF, plan.polys.ctypes.data,
                      _TYPE_CODE[plan.compute_dtype], _TYPE_CODE[varK.dtype],
                      _TYPE_CODE[out.dtype])
        self._polys = plan.polys     # the host table the call reads

    def launch(self, varK: torch.Tensor, varT: torch.Tensor, out: torch.Tensor) -> None:
        if self.empty:
            return
        with on_device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self._fn(varK.data_ptr(), varT.data_ptr(), *self._tables, out.data_ptr(),
                           *self._rest, stream)
        if err != 0:
            raise RuntimeError(f"leaf_eval launch failed: cudaError {err}")
        launched(leaf_eval)


def leaf_eval(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
              out: torch.Tensor) -> None:
    """Write every leaf row of ``out`` [num_leaves, batch] (row-major, of
    storage type float32, float64 or bfloat16) for the samples ``varK``
    [dim, n_loop, batch] and ``varT`` [num_tau, batch], both float32 or both
    float64, in one pass over ``plan``'s work list.

    A CUDA ``out`` launches ``leaf_eval_kernel`` on the current stream (and
    counts it in ``leaf_eval.launches``): blocks of ``THREADS`` columns, and
    a grid along the items of the kernel's own choice (``csrc/leaf_eval.cu``:
    ``launch``), after every check of ``LeafLaunch``.  It allocates nothing;
    loop momenta of more than ``MAX_DIM`` components raise.  A CPU ``out``
    runs ``leaf_eval_plain``; a failed build or launch raises."""
    if _check_device("leaf_eval", out):
        leaf_eval_plain(plan, varK, varT, out)
        return
    LeafLaunch(plan, varK, varT, out).launch(varK, varT, out)


leaf_eval.launches = 0
leaf_eval.symbol = "leaf_eval_kernel"

# the operations whose issue rate op_rate times (csrc/leaf_eval.cu RateOp)
RATE_OPS = ("add", "mul", "exp", "log1p", "div", "cvt")


def op_rate(op: str, out: torch.Tensor, blocks: int, threads: int, iters: int) -> None:
    """Launch the micro-kernel that times one operation of the leaf phase:
    ``blocks x threads`` threads, each running four independent chains of
    ``iters`` steps of ``op`` (one of ``RATE_OPS``: ``exp`` is ``x ->
    -exp(x)``, ``log1p`` ``x -> log1p(x) + 0.3``, ``div`` ``x -> 1.5 / x``,
    ``cvt`` a float32 -> compute-type conversion added to the chain) in
    ``out``'s type (float32 or float64), the chains' sums into ``out``
    ``[blocks * threads]`` on the card.  Counts no launch."""
    if out.device.type != "cuda" or out.dtype not in COMPUTE_DTYPES or not out.is_contiguous() \
            or out.numel() != blocks * threads or op not in RATE_OPS:
        raise ValueError(f"op_rate takes one of {RATE_OPS} and a contiguous float32 or float64 "
                         f"cuda tensor of blocks * threads elements")
    lib = build.load("leaf_eval", _bind)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.fd_leaf_op_rate(RATE_OPS.index(op), _TYPE_CODE[out.dtype], out.data_ptr(),
                                  blocks, threads, iters, stream)
    if err != 0:
        raise RuntimeError(f"op_rate launch failed: cudaError {err}")


def make_leaf_evaluator(tables: LeafTables, *, beta: float, kF: float, lam: float,
                        device=None, dtype=None, compute_dtype=torch.float64,
                        interaction_convention: str = "lambda_power"):
    """Build ``f(varK, varT, out=None) -> leaf_values[num_leaves, batch]``.

    - ``varK``: [dim, max_loop_num, batch] sampled loop momenta
    - ``varT``: [num_tau, batch] sampled imaginary times
    - ``out``: where to write the values, a row-major ``[num_leaves,
      batch]`` tensor of ``dtype`` on ``device`` (the leaf rows of a weight
      buffer, ``ops.evaluator.StaticPass.leaves``); a new tensor if
      ``None``.  Every row is written.  On CUDA a call allocates nothing
      but, without ``out``, the output, so a CUDA graph can capture it.

    The values are computed in ``compute_dtype`` (float64 or float32) and
    rounded once to ``dtype``; ``compute_dtype=dtype`` computes in the
    storage type, as the JAX package does.  A call is one ``leaf_eval``
    (profiler scope ``leaf``): on the CPU its plain version; on CUDA one
    launch of its kernel from the ``LeafLaunch`` prepared at the first call
    of the operands' shapes, dtypes and layout and kept (the newest
    ``LAUNCHES_KEPT``), so a call repeats none of its checks.  The samples go
    to the device in the scope ``inputs``.  ``f.plan`` is the ``LeafPlan``.
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    if dtype not in _TYPE_CODE:
        raise ValueError(f"dtype must be one of {tuple(_TYPE_CODE)}, got {dtype}")
    plan = leaf_plan(tables, beta=beta, kF=kF, lam=lam, device=device,
                     compute_dtype=compute_dtype, interaction_convention=interaction_convention)

    def inputs(x) -> torch.Tensor:
        x = torch.as_tensor(x, device=device)
        return (x if x.dtype in COMPUTE_DTYPES else x.to(compute_dtype)).contiguous()

    launches: Dict[tuple, LeafLaunch] = {}

    def evaluate(varK, varT, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        with scope("inputs"):
            varK = inputs(varK)
            varT = inputs(varT).to(varK.dtype)
        batch = varK.shape[-1]
        if out is None:
            out = torch.empty((tables.num_leaves, batch), dtype=dtype, device=device)
        elif out.shape != (tables.num_leaves, batch) or out.dtype != dtype:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, expected {dtype} "
                             f"{(tables.num_leaves, batch)}")
        with scope("leaf"):
            if device.type != "cuda":
                leaf_eval(plan, varK, varT, out)
                return out
            key = (varK.shape, varT.shape, varK.dtype, out.device, out.stride())
            launch = launches.get(key)
            if launch is None:
                if len(launches) >= LAUNCHES_KEPT:
                    del launches[next(iter(launches))]
                launch = launches[key] = LeafLaunch(plan, varK, varT, out)
            launch.launch(varK, varT, out)
        return out

    evaluate.plan = plan
    return evaluate
