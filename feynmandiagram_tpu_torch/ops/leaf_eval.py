"""Vectorized leaf evaluation: SoA leaf tables -> batched leaf values.

Port of ``feynmandiagram_tpu/ops/leaf_eval.py`` in the flat layout.
``LeafTables`` and ``leaf_tables_from_lowered`` are the reference's numpy
code, re-homed here because the original file imports jax.  The JAX
package runs the phase as a jnp chain that XLA fuses under ``jax.jit``;
here it is two hand-written CUDA kernels (``csrc/leaf_eval.cu``), each
with a plain PyTorch version that repeats its arithmetic in its order:

1. ``leaf_prep`` (profiler scope ``loops``), over the basis rows and the
   propagators' pairs of times: ``loops[d] = sum_l basis[n, l] *
   varK[d, l]`` (``l`` in order: the LoopPool update), ``q2 = |loops|^2``,
   ``eps = q2 - kF^2`` and ``sp = softplus(-beta*eps)`` per basis row, and
   ``(sign, tau1, tau)`` of ``tau = varT[out] - varT[in]`` per pair
   (``models.free_fermion.green_tau_parts``), into a scratch table
   ``[3 n_basis + 3 n_pairs, batch]``;
2. ``leaf_values`` (scope ``leaf``), one value per leaf row of the
   ``[num_leaves, batch]`` buffer (new, or the one the caller hands over),
   every row written: a bare propagator ``sign * exp(-(eps*tau1 + sp))``,
   a G counterterm the Bell recursion of
   ``models.free_fermion.green_derive_tower``, an interaction counterterm
   ``models.yukawa.interaction_derive``, a row of no group 1.

Both compute in ``compute_dtype``, float64 by default whatever the storage
type, and each leaf is rounded once, as it is stored.  The JAX package
computes in the storage type; in float32 the exponent ``-eps*tau`` of a
propagator then carries an absolute error of about ``|eps*tau|`` ulps,
which is the relative error of G: on Gamma4 at order 6 float32 leaves are
off by 2.4e-6 at the 99th percentile and 2.7e-5 at worst (on an H100),
enough to put a root past 1e-5 of the float64 pass, scale-relative.

On a CUDA tensor each wrapper launches its kernel (built at first use by
``ops/build.py``) and counts the launch in ``leaf_prep.launches`` /
``leaf_values.launches``; on a CPU tensor it runs its plain version.
Nothing falls back: a failed build or launch raises.  The tables are
built and uploaded to the device once, by ``make_leaf_evaluator``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import build
from ..frontends import BareGreenId, BareInteractionId
from ..models.free_fermion import MAX_DERIV_ORDER, TAU_CUTOFF, _softplus_derivs
from ..models.yukawa import EIGHT_PI
from .dtypes import default_device, default_dtype
from ..utils.profiling import scope


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
# the two kernels of the phase, their plain versions and their tables

# a leaf row's kind (csrc/leaf_eval.cu): no group, a bare propagator, a G
# counterterm, an interaction counterterm in either convention
KIND_ONE, KIND_G0, KIND_G_TOWER, KIND_V_LAMBDA, KIND_V_TAYLOR = range(5)
_V_KIND = {"lambda_power": KIND_V_LAMBDA, "taylor": KIND_V_TAYLOR}
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
COMPUTE_DTYPES = (torch.float32, torch.float64)
MAX_POLY_TERMS = 4   # terms of softplus^(k), k <= MAX_DERIV_ORDER


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
    """What both kernels of the phase read, built once from ``LeafTables``.

    ``basis`` ``[n_basis, n_loop]`` in the compute type; ``pair_in`` /
    ``pair_out`` the propagators' distinct pairs of times (0-based rows of
    ``varT``), int32 for the kernel; ``rows`` int32 ``[num_leaves, 4]``, per
    leaf row its kind, derivative order, basis row and pair; ``groups`` the
    rows by (kind, order) as int64 index tensors ``(kind, order, rows,
    basis rows, pairs)``, which the plain version gathers through; ``polys``
    the softplus derivatives' table (``_poly_table``, on the host)."""
    basis: torch.Tensor
    pair_in: torch.Tensor
    pair_out: torch.Tensor
    rows: torch.Tensor
    groups: List[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]]
    polys: np.ndarray
    num_leaves: int
    beta: float
    kF2: float
    lam: float

    @property
    def n_basis(self) -> int:
        return self.basis.shape[0]

    @property
    def n_pairs(self) -> int:
        return self.pair_in.shape[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.basis.dtype

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def scratch_rows(self) -> int:
        """Rows of the scratch table: q2, eps, sp by basis row, then sign,
        tau1, tau by pair."""
        return 3 * self.n_basis + 3 * self.n_pairs


def leaf_plan(tables: LeafTables, *, beta: float, kF: float, lam: float, device,
              compute_dtype=torch.float64,
              interaction_convention: str = "lambda_power") -> LeafPlan:
    """The ``LeafPlan`` of ``tables``, uploaded to ``device``.  Raises
    ``ValueError`` on a G derivative order above ``MAX_DERIV_ORDER``, an
    unknown convention or compute type."""
    if interaction_convention not in _V_KIND:
        raise ValueError(f"unknown convention {interaction_convention}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    g_leaf = tables.leaf_type == 1
    v_leaf = tables.leaf_type == 2
    if g_leaf.any() and tables.g_order[g_leaf].max() > MAX_DERIV_ORDER:
        raise ValueError(f"derivative order {int(tables.g_order[g_leaf].max())} not supported")
    # the propagators' pairs of times (0-based; 1-based in the tables)
    pairs, pair_of = np.unique(np.stack([tables.tau_in, tables.tau_out])[:, g_leaf] - 1,
                               axis=1, return_inverse=True)
    rows = np.zeros((tables.num_leaves, 4), np.int32)
    rows[g_leaf, 0] = np.where(tables.g_order[g_leaf] == 0, KIND_G0, KIND_G_TOWER)
    rows[g_leaf, 1] = tables.g_order[g_leaf]
    rows[g_leaf, 3] = pair_of.reshape(-1)
    rows[v_leaf, 0] = _V_KIND[interaction_convention]
    rows[v_leaf, 1] = tables.v_order[v_leaf]
    typed = g_leaf | v_leaf
    rows[typed, 2] = tables.loop_idx[typed]

    def dev(a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    groups = []
    for kind, order in sorted({(int(k), int(o)) for k, o in rows[typed, :2].tolist()}):
        idx = np.flatnonzero((rows[:, 0] == kind) & (rows[:, 1] == order) & typed)
        groups.append((kind, order, dev(idx), dev(rows[idx, 2]), dev(rows[idx, 3])))
    other = np.flatnonzero(~typed)
    if other.size:
        groups.append((KIND_ONE, 0, dev(other), dev(rows[other, 2]), dev(rows[other, 3])))
    return LeafPlan(basis=dev(np.asarray(tables.loop_basis, np.float64), compute_dtype),
                    pair_in=dev(pairs[0], torch.int32), pair_out=dev(pairs[1], torch.int32),
                    rows=dev(rows, torch.int32), groups=groups, polys=_poly_table(),
                    num_leaves=tables.num_leaves, beta=beta, kF2=kF ** 2, lam=lam)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.fd_leaf_prep.restype = i
    lib.fd_leaf_prep.argtypes = [p, p, p, p, p, p, i, i, i, i, ll, d, d, d, i, i, p]
    lib.fd_leaf_values.restype = i
    lib.fd_leaf_values.argtypes = [p, p, p, ll, ll, ll, ll, d, d, p, i, i, p]


def _check_device(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for CUDA; any
    other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device.type}")
    return False


def _check_prep(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
                scratch: torch.Tensor) -> None:
    batch = scratch.shape[-1]
    for name, t, types in (("varK", varK, COMPUTE_DTYPES), ("varT", varT, (varK.dtype,)),
                           ("scratch", scratch, (plan.compute_dtype,))):
        if t.dtype not in types or not t.is_contiguous() or t.device != plan.device:
            raise ValueError(f"{name} must be a contiguous tensor of {types} on {plan.device}, "
                             f"got {t.dtype} on {t.device}")
    if varK.dim() != 3 or varK.shape[1] != plan.basis.shape[1] or varK.shape[2] != batch:
        raise ValueError(f"varK is {tuple(varK.shape)}, expected [dim, {plan.basis.shape[1]}, "
                         f"{batch}]")
    if varT.dim() != 2 or varT.shape[1] != batch:
        raise ValueError(f"varT is {tuple(varT.shape)}, expected [num_tau, {batch}]")
    if scratch.dim() != 2 or scratch.shape[0] != plan.scratch_rows():
        raise ValueError(f"scratch is {tuple(scratch.shape)}, expected "
                         f"[{plan.scratch_rows()}, batch]")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)`` as the kernel computes it: ``max(x, 0) +
    log1p(exp(-|x|))``, the arithmetic of ``torch.logaddexp``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def leaf_prep_plain(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
                    scratch: torch.Tensor) -> None:
    """Plain PyTorch version of ``leaf_prep``, on any device: the kernel's
    operations in its order, into ``scratch``."""
    _check_prep(plan, varK, varT, scratch)
    varK, varT = varK.to(plan.compute_dtype), varT.to(plan.compute_dtype)
    nb, npair = plan.n_basis, plan.n_pairs
    if nb:
        q2 = None
        for d in range(varK.shape[0]):
            acc = plan.basis[:, 0, None] * varK[d, 0]
            for l in range(1, plan.basis.shape[1]):
                acc = acc + plan.basis[:, l, None] * varK[d, l]
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


def leaf_prep(plan: LeafPlan, varK: torch.Tensor, varT: torch.Tensor,
              scratch: torch.Tensor) -> None:
    """Write the scratch table of ``plan`` for the samples ``varK`` [dim,
    n_loop, batch] and ``varT`` [num_tau, batch], both float32 or both
    float64 (each element widened, or rounded, to the compute type as it is
    read), into ``scratch`` of the compute type.
    A CUDA ``scratch`` launches the kernel on the current stream (and
    counts it in ``leaf_prep.launches``), a CPU one runs
    ``leaf_prep_plain``."""
    if _check_device("leaf_prep", scratch):
        leaf_prep_plain(plan, varK, varT, scratch)
        return
    _check_prep(plan, varK, varT, scratch)
    lib = build.load("leaf_eval", _bind)
    with torch.cuda.device(scratch.device):
        stream = torch.cuda.current_stream(scratch.device).cuda_stream
        err = lib.fd_leaf_prep(
            plan.basis.data_ptr(), varK.data_ptr(), varT.data_ptr(), plan.pair_in.data_ptr(),
            plan.pair_out.data_ptr(), scratch.data_ptr(), plan.n_basis, plan.n_pairs,
            plan.basis.shape[1], varK.shape[0], scratch.shape[1], plan.kF2, plan.beta,
            TAU_CUTOFF, _TYPE_CODE[plan.compute_dtype], _TYPE_CODE[varK.dtype], stream)
    if err != 0:
        raise RuntimeError(f"leaf_prep launch failed: cudaError {err}")
    leaf_prep.launches += 1


leaf_prep.launches = 0


def _check_values(plan: LeafPlan, scratch: torch.Tensor, out: torch.Tensor) -> None:
    if scratch.dtype != plan.compute_dtype or scratch.device != plan.device \
            or not scratch.is_contiguous() or scratch.dim() != 2 \
            or scratch.shape[0] != plan.scratch_rows():
        raise ValueError(f"scratch must be a contiguous {plan.compute_dtype} "
                         f"[{plan.scratch_rows()}, batch] tensor on {plan.device}")
    if out.dtype not in _TYPE_CODE or out.device != plan.device \
            or tuple(out.shape) != (plan.num_leaves, scratch.shape[1]) \
            or (out.numel() and out.stride() != (scratch.shape[1], 1)):
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)} on {out.device}, expected a "
                         f"row-major [{plan.num_leaves}, {scratch.shape[1]}] tensor of one of "
                         f"{tuple(_TYPE_CODE)} on {plan.device}")


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
    """Plain PyTorch version of ``leaf_values``, on any device: per (kind,
    order) group the kernel's operations in its order, rounded once into
    the group's rows of ``out``."""
    _check_values(plan, scratch, out)
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


def leaf_values(plan: LeafPlan, scratch: torch.Tensor, out: torch.Tensor) -> None:
    """Write every leaf row of ``out`` [num_leaves, batch] (row-major, of
    storage type float32, float64 or bfloat16) from the scratch table that
    ``leaf_prep`` wrote.  A CUDA ``out`` launches the kernel on the current
    stream (and counts it in ``leaf_values.launches``), a CPU one runs
    ``leaf_values_plain``."""
    if _check_device("leaf_values", out):
        leaf_values_plain(plan, scratch, out)
        return
    _check_values(plan, scratch, out)
    if not plan.num_leaves:
        return
    lib = build.load("leaf_eval", _bind)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.fd_leaf_values(
            scratch.data_ptr(), plan.rows.data_ptr(), out.data_ptr(), plan.num_leaves,
            plan.n_basis, plan.n_pairs, scratch.shape[1], plan.beta, plan.lam,
            plan.polys.ctypes.data, _TYPE_CODE[out.dtype], _TYPE_CODE[plan.compute_dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"leaf_values launch failed: cudaError {err}")
    leaf_values.launches += 1


leaf_values.launches = 0


def make_leaf_evaluator(tables: LeafTables, *, beta: float, kF: float, lam: float,
                        device=None, dtype=None, compute_dtype=torch.float64,
                        interaction_convention: str = "lambda_power"):
    """Build ``f(varK, varT, out=None) -> leaf_values[num_leaves, batch]``.

    - ``varK``: [dim, max_loop_num, batch] sampled loop momenta
    - ``varT``: [num_tau, batch] sampled imaginary times
    - ``out``: where to write the values, a row-major ``[num_leaves,
      batch]`` tensor of ``dtype`` on ``device`` (the leaf rows of a static
      weight buffer, ``ops.evaluator.StaticPass.leaves``); a new tensor if
      ``None``.  Every row is written.  A call allocates the scratch table
      and, without ``out``, the output, nothing else, so a CUDA graph can
      capture it.

    The values are computed in ``compute_dtype`` (float64 or float32) and
    rounded once to ``dtype``; ``compute_dtype=dtype`` computes in the
    storage type, as the JAX package does.  On CUDA a call is the two
    launches ``leaf_prep`` and ``leaf_values``; on the CPU their plain
    versions.  ``f.plan`` is the ``LeafPlan``.
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

    def evaluate(varK, varT, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        varK = inputs(varK)
        varT = inputs(varT).to(varK.dtype)
        batch = varK.shape[-1]
        if out is None:
            out = torch.empty((tables.num_leaves, batch), dtype=dtype, device=device)
        elif out.shape != (tables.num_leaves, batch) or out.dtype != dtype:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, expected {dtype} "
                             f"{(tables.num_leaves, batch)}")
        scratch = torch.empty((plan.scratch_rows(), batch), dtype=compute_dtype, device=device)
        if plan.scratch_rows():
            with scope("loops"):
                leaf_prep(plan, varK, varT, scratch)
        with scope("leaf"):
            leaf_values(plan, scratch, out)
        return out

    evaluate.plan = plan
    return evaluate
