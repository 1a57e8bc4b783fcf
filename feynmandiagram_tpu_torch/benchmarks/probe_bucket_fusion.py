"""Formulations of the padded sum bucket on one GPU: the port of
``benchmarks/probe_bucket_fusion.py``.

The graph phase's hot operation is ``out[c, :] = sum_a fac[a, c] *
w[idx[a, c], :]``, ``w`` a ``[S, B]`` buffer in device memory.  The JAX
script times the ways XLA can be asked for it; this times their PyTorch
counterparts beside the port's level kernel, at the script's shapes: S =
32768, B = 4096, arity A = 8, count C = 8192 (E = A * C = 65536 edges),
float32, data from numpy's ``default_rng(0)`` in the script's order.  The
formulations, with the script's lines:

1. ``baseline``: ``(w[idx2] * fac2[:, :, None]).sum(0)`` (``:44-46``);
2. ``unrolled``: a gather-multiply-add per arity slot (``:49-54``);
3. ``scanned``: the per-arity loop accumulating in place with
   ``addcmul_``, the counterpart of its ``lax.scan`` (``:57-63``);
4. ``einsum_form``: ``einsum("ac,acb->cb")`` (``:66-68``), TF32 off;
5. the CSR sum over edges sorted by destination (``:71-78``), as
   ``index_add_`` (``csr_index_add``, the counterpart of
   ``segment_sum``) and as ``torch.sparse.mm`` of the ``[C, S]`` CSR
   matrix (``csr_matrix``, duplicates coalesced), the library yardstick
   the port already times;
6. ``unrolled_half``: bfloat16 storage, float32 accumulation (``:80-88``).

Beside them the level kernel (``ops.kernels.level_gather_reduce``) on one
``SumBucket`` (n_op 1, arity A, count C) packed by ``pack_level``: it reads
``src=w`` and writes a ``[C, B]`` output, storing float32 with float32
accumulation and bfloat16 with float32.  Each pair is held bit for bit to
``level_gather_reduce_plain`` on the same inputs, and each formulation to
the kernel of its storage type: float32 ones within F32_TOL of max|out|,
the bfloat16 one within BF16_TOL (one bfloat16 rounding of the kernel's
output).  A miss exits non-zero.

Each time is device ms by ``queued_ms`` (CUDA events behind a sleep kernel);
beside it G edge/s (``E * B / t``), GB/s of the optimal traffic (each
edge's row read once and each output row written once, the JAX script's
``OPT``: ``(E + C) * B * 4`` = 1.208 GB in float32, a bound of 0.3606 ms at
3.35 TB/s; the bfloat16 formulation's float32 output makes it ``(E + 2C)
* B * 2``), and the share of that bound.  That bound counts a row once for
each edge that reads it; the indices repeat rows (E random draws of S
rows), so beside it stands the bound of this run's data, each distinct
row read once (the repo's bound, chip_smoke's ``level_bounds``).  One JSON
line a measurement.

``python -m feynmandiagram_tpu_torch.benchmarks.probe_bucket_fusion`` runs it
on the card (about 2.7 GiB at peak, the baseline's gathered ``[A, C, B]``
operand and its product) and exits non-zero without one.  ``--device cpu
--shape S B A C`` runs it on the CPU at a small shape: the checks, and
the CPU's wall ms, which say nothing of a device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.kernels import level_gather_reduce, level_gather_reduce_plain, pack_level

S, B, A, C = 32768, 4096, 8, 8192
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_TOL = 1e-5              # float32 formulation vs the float32 kernel, of max|out|
# bfloat16 storage vs the bfloat16 kernel, of max|out|: the kernel's output
# rounded once to bfloat16 (half an ulp, 2^-8 of the value at most), and
# float32 sums in another order
BF16_TOL = 2.0 ** -8 + F32_TOL


def make_inputs(s: int = S, b: int = B, a: int = A, c: int = C, seed: int = 0):
    """The script's ``w [s, b]``, ``idx2 [a, c]`` and ``fac2 [a, c]``,
    drawn in its order, as numpy float32 / int32 arrays."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((s, b)).astype(np.float32)
    idx2 = rng.integers(0, s, size=(a, c)).astype(np.int32)
    fac2 = rng.standard_normal((a, c)).astype(np.float32)
    return w, idx2, fac2


def baseline(w: torch.Tensor, idx2: torch.Tensor, fac2: torch.Tensor) -> torch.Tensor:
    return (w[idx2] * fac2[:, :, None]).sum(0)


def unrolled(w: torch.Tensor, idx2: torch.Tensor, fac2: torch.Tensor) -> torch.Tensor:
    acc = w[idx2[0]] * fac2[0][:, None]
    for a in range(1, idx2.shape[0]):
        acc = acc + w[idx2[a]] * fac2[a][:, None]
    return acc


def scanned(w: torch.Tensor, idx2: torch.Tensor, fac2: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((idx2.shape[1], w.shape[1]), dtype=w.dtype, device=w.device)
    for a in range(idx2.shape[0]):
        acc.addcmul_(w[idx2[a]], fac2[a][:, None])
    return acc


def einsum_form(w: torch.Tensor, idx2: torch.Tensor, fac2: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ac,acb->cb", fac2, w[idx2])


def csr_edges(idx2: torch.Tensor, fac2: torch.Tensor):
    """The edges sorted by destination: ``(idx_flat, fac_flat, seg)``."""
    a, c = idx2.shape
    return (idx2.T.reshape(-1), fac2.T.reshape(-1),
            torch.arange(c, device=idx2.device).repeat_interleave(a))


def csr_index_add(w: torch.Tensor, idx_flat: torch.Tensor, fac_flat: torch.Tensor,
                  seg: torch.Tensor, count: int) -> torch.Tensor:
    contrib = w[idx_flat] * fac_flat[:, None]
    out = torch.zeros((count, w.shape[1]), dtype=w.dtype, device=w.device)
    return out.index_add_(0, seg, contrib)


def csr_matrix(idx2: torch.Tensor, fac2: torch.Tensor, s: int) -> torch.Tensor:
    """The bucket as a ``[C, s]`` CSR matrix, duplicate entries of a row
    summed, whose product with ``w`` is the bucket."""
    a, c = idx2.shape
    rows = torch.arange(c, device=idx2.device).repeat(a)
    with warnings.catch_warnings():     # the beta-state notes of sparse tensors
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, idx2.reshape(-1).long()]),
                                      fac2.reshape(-1), (c, s)).coalesce()
        return coo.to_sparse_csr()


def sparse_mm(csr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sparse.mm(csr, w)


def unrolled_half(w_half: torch.Tensor, idx2: torch.Tensor, fac2: torch.Tensor) -> torch.Tensor:
    """``unrolled`` on a narrower storage type, accumulating in ``fac2``'s."""
    acc = w_half[idx2[0]].to(fac2.dtype) * fac2[0][:, None]
    for a in range(1, idx2.shape[0]):
        acc = acc + w_half[idx2[a]].to(fac2.dtype) * fac2[a][:, None]
    return acc


def bucket_tables(idx2: np.ndarray, fac2: np.ndarray, device, fac_dtype: torch.dtype):
    """One ``SumBucket`` (n_op 1) writing rows ``0 .. C`` of its output."""
    return pack_level([(np.asarray(idx2)[None], np.asarray(fac2), 0)], device, fac_dtype)


def level_kernel(out: torch.Tensor, tables, src: torch.Tensor,
                 acc_dtype: Optional[torch.dtype] = None, kernel: bool = True) -> torch.Tensor:
    """The level launch (``kernel=False``: its plain version) of ``tables``
    on ``out``, reading ``src``; returns ``out``."""
    op = level_gather_reduce if kernel else level_gather_reduce_plain
    op(out, tables, src=src, acc_dtype=acc_dtype)
    return out


def _cpu_ms(fn: Callable[[], object], reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device, s: int = S, b: int = B, a: int = A, c: int = C) -> Dict[str, object]:
    """Check and time every formulation and the kernel at ``(s, b, a, c)``
    on ``device``.  Returns the JSON rows and whether every check held."""
    from . import card_name, queued_ms

    device = torch.device(device)
    cuda = device.type == "cuda"
    card = card_name() if cuda else "cpu"
    e = a * c
    w_np, idx_np, fac_np = make_inputs(s, b, a, c)
    distinct = len(np.unique(idx_np))
    w = torch.from_numpy(w_np).to(device)
    idx2 = torch.from_numpy(idx_np).to(device).long()
    fac2 = torch.from_numpy(fac_np).to(device)
    w_half = w.to(torch.bfloat16)
    idx_flat, fac_flat, seg = csr_edges(idx2, fac2)
    csr = csr_matrix(idx2, fac2, s)
    tables = bucket_tables(idx_np, fac_np, device, torch.float32)
    out32 = torch.empty((c, b), dtype=torch.float32, device=device)
    out16 = torch.empty((c, b), dtype=torch.bfloat16, device=device)
    cases = [  # (name, call, bytes a row of w, of the output, storage of the kernel it is held to)
        ("baseline (w[idx2]*fac).sum(0)", lambda: baseline(w, idx2, fac2), 4, 4, "f32"),
        ("unrolled per-arity gather-mul-add", lambda: unrolled(w, idx2, fac2), 4, 4, "f32"),
        ("scan per-arity, addcmul_ in place", lambda: scanned(w, idx2, fac2), 4, 4, "f32"),
        ("einsum ac,acb->cb", lambda: einsum_form(w, idx2, fac2), 4, 4, "f32"),
        ("CSR index_add_ (sorted by destination)",
         lambda: csr_index_add(w, idx_flat, fac_flat, seg, c), 4, 4, "f32"),
        ("CSR torch.sparse.mm", lambda: sparse_mm(csr, w), 4, 4, "f32"),
        ("unrolled bf16-storage f32-acc", lambda: unrolled_half(w_half, idx2, fac2), 2, 4, "bf16"),
        ("level kernel f32/f32", lambda: level_kernel(out32, tables, w), 4, 4, None),
        ("level kernel bf16/f32",
         lambda: level_kernel(out16, tables, w_half, torch.float32), 2, 2, None)]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = {"f32": level_kernel(out32, tables, w).clone(),
               "bf16": level_kernel(out16, tables, w_half, torch.float32).float()}
        plain = {"f32": level_kernel(torch.empty_like(out32), tables, w, kernel=False),
                 "bf16": level_kernel(torch.empty_like(out16), tables, w_half, torch.float32,
                                      kernel=False).float()}
        ok = True
        rows: List[dict] = []
        for pair in ("f32", "bf16"):
            same = torch.equal(ref[pair], plain[pair])
            ok &= same
            rows.append({"check": f"level kernel {pair}/f32 vs level_gather_reduce_plain",
                         "bit_for_bit": same, "device": card})
        for name, call, w_bytes, out_bytes, held_to in cases:
            row = {"name": name, "S": s, "B": b, "A": a, "C": c, "device": card}
            if held_to is not None:
                got = call().float()
                tol = F32_TOL if held_to == "f32" else BF16_TOL
                err = ((got - ref[held_to]).abs().max() / ref[held_to].abs().max()).item()
                ok &= err <= tol
                row.update({"max_rel_err_vs_kernel": err, "tol": tol,
                            "held_to": f"level kernel {held_to}/f32"})
                del got
            if cuda:
                ms = queued_ms(call)
                opt = (e * w_bytes + c * out_bytes) * b
                bound = opt / HBM_BYTES_PER_S * 1e3
                bound_distinct = (distinct * w_bytes + c * out_bytes) * b / HBM_BYTES_PER_S * 1e3
                row.update({"device_ms": ms, "G_edge_per_s": e * b / ms / 1e6,
                            "optimal_GB": opt / 1e9, "GB_per_s_of_optimal": opt / ms / 1e6,
                            "bound_ms": bound, "share_of_bound": bound / ms,
                            "distinct_rows": distinct, "bound_distinct_ms": bound_distinct,
                            "share_of_distinct_bound": bound_distinct / ms})
            else:
                row["cpu_ms"] = _cpu_ms(call)
            rows.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return {"rows": rows, "ok": ok}


def main(argv=None) -> int:
    from ..ops.dtypes import default_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    parser.add_argument("--shape", type=int, nargs=4, default=(S, B, A, C),
                        metavar=("S", "B", "A", "C"))
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    result = run(device, *args.shape)
    for row in result["rows"]:
        print(json.dumps(row), flush=True)
    print(f"probe_bucket_fusion: every check held: {result['ok']}", flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
