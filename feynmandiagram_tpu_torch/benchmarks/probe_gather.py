"""Row-gather throughput on one GPU: the port of ``benchmarks/probe_gather.py``.

The graph phase's hot operation is ``out[c, :] = sum_a fac[a, c] *
w[idx[a, c], :]`` with ``w`` a ``[S, B]`` buffer in device memory and
arbitrary int32 row indices.  This measures what the card reaches with
several ways of gathering rows, at the JAX script's shapes: S = 32768
slots, B = 4096 lanes, E = 65536 gathered rows, float32, data from numpy's
``default_rng(0)`` in the script's order (``w`` is 512 MiB, the output of
one gather 1 GiB).  The strategies, with the script's lines:

- ``w*2``, the streaming roofline (``:56-58``);
- ``w[idx]`` (``:34-35``);
- ``torch.index_select`` in place of ``jnp.take`` (``:38-39``);
- ``index_select`` on sorted indices (``:46-47``);
- gather * fac + 8-way reduce (``:50-53``), once in plain PyTorch and once
  through the port's own level kernel on one bucket of n_op 1, arity 8
  and count E/8, packed once before the timed calls (``bucket_level``),
  which puts the main path's kernel against the roofline measured in the
  same run;
- the one-hot product of a C = 1024 x W = 2048 selector with a window of
  ``w`` (``:68-86``), as ``torch.matmul`` in TF32 (``allow_tf32`` is set
  for that product only).  It is a plain product outside any kernel, which
  the JAX script too left to its compiler.

The JAX script's ``promise_in_bounds`` gathers (``:41-47``) have no PyTorch
counterpart: PyTorch's gathers keep their own bounds handling.

GB/s is the script's ``E * B * 4 / time`` (``:29``), the bytes a gather
reads; for ``w*2`` it equals the read plus write traffic, since E = 2 S.
Each time is ``median_ms``'s: the median of CUDA-event times over 20
calls after warm-up.

``python -m feynmandiagram_tpu_torch.benchmarks.probe_gather`` runs it on
the card and exits non-zero without one.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from . import card_name, median_ms
from ..ops.kernels import LevelTables, level_gather_reduce, pack_level

S, B, E = 32768, 4096, 65536
W, C = 2048, 1024     # one-hot window rows, selected rows
ARITY = 8
RTOL = 1e-5           # kernel vs plain 8-way reduce, of the terms' size (f32)


def make_inputs(device, s: int = S, b: int = B, e: int = E, window: int = W,
                count: int = C) -> Dict[str, torch.Tensor]:
    """The script's data, drawn in its order.  ``w`` is the first ``s`` rows
    of ``w_ext``, whose ``e / ARITY`` rows after them take the kernel's
    output; ``onehot`` has one 1 per row."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((s, b)).astype(np.float32)
    idx = rng.integers(0, s, size=e).astype(np.int32)
    fac = rng.standard_normal(e).astype(np.float32)
    sel = np.zeros((count, window), np.float32)
    sel[np.arange(count), rng.integers(0, window, count)] = 1.0
    w_ext = torch.zeros((s + e // ARITY, b), dtype=torch.float32, device=device)
    w_ext[:s] = torch.from_numpy(w)
    idx_t = torch.from_numpy(idx).to(device)
    return {"w_ext": w_ext, "w": w_ext[:s], "idx": idx_t,
            "idx_sorted": torch.sort(idx_t).values, "fac": torch.from_numpy(fac).to(device),
            "onehot": torch.from_numpy(sel).to(device)}


def stream(w: torch.Tensor) -> torch.Tensor:
    return w * 2.0


def gather(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return w[idx]


def take(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(w, 0, idx)


def gather_scale_sum(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor) -> torch.Tensor:
    """Bucket shape: arity 8 x count E/8, term a of output c at a * E/8 + c."""
    g = w[idx] * fac[:, None]
    return g.reshape(ARITY, -1, w.shape[1]).sum(dim=0)


def bucket_level(idx: torch.Tensor, fac: torch.Tensor, s: int) -> LevelTables:
    """The bucket of ``gather_scale_sum`` writing rows ``s ..``, packed as a
    level of one bucket on ``fac``'s device."""
    return pack_level([(idx.view(1, ARITY, -1).cpu(), fac.view(ARITY, -1).cpu(), s)],
                      fac.device, fac.dtype)


def gather_scale_sum_kernel(w_ext: torch.Tensor, s: int, tables: LevelTables) -> torch.Tensor:
    """The same through the level kernel on ``bucket_level``'s tables,
    written into rows ``s ..`` of ``w_ext``; returns those rows."""
    level_gather_reduce(w_ext, tables)
    return w_ext[s:]


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def onehot(sel: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``sel @ win`` in TF32."""
    with _tf32():
        return torch.matmul(sel, win)


def run() -> dict:
    """Time every strategy on the card at the script's shapes and check the
    bucket kernel against the plain 8-way reduce.  Returns the card, the
    ``(label, ms, GB/s)`` rows, and the check's max|diff| and verdict."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_gather needs a CUDA card")
    card = card_name()
    x = make_inputs("cuda")
    w, idx, fac = x["w"], x["idx"], x["fac"]
    gb = E * B * 4 / 1e9
    rows = []

    def bench(label, fn):
        ms = median_ms(fn)
        rows.append((label, ms, gb / (ms / 1e3)))
        print(f"{label:44s} {ms:8.4f} ms  {rows[-1][2]:8.1f} GB/s  [{card}]", flush=True)

    bench("w*2 (streaming roofline, S rows)", lambda: stream(w))
    bench("w[idx]", lambda: gather(w, idx))
    bench("torch.index_select", lambda: take(w, idx))
    bench("index_select, sorted idx", lambda: take(w, x["idx_sorted"]))
    bench("gather*fac + 8-way reduce (plain)", lambda: gather_scale_sum(w, idx, fac))
    tables = bucket_level(idx, fac, S)
    bench("gather*fac + 8-way reduce (bucket kernel)",
          lambda: gather_scale_sum_kernel(x["w_ext"], S, tables))
    print(f"bucket kernel at B={B}: {rows[-1][2] / rows[0][2]:.3f} of the streaming "
          f"roofline measured here  [{card}]", flush=True)

    got = gather_scale_sum_kernel(x["w_ext"], S, tables)
    ref = gather_scale_sum(w, idx, fac)
    size = gather_scale_sum(w.abs(), idx, fac.abs())
    diff = (got - ref).abs()
    err, ok = diff.max().item(), bool((diff <= RTOL * size).all())
    print(f"bucket kernel vs plain 8-way reduce: max|diff| {err:.3e} "
          f"({'within' if ok else 'OUTSIDE'} {RTOL:g} of the terms' size)", flush=True)
    del got, ref, size, diff

    win = w[:W]
    ms = median_ms(lambda: onehot(x["onehot"], win))
    print(f"{'one-hot matmul TF32 (C=1024,W=2048)':44s} {ms:8.4f} ms  "
          f"{C * B * 4 / 1e9 / (ms / 1e3):8.1f} GB/s-eq  "
          f"({2 * C * W * B / (ms / 1e3) / 1e12:.1f} TF/s)  [{card}]", flush=True)
    rows.append(("one-hot matmul TF32 (C=1024,W=2048)", ms, C * B * 4 / 1e9 / (ms / 1e3)))
    return {"card": card, "rows": rows, "bucket_max_abs_err": err, "bucket_ok": ok}


if __name__ == "__main__":
    raise SystemExit(0 if run()["bucket_ok"] else 1)
