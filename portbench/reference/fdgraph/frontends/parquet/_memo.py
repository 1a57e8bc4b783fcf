"""Build-scoped memoization of parquet subproblems.

The parquet recursion (vertex4 ⇄ bubble ⇄ green ⇄ sigma, common.jl /
vertex4.jl / green.jl / sigma.jl in the reference) re-solves identical
subproblems massively: at order 4, 96.5% of all ``green`` calls repeat a
(para, extK, extT) combination already built.  The reference pays this cost
on every build; here each top-level front-end entry point opens a memo
scope and the recursion returns the *shared DAG node* for a repeated
subproblem instead of rebuilding it.  Sharing nodes is exactly the DAG
semantics the optimizer and lowering already handle (subgraph lists are
never mutated by the generators; update_extKT copies before rewriting).

The scope is a ``contextvars.ContextVar`` — no module-level mutable state
survives a build, and concurrent builds in different threads cannot see
each other's cache.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Dict, Optional

_active: contextvars.ContextVar[Optional[Dict]] = contextvars.ContextVar(
    "parquet_build_memo", default=None)


def active() -> Optional[Dict]:
    """The memo dict of the innermost active build scope, or None."""
    return _active.get()


def scoped(fn):
    """Make ``fn`` a memo-scope entry point: opens a fresh build cache when
    none is active, reuses the enclosing one otherwise (recursive calls)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _active.get() is not None:
            return fn(*args, **kwargs)
        token = _active.set({})
        try:
            return fn(*args, **kwargs)
        finally:
            _active.reset(token)

    return wrapper
